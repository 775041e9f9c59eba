// Blocked-ELL semiring SpMV kernels for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas TPU kernels of the reference package
// (src/repro/kernels/spmv/spmv.py):
//   * ell_spmv_fused  <- ell_spmv_fused_pallas / _ell_spmv_fused_kernel, K = 1:
//       out[r] = REDUCE_w COMBINE(deq(vals[r, w]), x[cols[r, w]])
//   * ell_fold        <- ell_fold_pallas / _ell_fold_kernel:
//       out[r] = REDUCE_w COMBINE(deq(vals[r, w]), xg[r, w])
// Slots with cols < 0 contribute the semiring identity.  deq(q) is
// (float(q) - zero) * scale for int8/float16 values and the value itself for
// float32 values.
//
// The Pallas kernels accumulate across a sequential W grid axis into a
// revisited output block, which is only safe because a TPU runs its grid in
// order.  Here one warp owns one ELL row and loops over W itself, so every
// output row has exactly one writer and nothing accumulates across blocks.
//
// Bound: both kernels do a handful of flops per slot and are bound by bytes.
// ell_spmv_fused reads R*W*(4 + sizeof(V)) bytes of cols/vals, gathers the
// frontier x (4 bytes per distinct source, which the 50 MB L2 holds for
// frontiers up to ~12M vertices) and writes 4*R bytes.  ell_fold reads a
// pre-gathered xg as well (R*W*4 more).  The design reads cols/vals/xg with
// one 16-byte (or 8/4-byte for half/int8 values) vector load per lane per
// 128 slots, neighbouring lanes on neighbouring addresses; ELL rows are
// 128-slot multiples (LANE padding of the stored format), so every row
// starts 16-byte aligned and no tail handling is needed.
//
// Rounding: dequantize and combine use __fsub_rn/__fmul_rn/__fadd_rn so
// nvcc cannot contract (q - zero) * scale + s into an FMA.  The plain torch
// version runs op by op, so min/max semirings match it bitwise.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// semiring ids: order of repro_torch.core.semiring.SEMIRINGS
enum Sem { PLUS_TIMES = 0, PLUS_SRC = 1, MIN_PLUS = 2, MIN_SRC = 3, MAX_SRC = 4 };
// value dtype ids (cuda.py _DTYPE_IDS)
enum Dt { F32 = 0, F16 = 1, I8 = 2 };

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <int SEM> __device__ __forceinline__ float identity() {
  if (SEM == PLUS_TIMES || SEM == PLUS_SRC) return 0.0f;
  if (SEM == MAX_SRC) return -CUDART_INF_F;
  return CUDART_INF_F;
}

template <int SEM> __device__ __forceinline__ float reduce(float a, float b) {
  if (SEM == PLUS_TIMES || SEM == PLUS_SRC) return __fadd_rn(a, b);
  if (SEM == MAX_SRC) return fmaxf(a, b);
  return fminf(a, b);
}

template <int SEM> __device__ __forceinline__ float combine(float w, float s) {
  if (SEM == PLUS_TIMES) return __fmul_rn(w, s);
  if (SEM == MIN_PLUS) return __fadd_rn(w, s);
  return s;  // *_SRC: take the source
}

// Four consecutive edge values, dequantized to float.
template <typename V> struct Vals4;

template <> struct Vals4<float> {
  __device__ __forceinline__ static void load(const float* p, float scale,
                                              float zero, float v[4]) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

__device__ __forceinline__ float deq(float q, float scale, float zero) {
  return __fmul_rn(__fsub_rn(q, zero), scale);
}

template <> struct Vals4<__half> {
  __device__ __forceinline__ static void load(const __half* p, float scale,
                                              float zero, float v[4]) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __half* h = reinterpret_cast<const __half*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = deq(__half2float(h[i]), scale, zero);
  }
};

template <> struct Vals4<int8_t> {
  __device__ __forceinline__ static void load(const int8_t* p, float scale,
                                              float zero, float v[4]) {
    char4 q = *reinterpret_cast<const char4*>(p);
    v[0] = deq(static_cast<float>(q.x), scale, zero);
    v[1] = deq(static_cast<float>(q.y), scale, zero);
    v[2] = deq(static_cast<float>(q.z), scale, zero);
    v[3] = deq(static_cast<float>(q.w), scale, zero);
  }
};

template <int SEM> __device__ __forceinline__ float warp_reduce(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = reduce<SEM>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  return acc;
}

template <int SEM> __device__ __forceinline__ float step(float acc, int c,
                                                         float w, float s) {
  return c >= 0 ? reduce<SEM>(acc, combine<SEM>(w, s)) : acc;
}

// GATHER = true: sources are x[cols] (ell_spmv_fused); false: sources are the
// pre-gathered xg[r, w] (ell_fold).
template <int SEM, typename V, bool GATHER>
__global__ void __launch_bounds__(kThreads)
ell_row_kernel(const float* __restrict__ src, const int* __restrict__ cols,
               const V* __restrict__ vals, float* __restrict__ out, int rows,
               int width, float scale, float zero) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform: whole warps leave together
  const int64_t base = static_cast<int64_t>(row) * width;
  float acc = identity<SEM>();
  for (int w = lane * 4; w < width; w += 128) {
    const int4 c = *reinterpret_cast<const int4*>(cols + base + w);
    float v[4];
    Vals4<V>::load(vals + base + w, scale, zero, v);
    float s[4];
    if constexpr (GATHER) {
      s[0] = c.x >= 0 ? __ldg(src + c.x) : 0.0f;
      s[1] = c.y >= 0 ? __ldg(src + c.y) : 0.0f;
      s[2] = c.z >= 0 ? __ldg(src + c.z) : 0.0f;
      s[3] = c.w >= 0 ? __ldg(src + c.w) : 0.0f;
    } else {
      const float4 g = *reinterpret_cast<const float4*>(src + base + w);
      s[0] = g.x; s[1] = g.y; s[2] = g.z; s[3] = g.w;
    }
    acc = step<SEM>(acc, c.x, v[0], s[0]);
    acc = step<SEM>(acc, c.y, v[1], s[1]);
    acc = step<SEM>(acc, c.z, v[2], s[2]);
    acc = step<SEM>(acc, c.w, v[3], s[3]);
  }
  acc = warp_reduce<SEM>(acc);
  if (lane == 0) out[row] = acc;
}

template <int SEM, typename V, bool GATHER>
int launch_typed(const float* src, const int* cols, const void* vals,
                 float* out, int rows, int width, float scale, float zero,
                 cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0)
    ell_row_kernel<SEM, V, GATHER><<<blocks, kThreads, 0, stream>>>(
        src, cols, static_cast<const V*>(vals), out, rows, width, scale, zero);
  return static_cast<int>(cudaGetLastError());
}

template <int SEM, bool GATHER>
int launch_dtype(int dtype, const float* src, const int* cols,
                 const void* vals, float* out, int rows, int width,
                 float scale, float zero, cudaStream_t stream) {
  switch (dtype) {
    case F32: return launch_typed<SEM, float, GATHER>(src, cols, vals, out, rows, width, scale, zero, stream);
    case F16: return launch_typed<SEM, __half, GATHER>(src, cols, vals, out, rows, width, scale, zero, stream);
    case I8: return launch_typed<SEM, int8_t, GATHER>(src, cols, vals, out, rows, width, scale, zero, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool GATHER>
int launch(int semiring, int dtype, const float* src, const int* cols,
           const void* vals, float* out, int rows, int width, float scale,
           float zero, cudaStream_t stream) {
  if (width % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (semiring) {
    case PLUS_TIMES: return launch_dtype<PLUS_TIMES, GATHER>(dtype, src, cols, vals, out, rows, width, scale, zero, stream);
    case PLUS_SRC: return launch_dtype<PLUS_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, scale, zero, stream);
    case MIN_PLUS: return launch_dtype<MIN_PLUS, GATHER>(dtype, src, cols, vals, out, rows, width, scale, zero, stream);
    case MIN_SRC: return launch_dtype<MIN_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, scale, zero, stream);
    case MAX_SRC: return launch_dtype<MAX_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, scale, zero, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (0 = cudaSuccess); it never synchronises and allocates nothing.
extern "C" int ell_spmv_fused(const float* x, const int* cols,
                              const void* vals, float* out, int rows,
                              int width, int semiring, int dtype, float scale,
                              float zero, cudaStream_t stream) {
  return launch<true>(semiring, dtype, x, cols, vals, out, rows, width, scale,
                      zero, stream);
}

extern "C" int ell_fold(const float* xg, const int* cols, const void* vals,
                        float* out, int rows, int width, int semiring,
                        int dtype, float scale, float zero,
                        cudaStream_t stream) {
  return launch<false>(semiring, dtype, xg, cols, vals, out, rows, width,
                       scale, zero, stream);
}
