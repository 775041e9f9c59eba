// Blocked-ELL semiring SpMV kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the four Pallas TPU kernels of the reference package
// (src/repro/kernels/spmv/spmv.py):
//   * ell_spmv_fused, k = 1 <- ell_spmv_fused_pallas / _ell_spmv_fused_kernel:
//       out[r] = REDUCE_w COMBINE(deq(vals[r, w]), x[cols[r, w]])
//   * ell_fold, k = 1       <- ell_fold_pallas / _ell_fold_kernel:
//       out[r] = REDUCE_w COMBINE(deq(vals[r, w]), xg[r, w])
//   * ell_spmv_fused, k > 1 <- ell_spmv_fused_pallas with an [n, K] frontier:
//       out[r, k] = REDUCE_w COMBINE(deq(vals[r, w]), x[cols[r, w], k])
//   * ell_fold, k > 1       <- ell_fold_batch_pallas / _ell_fold_batch_kernel:
//       out[r, k] = REDUCE_w COMBINE(deq(vals[r, w]), xg[r, w, k])
//   * ell_gather_fold       <- ell_gather_fold_pallas / _ell_gather_fold_kernel:
//       out[r] = REDUCE_w COMBINE(deq(vals[r, w]), x_blk[cols[r, w]])
//     with cols local to one source block x_blk (a 2-D tile of spmv_2d)
// Slots with cols < 0 contribute the semiring identity.  deq(q) is
// (float(q) - zero) * scale for int8/float16 values and the value itself for
// float32 values.
//
// The Pallas kernels accumulate across a sequential W grid axis into a
// revisited output block, which is only safe because a TPU runs its grid in
// order.  Here one warp (or, in ell_gather_fold, one group of lanes) owns an
// ELL row and loops over W itself, so every output row has exactly one
// writer and nothing accumulates across blocks.
//
// Bound: every kernel does a handful of flops per slot and is bound by bytes.
// ell_spmv_fused reads R*W*(4 + sizeof(V)) bytes of cols/vals, gathers the
// frontier x (4 bytes per distinct source, which the 50 MB L2 holds for
// frontiers up to ~12M vertices) and writes 4*R bytes.  ell_fold reads a
// pre-gathered xg as well (R*W*4 more).  The single-column kernels read
// cols/vals/xg with one 16-byte (or 8/4-byte for half/int8 values) vector
// load per lane per 128 slots, neighbouring lanes on neighbouring addresses;
// ELL rows are 128-slot multiples (LANE padding of the stored format), so
// every row starts 16-byte aligned and no tail handling is needed.
//
// The batched kernels read each edge slot once for all K columns (the point
// of a batch) and the K source floats of a valid slot from one contiguous
// row, so their bytes are cols/vals once plus K floats per valid slot.  The
// stored rows are mostly padding (about 10% of the slots are edges) and the
// [n, K] frontier outgrows L2, so they are bound by the latency of the
// source loads unless many are in flight: a warp loads the cols of its rows
// (one wide row, or up to four of 128 slots) at once, compacts each row's
// valid slots into a list in shared memory, and folds the lists with several
// float4 source loads a lane in flight.
//
// ell_gather_fold's tiles are 96% padding and every row's valid slots form a
// prefix (csr_to_ell fills slot w only while w < the row's degree), so it
// takes each row's extent, ext[r] = 1 + the last valid slot, and reads cols
// and vals below it only: the bytes fall from every slot's column to the
// edges' (rounded up to 32-byte sectors).  Rows are then ~5 slots long, so a
// group of 4 lanes, not a warp, takes a row: more rows, and their gathers
// from the source block (which L2 holds: n / S floats, 8.4 MB at RMAT scale
// 22 with S = 2), are in flight at once.  An L2 persisting window over the
// block gained 0.3% (tools/tune_b4.py) and is not used.
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
// batched kernels: slots of cols a warp loads at once (4 int4 a lane, one
// row or several) and compacts into its lists, and source loads a lane
// issues before it folds them
constexpr int kListSlots = 512;
constexpr int kUnroll = 4;
// ell_gather_fold: lanes that share one ELL row, with the rows' extents and
// without them (tools/tune_b4.py, one pass over the 4 tiles of RMAT scale 22
// on an H100 at 700 W, plus_src: with extents 0.593 / 0.731 / 1.843 ms at
// 4 / 8 / 32 lanes, walking all 128 slots 3.008 / 2.264 / 2.514 ms)
constexpr int kExtentLanes = 4;
constexpr int kFullWidthLanes = 8;

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

// the *_SRC semirings never read the edge values
template <int SEM> constexpr bool kReadsVals = SEM == PLUS_TIMES || SEM == MIN_PLUS;

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

// One warp folds ELL row `row` into out[row].  GATHER = true: sources are
// src[cols] (ell_spmv_fused); false: sources are the pre-gathered xg[r, w]
// (ell_fold).
template <int SEM, typename V, bool GATHER>
__device__ __forceinline__ void fold_row(const float* __restrict__ src,
                                         const int* __restrict__ cols,
                                         const V* __restrict__ vals,
                                         float* __restrict__ out, int row,
                                         int width, float scale, float zero) {
  const int lane = threadIdx.x & 31;
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
__global__ void __launch_bounds__(kThreads)
ell_row_kernel(const float* __restrict__ src, const int* __restrict__ cols,
               const V* __restrict__ vals, float* __restrict__ out, int rows,
               int width, float scale, float zero) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: whole warps leave together
  fold_row<SEM, V, GATHER>(src, cols, vals, out, row, width, scale, zero);
}

// VEC (1 or 4) consecutive source floats; VEC = 4 wants p 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void load_src(const float* p, float s[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
  } else {
    s[0] = __ldg(p);
  }
}

// Batched rows, K > 1 columns:
//   out[r, k] = REDUCE_w COMBINE(deq(vals[r, w]), S(r, w, k))
// with S = x[cols[r, w] * K + k] (GATHER, x is [n, K] row-major) or the
// pre-gathered xg[(r * W + w) * K + k].  A row belongs to row_lanes lanes
// (8 at W = 128, 16 at W = 256 or 384, else 32), so a warp holds 32 /
// row_lanes rows; each lane takes 4 int4 of cols of its row per pass
// (chunk = 16 * row_lanes slots), and a warp's rows go through three steps
// together, their loads in flight at once:
//   1. every lane loads its 4 int4 of cols (and their edge values);
//   2. the row's valid slots are compacted into the row's list in shared
//      memory (__ballot_sync, masked to the row's lanes, gives each a
//      position): the source id (GATHER) or the slot (xg), and the
//      dequantized edge value for the semirings that read one;
//   3. the list is folded: a slot's K floats are read as K / VEC units of
//      VEC floats (VEC = 4, float4, when K % 4 == 0 and the source is
//      16-byte aligned; else VEC = 1), P = min(next_pow2(K / VEC),
//      row_lanes) lanes a slot, so the row folds row_lanes / P list entries
//      a step, and each lane issues kUnroll steps' loads before it folds
//      them.  Units past P loop in column chunks.
// The row's slot groups are then folded with __shfl_xor_sync over the lane
// bits above the unit, and its group 0 writes its units (float4 with
// VEC = 4): every output element has exactly one writer.  Padding slots
// cost their share of one coalesced load and nothing else.
template <int SEM, typename V, bool GATHER, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_row_batch_kernel(const float* __restrict__ src,
                     const int* __restrict__ cols, const V* __restrict__ vals,
                     float* __restrict__ out, int rows, int width, int k,
                     int row_lanes, int lanes_per_slot, float scale,
                     float zero) {
  extern __shared__ int lists[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / row_lanes;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock
                         + warp) * rows_per_warp;
  if (first >= rows) return;  // warp-uniform: whole warps leave together
  const int sub = lane / row_lanes;  // this lane's row in the warp
  const int i = lane % row_lanes;    // and its lane in the row
  const int64_t row = first + sub;
  const bool real = row < rows;      // rows past the end fold nothing
  const int chunk = 16 * row_lanes;  // slots of a row a pass covers
  // the row's list: chunk ids, then chunk edge values if the semiring
  // reads them
  int* ids = lists + (warp * rows_per_warp + sub) * chunk
                     * (kReadsVals<SEM> ? 2 : 1);
  float* wts = reinterpret_cast<float*>(ids + chunk);
  const unsigned mine = row_lanes == 32
      ? 0xffffffffu : ((1u << row_lanes) - 1u) << (sub * row_lanes);
  const unsigned lower = (1u << lane) - 1u;  // lanes below this one
  const int units = k / VEC;
  const int groups = row_lanes / lanes_per_slot;
  const int g = i / lanes_per_slot;
  const int64_t base = row * width;
  for (int u0 = 0; u0 < units; u0 += lanes_per_slot) {
    const int unit = u0 + i % lanes_per_slot;
    const bool live = unit < units;
    const int col = unit * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = identity<SEM>();
    for (int w0 = 0; w0 < width; w0 += chunk) {
      // blocks of 4 * row_lanes slots in this pass: warp-uniform
      const int blocks = min(chunk, width - w0) / (4 * row_lanes);
      int4 c[4];
      float v[4][4] = {};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        c[b] = make_int4(-1, -1, -1, -1);
        if (b < blocks && real) {
          const int64_t at = base + w0 + (b * row_lanes + i) * 4;
          c[b] = *reinterpret_cast<const int4*>(cols + at);
          if constexpr (kReadsVals<SEM>)
            Vals4<V>::load(vals + at, scale, zero, v[b]);
        }
      }
      int n = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= blocks) break;
        const int cb[4] = {c[b].x, c[b].y, c[b].z, c[b].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = cb[e] >= 0;
          const unsigned ballot = __ballot_sync(0xffffffffu, valid) & mine;
          if (valid) {
            const int at = n + __popc(ballot & lower);
            ids[at] = GATHER ? cb[e] : w0 + (b * row_lanes + i) * 4 + e;
            if constexpr (kReadsVals<SEM>) wts[at] = v[b][e];
          }
          n += __popc(ballot);
        }
      }
      __syncwarp();
      for (int t0 = g; t0 < n; t0 += groups * kUnroll) {
        float s[kUnroll][VEC];
        float wv[kUnroll] = {};
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = t0 + u * groups;
          if (t < n && live) {
            const int64_t id = ids[t];
            load_src<VEC>(src + (GATHER ? id : base + id) * k + col, s[u]);
            if constexpr (kReadsVals<SEM>) wv[u] = wts[t];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u * groups < n && live) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[e] = reduce<SEM>(acc[e], combine<SEM>(wv[u], s[u][e]));
          }
        }
      }
      __syncwarp();  // the next pass rewrites the lists
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      for (int off = row_lanes / 2; off >= lanes_per_slot; off >>= 1)
        acc[e] = reduce<SEM>(acc[e], __shfl_xor_sync(0xffffffffu, acc[e], off));
    if (g == 0 && live && real) {
      float* o = out + row * k + col;
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      else
        o[0] = acc[0];
    }
  }
}

// 2-D tiles: out[r] = REDUCE_w COMBINE(deq(vals[r, w]), x_blk[cols[r, w]])
// with cols local to the source block x_blk, over the slots w < ext[r]
// (ext = extents[r], clamped to W; W for every row without extents).
// L lanes share a row: lane j takes the 4-slot quads j, j + L, j + 2L, ...
// below ext, two quads a step, so both int4 loads of cols and their eight
// gathers from x_blk (through L2) are in flight together; the group folds
// with __shfl_xor_sync and its lane 0 writes.
template <int L, int SEM, typename V>
__global__ void __launch_bounds__(kThreads)
ell_gather_fold_kernel(const float* __restrict__ x_blk,
                       const int* __restrict__ cols,
                       const V* __restrict__ vals,
                       const int* __restrict__ extents,
                       float* __restrict__ out, int rows, int width,
                       float scale, float zero) {
  const int j = threadIdx.x % L;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / L;
  int ext = 0;  // rows past the end fold nothing but join the shuffles
  if (row < rows) ext = extents == nullptr ? width : min(__ldg(extents + row), width);
  const int64_t base = row * width;
  float acc = identity<SEM>();
  for (int w = 4 * j; w < ext; w += 8 * L) {
    const int w2 = w + 4 * L;
    const int4 c1 = *reinterpret_cast<const int4*>(cols + base + w);
    int4 c2 = make_int4(-1, -1, -1, -1);
    if (w2 < ext) c2 = *reinterpret_cast<const int4*>(cols + base + w2);
    float v[8] = {};
    if constexpr (kReadsVals<SEM>) {
      Vals4<V>::load(vals + base + w, scale, zero, v);
      if (w2 < ext) Vals4<V>::load(vals + base + w2, scale, zero, v + 4);
    }
    const int c[8] = {c1.x, c1.y, c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
    bool valid[8];
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      valid[i] = c[i] >= 0 && (i < 4 ? w : w2) + (i & 3) < ext;
      s[i] = valid[i] ? __ldg(x_blk + c[i]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (valid[i]) acc = reduce<SEM>(acc, combine<SEM>(v[i], s[i]));
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc = reduce<SEM>(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (j == 0 && row < rows) out[row] = acc;
}

template <int L, int SEM>
int gather_fold_lanes(int dtype, const float* x_blk, const int* cols,
                      const void* vals, const int* extents, float* out,
                      int rows, int width, float scale, float zero,
                      cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(rows) * L;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  switch (dtype) {
    case F32: ell_gather_fold_kernel<L, SEM, float><<<blocks, kThreads, 0, stream>>>(x_blk, cols, static_cast<const float*>(vals), extents, out, rows, width, scale, zero); break;
    case F16: ell_gather_fold_kernel<L, SEM, __half><<<blocks, kThreads, 0, stream>>>(x_blk, cols, static_cast<const __half*>(vals), extents, out, rows, width, scale, zero); break;
    case I8: ell_gather_fold_kernel<L, SEM, int8_t><<<blocks, kThreads, 0, stream>>>(x_blk, cols, static_cast<const int8_t*>(vals), extents, out, rows, width, scale, zero); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int SEM>
int gather_fold_dtype(int dtype, const float* x_blk, const int* cols,
                      const void* vals, const int* extents, float* out,
                      int rows, int width, float scale, float zero,
                      cudaStream_t stream) {
  if (extents != nullptr)
    return gather_fold_lanes<kExtentLanes, SEM>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
  return gather_fold_lanes<kFullWidthLanes, SEM>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
}

template <int SEM, typename V, bool GATHER, int VEC>
void launch_batch(const float* src, const int* cols, const V* v, float* out,
                  int rows, int width, int k, float scale, float zero,
                  cudaStream_t stream) {
  // lanes a row: each takes 4 int4 of cols a pass, and a pass covers up to
  // kListSlots slots
  int row_lanes = 32;
  while (row_lanes > 8 && 16 * row_lanes > width) row_lanes >>= 1;
  int lanes_per_slot = 1;
  while (lanes_per_slot < k / VEC && lanes_per_slot < row_lanes)
    lanes_per_slot <<= 1;
  const int rows_per_block = kWarpsPerBlock * 32 / row_lanes;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t list_bytes = static_cast<size_t>(kWarpsPerBlock) * kListSlots
                            * (kReadsVals<SEM> ? 8 : 4);
  ell_row_batch_kernel<SEM, V, GATHER, VEC><<<blocks, kThreads, list_bytes, stream>>>(
      src, cols, v, out, rows, width, k, row_lanes, lanes_per_slot, scale,
      zero);
}

// k == 1: the single-column kernel; k > 1: the batched one, with float4
// source loads when every source row starts 16-byte aligned.
template <int SEM, typename V, bool GATHER>
int launch_typed(const float* src, const int* cols, const void* vals,
                 float* out, int rows, int width, int k, float scale,
                 float zero, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const V* v = static_cast<const V*>(vals);
  if (k == 1) {
    ell_row_kernel<SEM, V, GATHER><<<blocks, kThreads, 0, stream>>>(
        src, cols, v, out, rows, width, scale, zero);
  } else if (k % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    launch_batch<SEM, V, GATHER, 4>(src, cols, v, out, rows, width, k, scale,
                                    zero, stream);
  } else {
    launch_batch<SEM, V, GATHER, 1>(src, cols, v, out, rows, width, k, scale,
                                    zero, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int SEM, bool GATHER>
int launch_dtype(int dtype, const float* src, const int* cols,
                 const void* vals, float* out, int rows, int width, int k,
                 float scale, float zero, cudaStream_t stream) {
  switch (dtype) {
    case F32: return launch_typed<SEM, float, GATHER>(src, cols, vals, out, rows, width, k, scale, zero, stream);
    case F16: return launch_typed<SEM, __half, GATHER>(src, cols, vals, out, rows, width, k, scale, zero, stream);
    case I8: return launch_typed<SEM, int8_t, GATHER>(src, cols, vals, out, rows, width, k, scale, zero, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool GATHER>
int launch(int semiring, int dtype, const float* src, const int* cols,
           const void* vals, float* out, int rows, int width, int k,
           float scale, float zero, cudaStream_t stream) {
  if (width % 128 != 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (semiring) {
    case PLUS_TIMES: return launch_dtype<PLUS_TIMES, GATHER>(dtype, src, cols, vals, out, rows, width, k, scale, zero, stream);
    case PLUS_SRC: return launch_dtype<PLUS_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, k, scale, zero, stream);
    case MIN_PLUS: return launch_dtype<MIN_PLUS, GATHER>(dtype, src, cols, vals, out, rows, width, k, scale, zero, stream);
    case MIN_SRC: return launch_dtype<MIN_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, k, scale, zero, stream);
    case MAX_SRC: return launch_dtype<MAX_SRC, GATHER>(dtype, src, cols, vals, out, rows, width, k, scale, zero, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (0 = cudaSuccess); it never synchronises and allocates nothing.
// `k` is the number of frontier columns: x is [n, k] / xg is [R, W, k] and
// out is [R, k], all row-major.  For k > 1, x / xg need only be 4-byte
// aligned (an unaligned view takes the scalar loads).
extern "C" int ell_spmv_fused(const float* x, const int* cols,
                              const void* vals, float* out, int rows,
                              int width, int k, int semiring, int dtype,
                              float scale, float zero, cudaStream_t stream) {
  return launch<true>(semiring, dtype, x, cols, vals, out, rows, width, k,
                      scale, zero, stream);
}

extern "C" int ell_fold(const float* xg, const int* cols, const void* vals,
                        float* out, int rows, int width, int k, int semiring,
                        int dtype, float scale, float zero,
                        cudaStream_t stream) {
  return launch<false>(semiring, dtype, xg, cols, vals, out, rows, width, k,
                       scale, zero, stream);
}

// x_blk is the [vb] source block the tile's local cols index (every col is
// -1 or in [0, vb)); extents is the [R] int32 row extents or null (every
// row walked to W); out is [R, 1].
extern "C" int ell_gather_fold(const float* x_blk, const int* cols,
                               const void* vals, const int* extents,
                               float* out, int rows, int width, int semiring,
                               int dtype, float scale, float zero,
                               cudaStream_t stream) {
  if (width % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (semiring) {
    case PLUS_TIMES: return gather_fold_dtype<PLUS_TIMES>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
    case PLUS_SRC: return gather_fold_dtype<PLUS_SRC>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
    case MIN_PLUS: return gather_fold_dtype<MIN_PLUS>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
    case MIN_SRC: return gather_fold_dtype<MIN_SRC>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
    case MAX_SRC: return gather_fold_dtype<MAX_SRC>(dtype, x_blk, cols, vals, extents, out, rows, width, scale, zero, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
