#!/usr/bin/env python3
"""Time the design choices of the B4 kernel (``ell_gather_fold``) on one GPU.

    python3 tools/tune_b4.py [--scale 22] [--edge-factor 16]

Run from the root of the repository, on a machine with a CUDA GPU and
``nvcc``.  It builds ``src/repro_torch/kernels/spmv/csrc/ell_spmv.cu`` once
for each number of lanes that share an ELL row (4, 8 and 32, set as both
``kExtentLanes`` and ``kFullWidthLanes``) into a temporary directory, each
build with one more C function that sets an L2 access-policy window on a
stream.  It lays the Graph500
RMAT edges (seed 0, as ``chip_smoke.py`` makes them) out as
``chip_smoke.py``'s 2 x 2 tiling, builds the tiles' row extents on the card,
checks every build against the plain version (min_plus bitwise), and times
one pass over the 4 tiles (device time from torch.profiler, as
``chip_smoke.py`` takes it), plus_src and min_plus over the float32 unit
values:

* each lanes choice, with the extents and without, in turns (forward, then
  backward, the better of the two kept);
* the source's ``kExtentLanes``, with the extents, with an L2 persisting
  window over each tile's source block set for its launch and without one,
  in turns.

Prints one ``tune:`` line per timing, the card's name and power limit, and
a JSON object of the times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LANES = (4, 8, 32)
# the lanes-a-row constants of the source, with the extents and without
LANE_CONSTANTS = ("constexpr int kExtentLanes = ",
                  "constexpr int kFullWidthLanes = ")
# an L2 access-policy window over [base, base + bytes) for the launches on
# `stream`; bytes = 0 clears the window and the persisting lines
WINDOW_SOURCE = r"""
extern "C" int l2_window(void* base, size_t bytes, cudaStream_t stream) {
  int dev = 0, max_window = 0, max_persist = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                         dev);
  cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize,
                         dev);
  if (bytes > static_cast<size_t>(max_window)) bytes = max_window;
  if (bytes)
    cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                       bytes < static_cast<size_t>(max_persist)
                           ? bytes : max_persist);
  cudaStreamAttrValue attr = {};
  attr.accessPolicyWindow.base_ptr = base;
  attr.accessPolicyWindow.num_bytes = bytes;
  attr.accessPolicyWindow.hitRatio = 1.0f;
  attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow,
                         &attr);
  if (!bytes) cudaCtxResetPersistingL2Cache();
  return static_cast<int>(cudaGetLastError());
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def start_builds(cuda, tmp: Path) -> tuple[dict, int]:
    """One nvcc per lanes choice, all started together -> ({L: (proc,
    so)}, the source's kExtentLanes)."""
    text = cuda.SOURCE.read_text()
    lines = [next(ln for ln in text.splitlines() if ln.startswith(c))
             for c in LANE_CONSTANTS]
    builds = {}
    for lanes in LANES:
        variant = text
        for const, line in zip(LANE_CONSTANTS, lines):
            variant = variant.replace(line, f"{const}{lanes};")
        src = tmp / f"ell_spmv_l{lanes}.cu"
        src.write_text(variant + WINDOW_SOURCE)
        so = tmp / f"libell_spmv_l{lanes}.so"
        cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(so), str(src)]
        builds[lanes] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True),
                         so)
    return builds, int(lines[0][len(LANE_CONSTANTS[0]):].rstrip(";"))


def load(proc, so: Path) -> ctypes.CDLL:
    _out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{err}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ell_gather_fold.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p]
    lib.ell_gather_fold.restype = i
    lib.l2_window.argtypes = [p, ctypes.c_size_t, p]
    lib.l2_window.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edge-factor", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("tune_b4: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.core.semiring import SEMIRING_IDS
    from repro_torch.graph.generate import materialize, rmat_edges
    from repro_torch.kernels.spmv import cuda, ref
    from repro_torch.kernels.spmv.ops import ell_row_extents

    card = chip_smoke.gpu_name_and_power()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="tune_b4_") as tmp:
        t0 = time.perf_counter()
        builds, extent_lanes = start_builds(cuda, Path(tmp))
        src, dst = materialize(rmat_edges(args.scale, args.edge_factor,
                                          a=0.57, b=0.19, c=0.19, seed=0))
        n = int(max(src.max(), dst.max())) + 1
        ells = chip_smoke.tile_ells(src, dst, n)
        del src, dst
        libs = {lanes: load(*b) for lanes, b in builds.items()}
        log(f"tune: {card}; {len(libs)} builds and the tiling of {n} "
            f"vertices in {time.perf_counter() - t0:.1f}s")
        vb = -(-n // chip_smoke.LANES)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.rand(chip_smoke.LANES * vb, generator=gen, device=dev)
        tiles = []
        for (d, s), ell in sorted(ells.items()):
            cols = torch.from_numpy(ell.cols).to(dev)
            tiles.append(dict(cols=cols, unit=torch.from_numpy(ell.vals)
                              .to(dev), extents=ell_row_extents(cols),
                              x=x[s * vb:(s + 1) * vb]))
        del ells
        stream = torch.cuda.Stream(dev)

        def launch(lib, t, sem, extents):
            out = torch.empty((t["cols"].shape[0], 1), device=dev)
            rc = lib.ell_gather_fold(
                t["x"].data_ptr(), t["cols"].data_ptr(), t["unit"].data_ptr(),
                t["extents"].data_ptr() if extents else None, out.data_ptr(),
                t["cols"].shape[0], t["cols"].shape[1], SEMIRING_IDS[sem], 0,
                1.0, 0.0, stream.cuda_stream)
            if rc:
                raise RuntimeError(f"ell_gather_fold launch failed: {rc}")
            return out

        def windowed(lib, t, sem, on):
            rc = lib.l2_window(t["x"].data_ptr() if on else None,
                               t["x"].numel() * 4 if on else 0,
                               stream.cuda_stream)
            if rc:
                raise RuntimeError(f"l2_window failed: {rc}")
            return launch(lib, t, sem, True)

        times: dict = {}
        with torch.cuda.stream(stream):
            for sem in ("plus_src", "min_plus"):
                for lanes, lib in libs.items():
                    for t in tiles:
                        want = ref.ell_gather_fold_ref(t["x"], t["cols"],
                                                       t["unit"], sem)
                        for extents in (True, False):
                            got = launch(lib, t, sem, extents)
                            ok, e = chip_smoke._compare(
                                torch, got, want, sem.startswith("plus"))
                            if not ok:
                                raise RuntimeError(
                                    f"L={lanes} extents={extents} {sem} "
                                    f"differs from the plain version by {e}")
                order = [(lanes, e) for lanes in libs for e in (True, False)]
                for lanes, extents in order + order[::-1]:
                    ms = chip_smoke._time_sweep(torch, [
                        lambda t=t: launch(libs[lanes], t, sem, extents)
                        for t in tiles])[0]
                    key = f"{sem} L={lanes} extents={extents}"
                    times[key] = min(times.get(key, ms), ms)
                lib = libs[extent_lanes]
                for on in (False, True, True, False):
                    ms = chip_smoke._time_sweep(torch, [
                        lambda t=t: windowed(lib, t, sem, on)
                        for t in tiles])[0]
                    key = f"{sem} L={extent_lanes} extents=True window={on}"
                    times[key] = min(times.get(key, ms), ms)
                lib.l2_window(None, 0, stream.cuda_stream)
        torch.cuda.synchronize()
    for key, ms in times.items():
        log(f"tune: {key}: {ms:.4f} ms one pass over {len(tiles)} tiles")
    print(card)
    print(json.dumps({"card": card, "extent_lanes": extent_lanes,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
