"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload g22-bfs-k16 --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit); the checks are also the last lines of standard
error.  With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profiler trace of the
window.  The run exits non-zero and prints no result without CUDA, with
fewer cards than the cell asks for, without the program's package beside
the benchmark, or when a module of the JAX package is loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / "_cache"


def _paths() -> None:
    """The checkout's root (for ``perfbench``) and ``src`` (for the program)
    first on the path; build caches at fixed places inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p in sys.path:
            sys.path.remove(p)
        sys.path.insert(0, p)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def _fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _port_or_fail() -> None:
    """The program's package from this checkout's ``src``, or exit."""
    try:
        import repro_torch
    except ImportError as exc:
        _fail(f"the program's package is not in this checkout: {exc}")
    where = Path(repro_torch.__file__).resolve()
    if ROOT / "src" not in where.parents:
        _fail(f"repro_torch was imported from {where}, not from this "
              "checkout's src/")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import torch

    from perfbench import bench, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: no result without a GPU")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} visible")
    _port_or_fail()
    # no float32 product of the reference runs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T0)
    found = bench.forbidden_modules()
    if found:
        _fail(f"modules of the JAX package are loaded: {found}", 3)
    for name, row in result["checks"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
