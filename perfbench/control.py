"""The controls of the comparison: answers that must come out as not
correct, each put through the harness's own comparison and verdict
(``perfbench/check.py``) in the program's place.

    python3 perfbench/control.py --workload g22-bfs-k16 --seeds 11 12 13

For each seed it takes the requests a run of the cell sends first (one
rotation of its traffic, at the cell's own graph and batch) and answers
them twice:

- ``bfloat16``: the reference one precision below the float32 the
  configurations state;
- ``one_level_short``: for the apps whose file has ``short``, the
  reference stopped one iteration short of its fixpoint, the guarantee an
  exact traversal states (unit-weight BFS hop counts are exact in
  bfloat16, so only this control fails a BFS cell); the other apps'
  answers are the reference's own.

It prints each control's numbers beside the traffic file's limits and
exits 1 when a seed's controls all pass.  Does not run the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import check, data, reference, spec, traffic  # noqa: E402

LOW = "bfloat16"


def _first_rotation(cell: spec.Cell, seed: int, files: data.GraphFiles):
    pool = np.load(files.pool)
    stream = traffic.requests(cell.traffic, pool, traffic.seeded(seed, 1))
    return [next(stream) for _ in range(traffic.rotation_length(cell.traffic))]


def _blank(r: traffic.Request) -> check.Answer:
    """The request's jobs with no values: the control answers them."""
    return check.Answer(r.app, r.sources, r.args, r.max_iters,
                        np.empty((0, r.batch) if r.batch else (0,)))


def _short_answers(reqs, graph: reference.Graph) -> list[check.Answer]:
    out = []
    for r in reqs:
        app = spec.app(r.app)
        jobs = [_blank(r).job(k) for k in range(r.jobs)]
        cols = (app.short(graph, jobs) if hasattr(app, "short")
                else app.reference(graph, jobs))
        values = torch.stack(list(cols), 1) if r.batch else cols[0]
        out.append(check.Answer(r.app, r.sources, r.args, r.max_iters,
                                values))
    return out


def control_verdicts(cell: spec.Cell, seed: int, device,
                     data_root: Path = data.DATA,
                     graph: reference.Graph | None = None) -> dict:
    """-> {control: (correct, {number: {value, limit}})} on the first
    rotation of ``seed``'s requests, each judged by ``check.verdict``."""
    files = data.ensure_graph(cell.config, data_root)
    if graph is None:
        src, dst, w = data.load_edges(files)
        graph = reference.Graph.from_numpy(src, dst, w, files.num_vertices,
                                           torch.device(device))
    reqs = _first_rotation(cell, seed, files)
    limits = cell.traffic["limits"]
    low, _ = check.compare([_blank(r) for r in reqs], graph, precision=LOW)
    short, _ = check.compare(_short_answers(reqs, graph), graph)
    return {LOW: check.verdict(low, limits),
            "one_level_short": check.verdict(short, limits)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    files = data.ensure_graph(cell.config)
    src, dst, w = data.load_edges(files)
    graph = reference.Graph.from_numpy(src, dst, w, files.num_vertices,
                                       torch.device(args.device))
    del src, dst, w
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        verdicts = control_verdicts(cell, seed, args.device, graph=graph)
        failed_all &= any(not ok for ok, _ in verdicts.values())
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "controls": {name: {"correct": ok, "checks": table}
                         for name, (ok, table) in verdicts.items()},
            "seconds": time.perf_counter() - t}), flush=True)
    sys.exit(0 if failed_all else 1)


if __name__ == "__main__":
    main()
