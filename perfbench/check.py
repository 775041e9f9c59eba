"""The comparison that decides ``correct``: every answer the window
completed against the plain reference.

Each application has a file of its own, ``perfbench/apps/<app>.py``, found
by the app's name: ``CHECK``, the name of its number (``<app>_wrong`` for
an exact app, ``pagerank_rel_err``); ``reference(graph, jobs, precision)``,
one expected [n] tensor a job; ``compare(got, want)``, the job's reading;
and, optionally, ``short(graph, jobs)``, answers that stop one iteration
short of the fixpoint (a control).  The worst reading of each number is
held to its limit in the traffic file's ``limits``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import reference as ref
from perfbench import spec

# jobs the reference answers in one pass: bounds its [n, GROUP] state
GROUP = 64


@dataclasses.dataclass
class Answer:
    app: str
    sources: tuple
    args: dict
    max_iters: int
    values: object  # [n] for a solo job, [n, K] for a batch

    @property
    def width(self) -> int:
        return 1 if self.values.ndim == 1 else self.values.shape[1]

    def column(self, k: int):
        return self.values if self.values.ndim == 1 else self.values[:, k]

    def job(self, k: int) -> "Job":
        return Job(self.sources[k] if self.sources else None, self.args,
                   self.max_iters)


@dataclasses.dataclass(frozen=True)
class Job:
    """One job of an answer, as an app's reference sees it."""
    source: int | None
    args: dict
    max_iters: int


def check_name(app: str) -> str:
    return spec.app(app).CHECK


def compare(answers: list[Answer], graph: ref.Graph,
            precision: str | None = None) -> tuple[dict, list]:
    """-> ({check name: worst reading}, [(check name, reading)] one per
    job, in order).

    ``precision`` puts the reference at that lower precision in the
    program's place (the control); the answers' values are not read then,
    only their jobs."""
    dev = graph.src.device
    jobs = [(a, k) for a in answers for k in range(a.width)]
    readings: dict[tuple[int, int], float] = {}
    for name in dict.fromkeys(a.app for a in answers):
        app = spec.app(name)
        mine = [(a, k) for a, k in jobs if a.app == name]
        for lo in range(0, len(mine), GROUP):
            group = mine[lo:lo + GROUP]
            specs = [a.job(k) for a, k in group]
            want = app.reference(graph, specs)
            got = (app.reference(graph, specs, precision)
                   if precision is not None else
                   [_on(a.column(k), dev) for a, k in group])
            for (a, k), g, w in zip(group, got, want):
                readings[id(a), k] = app.compare(g, w)
            del want, got
    per_job = [(check_name(a.app), readings[id(a), k]) for a, k in jobs]
    worst: dict[str, float] = {}
    for name, reading in per_job:
        worst[name] = max(worst.get(name, 0), reading)
    return worst, per_job


def _on(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(device)
    return torch.from_numpy(np.ascontiguousarray(values)).to(device)


def verdict(worst: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {value, limit}})."""
    table, ok = {}, True
    for name in sorted(worst):
        if name not in limits:
            raise KeyError(f"the traffic file gives no limit for {name!r}")
        table[name] = {"value": worst[name], "limit": limits[name]}
        ok &= worst[name] <= limits[name]
    return ok, table
