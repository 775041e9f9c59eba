"""The one traffic generator: turns a traffic file and a seed into requests.

A traffic file (``perfbench/workloads/<traffic>.json``) lists request
templates under ``requests``; the generator cycles through them in order,
closed loop, one request in flight.  A template has

- ``app``: the application's registered name in the program;
- ``batch`` (optional): K, the number of columns of one ``run_batch`` call;
  without it the request is one solo ``run``;
- ``roots`` (optional): where a request's sources come from; the only
  pool is ``"degree_ge_1"``, vertices with degree >= 1 not counting
  self-loops, drawn uniformly and distinct within a request, as Graph500
  draws its search keys;
- ``args`` (optional): keyword arguments of the application;
- ``max_iters``: the run's iteration cap.

A batch of K counts as K jobs.  The roots come from ``--seed`` alone, so
the same seed gives the same requests.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

POOLS = ("degree_ge_1",)


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    app: str
    batch: int | None       # K for run_batch, None for a solo run
    sources: tuple          # the roots, () for a source-free app
    args: dict
    max_iters: int

    @property
    def jobs(self) -> int:
        return self.batch or 1

    @property
    def span(self) -> str:
        kind = "batch" if self.batch else "job"
        return f"perfbench.{kind}.{self.app}"


def _check(template: dict) -> None:
    unknown = set(template) - {"app", "batch", "roots", "args", "max_iters"}
    if unknown:
        raise ValueError(f"unknown keys in a request template: "
                         f"{sorted(unknown)}")
    if template.get("roots") is not None and template["roots"] not in POOLS:
        raise ValueError(f"unknown root pool {template['roots']!r}")
    if template.get("batch") is not None and not template.get("roots"):
        raise ValueError("a batch needs roots")


def requests(traffic: dict, pool: np.ndarray,
             rng: np.random.Generator) -> Iterator[Request]:
    """The endless request stream of ``traffic``; ``pool`` holds the ids
    roots are drawn from, ``rng`` draws them."""
    templates = traffic["requests"]
    for t in templates:
        _check(t)
    i = 0
    while True:
        t = templates[i % len(templates)]
        sources = ()
        if t.get("roots"):
            k = t.get("batch") or 1
            sources = tuple(int(v) for v in pool[
                rng.choice(pool.size, size=k, replace=False)])
        yield Request(i, t["app"], t.get("batch"), sources,
                      dict(t.get("args", {})), int(t["max_iters"]))
        i += 1


def rotation_length(traffic: dict) -> int:
    return len(traffic["requests"])


def seeded(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of a run's independent streams (0: the warm-up
    requests, 1: the window's requests) for ``seed``."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])
