"""ESG baseline — a faithful-in-I/O, simplified X-Stream (SOSP'13).

Edge-centric scatter-gather with streaming partitions:
  phase 1 (scatter): stream the edge list from disk (D|E| read), emit one
  update record per edge to an on-disk updates file (C|E| write);
  phase 2 (gather): stream the updates (C|E| read), fold into vertex values,
  write vertices (C|V| write).

No sorting or index structures — exactly why its preprocessing is the
cheapest (Table 8) and its per-iteration I/O the fattest (Table 3).

The files, the byte counts and the numpy fold are the reference package's
(``repro/baselines/esg.py``); the program's ``gather_transform``, ``post``
and ``changed`` run as torch functions on ``device``.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.apps import VertexProgram
from repro_torch.core.engine import resolve_device
from repro_torch.graph.source import BytesCounter


class ESGEngine:
    def __init__(self, workdir: str, src: np.ndarray, dst: np.ndarray,
                 num_vertices: int, num_partitions: int = 8, *,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.dir = Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n = num_vertices
        self.P = num_partitions
        self.io = BytesCounter()
        bounds = np.linspace(0, num_vertices, num_partitions + 1).astype(np.int64)
        self.bounds = bounds
        owner = np.searchsorted(bounds, src, side="right") - 1  # by SOURCE
        self.out_deg = np.bincount(src, minlength=num_vertices).astype(np.int64)
        for p in range(num_partitions):
            m = owner == p
            arr = np.stack([src[m], dst[m]])
            np.save(self.dir / f"edges_{p}.npy", arr)  # unsorted append-only
            self.io.written += arr.nbytes

    def _read(self, name):
        p = self.dir / name
        arr = np.load(p)
        self.io.read += p.stat().st_size
        return arr

    def _write(self, name, arr):
        np.save(self.dir / name, arr)
        self.io.written += (self.dir / name).stat().st_size

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def run(self, program: VertexProgram, max_iters: int = 100):
        vals, _ = program.init(self.n, None, self.out_deg)
        self._write("vertices.npy", vals.astype(np.float32))
        out_deg = self._dev(self.out_deg.astype(np.float32))
        t0 = time.time()
        it = 0
        for it in range(1, max_iters + 1):
            vertices = self._read("vertices.npy")
            x = program.gather_transform(self._dev(vertices),
                                         out_deg).cpu().numpy()
            # scatter: stream edges, write update records (dst, value)
            for p in range(self.P):
                edges = self._read(f"edges_{p}.npy")     # D|E| read
                w = 1.0 if program.semiring == "min_plus" else 0.0
                upd = np.stack([edges[1].astype(np.float32),
                                x[edges[0]].astype(np.float32) + w])
                self._write(f"updates_{p}.npy", upd)      # C|E| write
            # gather: stream updates, fold into vertices
            plus = program.semiring.startswith("plus")
            part = np.zeros(self.n, np.float32) if plus else np.full(self.n, np.inf,
                                                                     np.float32)
            for p in range(self.P):
                upd = self._read(f"updates_{p}.npy")      # C|E| read
                d = upd[0].astype(np.int64)
                if plus:
                    np.add.at(part, d, upd[1])
                else:
                    np.minimum.at(part, d, upd[1])
            old = self._dev(vertices)
            new_dev = program.post(self._dev(part), old, self.n)
            new_vals = new_dev.cpu().numpy()
            if not program.semiring.startswith("plus"):
                new_vals = np.minimum(new_vals, vertices)
            changed = program.changed(self._dev(new_vals), old).cpu().numpy()
            self._write("vertices.npy", new_vals)         # C|V| write
            if not changed.any():
                break
        return self._read("vertices.npy"), it, time.time() - t0
