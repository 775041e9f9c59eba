"""PSW baseline — a faithful-in-I/O, simplified GraphChi (OSDI'12).

What matters for the paper's comparison (Table 3) is the I/O *pattern*, which
this reproduces with real files:
  * vertex values live ON DISK and are read+written every iteration (C|V|);
  * edges carry attached source-vertex values (record size C+D), so each
    iteration reads 2(C+D)|E|-ish and re-writes edge values after vertices
    change — the PSW model's defining cost;
  * computation itself is vectorized numpy (we are benchmarking I/O patterns,
    not Python loops).

GraphMP's advantage in the Table-5 benchmark is therefore structural (VSW
keeps vertices in memory and never writes them), not an artifact of a slow
baseline implementation.

The files, the byte counts and the numpy fold are the reference package's
(``repro/baselines/psw.py``); the program's ``gather_transform``, ``post``
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


class PSWEngine:
    def __init__(self, workdir: str, src: np.ndarray, dst: np.ndarray,
                 num_vertices: int, num_shards: int = 8, *,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.dir = Path(workdir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n = num_vertices
        self.P = num_shards
        self.io = BytesCounter()
        bounds = np.linspace(0, num_vertices, num_shards + 1).astype(np.int64)
        self.bounds = bounds
        owner = np.searchsorted(bounds, dst, side="right") - 1
        self.out_deg = np.bincount(src, minlength=num_vertices).astype(np.int64)
        for p in range(num_shards):
            m = owner == p
            # GraphChi stores edges sorted by source within a shard
            order = np.argsort(src[m], kind="stable")
            arr = np.stack([src[m][order], dst[m][order]])
            np.save(self.dir / f"edges_{p}.npy", arr)
            self.io.written += arr.nbytes
            # attached edge values (the C in C+D)
            ev = np.zeros(m.sum(), dtype=np.float32)
            np.save(self.dir / f"evals_{p}.npy", ev)
            self.io.written += ev.nbytes

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

    def run(self, program: VertexProgram, max_iters: int = 100) -> tuple[np.ndarray, int, float]:
        vals, _ = program.init(self.n, None, self.out_deg)
        self._write("vertices.npy", vals.astype(np.float32))
        out_deg = self._dev(self.out_deg.astype(np.float32))
        # seed edge values with gather-transformed source values
        x0 = program.gather_transform(self._dev(vals.astype(np.float32)),
                                      out_deg).cpu().numpy()
        for p in range(self.P):
            edges = self._read(f"edges_{p}.npy")
            self._write(f"evals_{p}.npy", x0[edges[0]].astype(np.float32))
        t0 = time.time()
        it = 0
        for it in range(1, max_iters + 1):
            vertices = self._read("vertices.npy")  # C|V| read
            new_vals = vertices.copy()
            for p in range(self.P):
                edges = self._read(f"edges_{p}.npy")       # D|E| read
                evals = self._read(f"evals_{p}.npy")       # C|E| read (attached)
                lo, hi = self.bounds[p], self.bounds[p + 1]
                contrib = evals  # values attached to in-edges (already x[src])
                if program.semiring.startswith("plus"):
                    part = np.zeros(hi - lo, np.float32)
                    np.add.at(part, edges[1] - lo, contrib)
                else:
                    part = np.full(hi - lo, np.inf, np.float32)
                    w = 1.0 if program.semiring == "min_plus" else 0.0
                    np.minimum.at(part, edges[1] - lo, contrib + w)
                old = vertices[lo:hi]
                upd = program.post(self._dev(part), self._dev(old),
                                   self.n).cpu().numpy()
                # degree-0 vertices with min semirings keep old values
                if not program.semiring.startswith("plus"):
                    upd = np.minimum(upd, old)
                new_vals[lo:hi] = upd
            changed = program.changed(self._dev(new_vals),
                                      self._dev(vertices)).cpu().numpy()
            self._write("vertices.npy", new_vals)          # C|V| write
            xn = program.gather_transform(self._dev(new_vals),
                                          out_deg).cpu().numpy()
            for p in range(self.P):                        # (C+D)|E| write
                edges = self._read(f"edges_{p}.npy")
                self._write(f"evals_{p}.npy", xn[edges[0]].astype(np.float32))
            if not changed.any():
                break
        return self._read("vertices.npy"), it, time.time() - t0
