"""Batched LLM serving engine: prefill once, then decode greedily or with
temperature.

The KV caches and recurrent states stay on the device for the whole request
batch, and each decode step updates them in place.  The decode loop reads
nothing back to the host: positions are Python ints, tokens stay on the
device, and the batch's tokens are copied to the host once at the end.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeStats:
    prefill_seconds: float
    decode_seconds: float
    tokens_generated: int

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_generated / max(self.decode_seconds, 1e-9)


class ServeEngine:
    """``ServeEngine(model, device=None)`` runs on ``"cuda"`` unless asked
    for another device, and moves ``model`` there; without a GPU it raises
    unless ``device="cpu"``."""

    def __init__(self, model: Model, *, device=None):
        self.device = resolve_device("cuda" if device is None else device)
        self.model = model.to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for key, val in batch.items():
            t = torch.as_tensor(val)
            if key in ("tokens", "positions"):
                t = t.long()
            out[key] = t.to(self.device)
        return out

    @torch.inference_mode()
    def generate(self, batch: dict, *, num_tokens: int = 32,
                 temperature: float = 0.0,
                 seed: int = 0) -> tuple[np.ndarray, ServeStats]:
        """batch: ``tokens`` [B, S] (+ ``frames``, ``patches``,
        ``positions`` for the stubbed modalities), numpy or torch.
        -> (tokens [B, num_tokens] int32, stats)."""
        t0 = time.perf_counter()
        batch = self._to_device(batch)
        prompt_len = batch["tokens"].shape[1]
        extra = batch["patches"].shape[1] if "patches" in batch else 0
        logits, caches, enc_out = self.model.prefill(
            batch, cache_len=prompt_len + extra + num_tokens)
        self._sync()
        t1 = time.perf_counter()
        B = batch["tokens"].shape[0]
        gen = (torch.Generator(self.device).manual_seed(seed)
               if temperature > 0 else None)
        tok = self._sample(logits[:, 0], temperature, gen)
        out = [tok]
        pos = prompt_len + extra
        for i in range(num_tokens - 1):
            logits, caches = self.model.decode_step(
                caches, tok[:, None], pos + i, enc_out=enc_out)
            tok = self._sample(logits[:, 0], temperature, gen)
            out.append(tok)
        toks = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        self._sync()
        t2 = time.perf_counter()
        return toks, ServeStats(prefill_seconds=t1 - t0,
                                decode_seconds=t2 - t1,
                                tokens_generated=B * num_tokens)

    @staticmethod
    def _sample(logits, temperature: float, gen):
        """Greedy at ``temperature <= 0``; else Gumbel-max sampling of
        softmax(logits / temperature) from ``gen``."""
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                            dim=-1)
