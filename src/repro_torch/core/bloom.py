"""Bloom filters for selective scheduling (paper §2.4.1).

One filter per shard, built over the shard's *source* vertices.  At the start
of an iteration with active-vertex ratio < threshold, a shard is loaded and
processed only if its filter might contain an active vertex.

Bloom filters never produce false negatives, so skipping is always safe
(an inactive shard by filter evidence is truly unable to produce updates);
false positives only cost an unnecessary load — exactly the paper's contract.
Property-tested in tests/test_bloom.py.

Probing is host-side numpy everywhere, including the multi-device engines:
the filters are KBs, so they are simply REPLICATED — every host probes the
same filters against the same frontier and derives the identical skip
schedule without any cross-device coordination (see core/distributed.py).
There is deliberately no on-device (jnp) probe path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# multiply-shift hash constants (odd, 64-bit), one per hash function
_HASH_MULTS = np.array(
    [0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9, 0x27D4EB2F165667C5],
    dtype=np.uint64,
)


def _hash(ids: np.ndarray, k: int, num_bits: int) -> np.ndarray:
    """[k, n] bit positions for each id under k multiply-shift hashes."""
    x = ids.astype(np.uint64)[None, :] * _HASH_MULTS[:k, None]
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(num_bits)).astype(np.int64)


@dataclasses.dataclass
class BloomFilter:
    bits: np.ndarray  # uint8 bitmask array, length num_bits/8
    num_bits: int
    num_hashes: int

    @classmethod
    def build(cls, ids: np.ndarray, num_bits: int = 1 << 16, num_hashes: int = 3) -> "BloomFilter":
        num_bits = max(64, int(num_bits))
        bits = np.zeros(num_bits // 8, dtype=np.uint8)
        if ids.size:
            pos = _hash(np.asarray(ids), num_hashes, num_bits).ravel()
            np.bitwise_or.at(bits, pos // 8, (1 << (pos % 8)).astype(np.uint8))
        return cls(bits=bits, num_bits=num_bits, num_hashes=num_hashes)

    @classmethod
    def sized_for(cls, n_items: int, fp_rate: float = 0.01, num_hashes: int = 3) -> int:
        """Bits needed for ~fp_rate with num_hashes hashes (rounded to pow2)."""
        if n_items <= 0:
            return 64
        # m = -k*n / ln(1 - p^{1/k})
        m = -num_hashes * n_items / np.log(1.0 - fp_rate ** (1.0 / num_hashes))
        return 1 << int(np.ceil(np.log2(max(m, 64))))

    def might_contain(self, ids: np.ndarray) -> np.ndarray:
        """[n] bool — per-id membership test (no false negatives)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return np.zeros(0, dtype=bool)
        pos = _hash(ids, self.num_hashes, self.num_bits)  # [k, n]
        hit = (self.bits[pos // 8] >> (pos % 8).astype(np.uint8)) & 1
        return hit.all(axis=0).astype(bool)

    def might_contain_any(self, ids: np.ndarray) -> bool:
        """True iff any id might be in the set (the shard-skip predicate)."""
        ids = np.asarray(ids)
        if ids.size == 0:
            return False
        # chunk to bound memory on big frontiers
        for lo in range(0, ids.size, 1 << 20):
            if self.might_contain(ids[lo : lo + (1 << 20)]).any():
                return True
        return False

    def nbytes(self) -> int:
        return int(self.bits.nbytes)
