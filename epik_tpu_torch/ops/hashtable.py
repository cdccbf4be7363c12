"""Bucketed cuckoo hash table of the CSR fallback: numpy build, torch lookup.

The host half (``_fmix32``, ``_hash2_np``, :class:`CuckooTable`,
:func:`build_table`) is copied as numpy from ``epik_tpu/ops/hashtable.py``
(:39-209), which imports jax when it loads. The same keys, payloads and seed
build the same table. :func:`lookup` ports the device probe (:212).

Torch covers few ops for uint32, so the device side holds the table's uint32
words in int64 and hashes in int64 with every product and shift kept inside
32 bits explicitly (:func:`_mul32`), never by relying on signed wraparound.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["BUCKET", "CuckooTable", "build_table", "lookup"]

BUCKET = 4
_EMPTY32 = np.uint32(0xFFFFFFFF)
#: keys are < 2**62 for every supported codec (DNA k<=16 -> 32 bits; amino
#: k<=14 -> 20**14 < 2**61), so an all-ones hi word can never be a real key.
_EMPTY_HI = _EMPTY32
_M32 = 0xFFFFFFFF


def _fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer (public-domain mixing constants); uint32 wraparound
    is intended."""
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def _hash2_np(hi: np.ndarray, lo: np.ndarray, seed1: int, seed2: int, mask: int):
    h1 = _fmix32(lo ^ _fmix32(hi ^ np.uint32(seed1))) & np.uint32(mask)
    h2 = _fmix32(lo ^ _fmix32(hi ^ np.uint32(seed2))) & np.uint32(mask)
    return h1, h2


@dataclasses.dataclass
class CuckooTable:
    """Host table: four (nb, BUCKET) uint32 arrays plus the two seeds."""

    key_hi: np.ndarray  # uint32[nb, BUCKET]
    key_lo: np.ndarray  # uint32[nb, BUCKET]
    off: np.ndarray  # uint32[nb, BUCKET]
    length: np.ndarray  # uint32[nb, BUCKET]
    seed1: int
    seed2: int

    @property
    def num_buckets(self) -> int:
        return self.key_hi.shape[0]

    def packed(self) -> np.ndarray:
        """One (nb, 4*BUCKET) uint32 array: [key_hi | key_lo | off | len];
        a bucket probe is then one row gather."""
        return np.concatenate([self.key_hi, self.key_lo, self.off, self.length], axis=1)

    def to_device(self, device) -> torch.Tensor:
        """The packed table as int64 (nb, 4*BUCKET) on ``device``."""
        return torch.from_numpy(self.packed().astype(np.int64)).to(device)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def build_table(
    keys: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    load_factor: float = 0.85,
    max_kicks: int = 512,
    seed: int = 0x9E3779B9,
    min_buckets: int = 1,
) -> CuckooTable:
    """Build the table on host from sorted-unique uint64 keys + CSR slices.

    Bulk pass: vectorized placement of up to BUCKET keys per h1 bucket;
    leftovers go through classic cuckoo random-walk eviction.  On a (rare)
    failure the whole build retries with fresh seeds.  ``min_buckets`` forces
    a common geometry across shards so per-shard tables can be stacked.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    nb = max(
        _next_pow2(max(1, int(np.ceil(n / (BUCKET * load_factor))))), min_buckets
    )
    mask = nb - 1
    rng = np.random.default_rng(seed)

    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    off32 = np.asarray(offsets, dtype=np.uint32)
    len32 = np.asarray(lengths, dtype=np.uint32)

    for _attempt in range(16):
        seed1 = int(rng.integers(1 << 32, dtype=np.uint64))
        seed2 = int(rng.integers(1 << 32, dtype=np.uint64))
        t_hi = np.full((nb, BUCKET), _EMPTY_HI, dtype=np.uint32)
        t_lo = np.full((nb, BUCKET), _EMPTY32, dtype=np.uint32)
        t_off = np.zeros((nb, BUCKET), dtype=np.uint32)
        t_len = np.zeros((nb, BUCKET), dtype=np.uint32)
        if n == 0:
            return CuckooTable(t_hi, t_lo, t_off, t_len, seed1, seed2)

        h1, h2 = _hash2_np(hi, lo, seed1, seed2, mask)

        # --- bulk pass: first BUCKET arrivals per h1 bucket, vectorized ------
        order = np.argsort(h1, kind="stable")
        sh = h1[order]
        idx = np.arange(n)
        new_group = np.empty(n, dtype=bool)
        new_group[0] = True
        new_group[1:] = sh[1:] != sh[:-1]
        group_start = np.maximum.accumulate(np.where(new_group, idx, 0))
        rank = idx - group_start
        fits = rank < BUCKET
        rows = sh[fits]
        cols = rank[fits]
        src = order[fits]
        t_hi[rows, cols] = hi[src]
        t_lo[rows, cols] = lo[src]
        t_off[rows, cols] = off32[src]
        t_len[rows, cols] = len32[src]

        # --- bulk retry rounds: place overflow keys into their alternate
        # bucket (and back), vectorized; only true double-full stragglers
        # reach the scalar eviction walk
        leftovers = order[~fits]
        hh = (h2, h1)
        occupancy = np.count_nonzero(t_hi != _EMPTY_HI, axis=1)
        for round_i in range(6):
            if leftovers.size == 0:
                break
            h = hh[round_i % 2]
            l2 = leftovers[np.argsort(h[leftovers], kind="stable")]
            sh2 = h[l2]
            idx2 = np.arange(l2.shape[0])
            ng2 = np.empty(l2.shape[0], dtype=bool)
            ng2[0] = True
            ng2[1:] = sh2[1:] != sh2[:-1]
            gs2 = np.maximum.accumulate(np.where(ng2, idx2, 0))
            rank2 = idx2 - gs2 + occupancy[sh2]
            fits2 = rank2 < BUCKET
            rows2, cols2, src2 = sh2[fits2], rank2[fits2], l2[fits2]
            t_hi[rows2, cols2] = hi[src2]
            t_lo[rows2, cols2] = lo[src2]
            t_off[rows2, cols2] = off32[src2]
            t_len[rows2, cols2] = len32[src2]
            np.add.at(occupancy, rows2, 1)
            leftovers = l2[~fits2]

        # --- eviction pass for the few remaining keys ------------------------
        ok = True
        for i in leftovers:
            cur = (int(hi[i]), int(lo[i]), int(off32[i]), int(len32[i]))
            b = int(h2[i])  # h1 bucket is full by construction
            placed = False
            for _kick in range(max_kicks):
                empty = np.nonzero(t_hi[b] == _EMPTY_HI)[0]
                if empty.size:
                    c = int(empty[0])
                    t_hi[b, c], t_lo[b, c], t_off[b, c], t_len[b, c] = cur
                    placed = True
                    break
                # evict a random slot, move the victim to its other bucket
                c = int(rng.integers(BUCKET))
                victim = (int(t_hi[b, c]), int(t_lo[b, c]), int(t_off[b, c]), int(t_len[b, c]))
                t_hi[b, c], t_lo[b, c], t_off[b, c], t_len[b, c] = cur
                vh1, vh2 = _hash2_np(
                    np.uint32(victim[0]), np.uint32(victim[1]), seed1, seed2, mask
                )
                b = int(vh2) if b == int(vh1) else int(vh1)
                cur = victim
            if not placed:
                ok = False
                break
        if ok:
            return CuckooTable(t_hi, t_lo, t_off, t_len, seed1, seed2)
    raise RuntimeError(f"cuckoo build failed for n={n} nb={nb} after 16 seed retries")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a constant c < 2**32,
    as two products of a 16-bit half with c: each stays below 2**48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_t(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values (x >= 0, so
    ``>>`` is the logical shift)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def lookup(table: torch.Tensor, seed1: int, seed2: int, key_hi: torch.Tensor,
           key_lo: torch.Tensor):
    """Keys -> (found bool, off int64, len int64), as the device probe of
    ``epik_tpu/ops/hashtable.py::lookup``.

    ``table``: int64 (nb, 4*BUCKET) from :meth:`CuckooTable.to_device`;
    ``key_hi``/``key_lo``: the keys' uint32 halves in any integer dtype.
    Misses, the padding sentinel key included, return len == 0."""
    mask = table.shape[0] - 1
    hi = key_hi.to(torch.int64) & _M32
    lo = key_lo.to(torch.int64) & _M32
    h1 = _fmix32_t(lo ^ _fmix32_t(hi ^ seed1)) & mask
    h2 = _fmix32_t(lo ^ _fmix32_t(hi ^ seed2)) & mask
    g = torch.cat([table[h1], table[h2]], dim=-1)  # (E, 8*BUCKET)
    b = BUCKET
    cand = g.view(*g.shape[:-1], 2, 4, b).transpose(-3, -2)  # (E, 4, 2, b)
    cand = cand.reshape(*g.shape[:-1], 4, 2 * b)  # fields x (h1 slots, h2 slots)
    cand_hi, cand_lo, cand_off, cand_len = cand.unbind(-2)
    # exclude empty slots: their marker equals the padding sentinel key, and
    # real keys never have an all-ones hi word
    match = (cand_hi == hi[..., None]) & (cand_lo == lo[..., None]) & (cand_hi != _M32)
    found = match.any(dim=-1)
    slot = match.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first match
    off = torch.gather(cand_off, -1, slot)[..., 0]
    length = torch.gather(cand_len, -1, slot)[..., 0]
    return found, off, torch.where(found, length, torch.zeros_like(length))
