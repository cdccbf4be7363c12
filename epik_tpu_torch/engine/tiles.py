"""The posting-tile state of the big-tree path, built in numpy as
``epik_tpu/engine/placer.py::JaxPlacer._dev_tiles`` builds it (:2108-2270),
without the opt-in pair-fused rows.

Every key's postings become one fixed-width tile row, so a window costs one
contiguous row gather; row ``n_keys`` is all trash (the miss row). Two
payloads (``PlacerConfig.tile_payload``):

* packed -- one int32 ``(branch << 16) | q`` per cell, ``q`` the shifted
  score ``s - log10(eps)`` on a 64000-step grid, clipped to [1, 64000] so a
  posting at the threshold stays touched; trash cells ``trash << 16``. When
  the length distribution makes it cheaper, the main plane keeps only the
  first ``pt`` postings of each key (the cost knee) and the tails go to an
  overflow plane; overflow keys take tile rows ``[0, n_ov)`` (a row
  permutation baked into the direct table), and overflow row = main row + 1;
* f32 -- interleaved ``[branch | shifted-score bits]`` pairs as int32
  (n_keys+1, 2*pt); a shifted score that would not stay > 0 is nudged to
  1e-37, as in the dense shifted plane.

:func:`tile_state_from_numpy` takes the JAX placer's own arrays instead, so
tests can feed both engines the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.accumulate_packed import tile_width

__all__ = ["TileState", "build_tile_state", "tile_bytes", "tile_pt",
           "tile_state_from_numpy"]

#: quantization grid of the packed payload's shifted scores
Q_MAX = 64000


def tile_pt(max_plen: int) -> int:
    """Tile width before any two-level split: the longest posting list,
    rounded up to 8 (placer.py:1833)."""
    return -(-max(max_plen, 1) // 8) * 8


def tile_bytes(n_keys: int, max_plen: int) -> int:
    """The bytes the routing holds against the budget (placer.py:1834)."""
    return (n_keys + 1) * tile_pt(max_plen) * 8


@dataclasses.dataclass
class TileState:
    tiles: torch.Tensor  # int32 (n_keys+1, pt) packed, or (n_keys+1, 2*pt) f32 pairs
    direct: torch.Tensor  # int32 (4**k,) key -> tile row; misses -> n_keys
    tiles_ov: torch.Tensor | None  # int32 (n_ov+1, pt_ov); row 0 all trash
    pt: int
    pt_ov: int
    n_ov: int
    frac_over: float  # share of keys with postings in the overflow plane
    scale: float  # quantization scale of the packed payload (1.0 for f32)
    packed: bool
    n_keys: int

    @property
    def nbytes(self) -> int:
        ts = [self.tiles, self.direct] + ([self.tiles_ov] if self.tiles_ov is not None
                                          else [])
        return sum(t.numel() * t.element_size() for t in ts)


def _to(a: np.ndarray, device) -> torch.Tensor:
    # "W": arrays viewed from JAX buffers are read-only; torch needs a copy
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def tile_state_from_numpy(tiles: np.ndarray, tiles_ov: np.ndarray | None,
                          direct: np.ndarray, *, pt: int, pt_ov: int, n_ov: int,
                          frac_over: float, scale: float, n_keys: int,
                          device) -> TileState:
    """State from host arrays, e.g. ``np.asarray`` of ``JaxPlacer._dev_tiles``,
    ``_dev_tiles_ov`` and ``_direct_np`` (read before the build clears it, or
    ``_dev_direct``) with its ``_tile_pt``, ``_tile_pt_ov``, ``_tile_n_ov``,
    ``_tile_frac_over`` and ``_tile_scale``. The f32 payload's uint32 cells
    are taken bit for bit as int32."""
    packed = tiles.shape[1] == pt
    return TileState(
        tiles=_to(tiles.view(np.int32), device),
        direct=_to(direct.astype(np.int32), device),
        tiles_ov=_to(tiles_ov.view(np.int32), device) if tiles_ov is not None else None,
        pt=pt, pt_ov=pt_ov, n_ov=n_ov, frac_over=frac_over, scale=scale,
        packed=packed, n_keys=n_keys)


def build_tile_state(db, *, k: int, B: int, log_eps: np.float32, packed: bool,
                     device) -> TileState:
    """Build the tiles of ``db`` (see the module docstring) on ``device``."""
    n = db.num_kmers
    lens = np.diff(db.row_off).astype(np.int64)
    max_plen = int(lens.max()) if lens.size else 0
    PT = tile_pt(max_plen)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    cols = np.arange(rows.shape[0], dtype=np.int64) - np.repeat(db.row_off[:-1], lens)
    shifted = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)
    trash = tile_width(B) - 1
    direct = np.full(4**k, n, dtype=np.int32)
    direct[db.keys.astype(np.int64)] = np.arange(n, dtype=np.int32)
    if not packed:
        til = np.empty((n + 1, 2 * PT), np.uint32)
        til[:, 0::2] = np.uint32(trash)
        til[:, 1::2] = np.float32(0.0).view(np.uint32)
        til[rows, 2 * cols] = db.branches.astype(np.uint32)
        # threshold-boundary scores (s == log10(eps)) shift to exactly 0,
        # which would drop the branch from the "touched" test (S' > 0)
        shifted = np.where(shifted <= 0.0, np.float32(1e-37), shifted)
        til[rows, 2 * cols + 1] = shifted.view(np.uint32)
        return TileState(tiles=_to(til.view(np.int32), device),
                         direct=_to(direct, device), tiles_ov=None, pt=PT, pt_ov=0,
                         n_ov=0, frac_over=0.0, scale=1.0, packed=False, n_keys=n)

    span = max(float(-log_eps), 1e-6)
    scale = Q_MAX / span
    q = np.clip(np.rint(shifted.astype(np.float64) * scale), 1, Q_MAX).astype(np.int32)
    vals = (db.branches.astype(np.int32) << 16) | q
    trash_val = np.int32(trash << 16)
    pt_ov = n_ov = 0
    frac_over = 0.0
    ovt = None
    if PT > 8:
        # two-level split: the main plane keeps the first PT postings of each
        # key, PT chosen to minimize the expected cells per window
        # (PT + 2 * frac_over * PT_ov)
        best, best_cost = PT, float(PT)
        for cand in range(8, PT, 8):
            fo = float((lens > cand).mean())
            ptov = -(-(max_plen - cand) // 8) * 8
            cost = cand + 2.0 * fo * ptov
            if cost < best_cost - 0.5:
                best, best_cost = cand, cost
        if best < PT and bool((lens > best).any()):
            PT = best
            pt_ov = -(-(max_plen - PT) // 8) * 8
            frac_over = float((lens > PT).mean())
            # overflow keys take tile rows 0..n_ov-1, so "the window has
            # overflow postings" is the arithmetic row < n_ov
            over = lens > PT
            ov_keys = np.flatnonzero(over)
            n_ov = ov_keys.shape[0]
            perm = np.empty(n, np.int64)
            perm[ov_keys] = np.arange(n_ov)
            perm[np.flatnonzero(~over)] = np.arange(n_ov, n)
            direct[db.keys.astype(np.int64)] = perm.astype(np.int32)
            ovt = np.full((n_ov + 1, pt_ov), trash_val, np.int32)
            ov_sel = cols >= PT
            ovt[perm[rows[ov_sel]] + 1, cols[ov_sel] - PT] = vals[ov_sel]
            rows = perm[rows[~ov_sel]]
            cols = cols[~ov_sel]
            vals = vals[~ov_sel]
    til = np.full((n + 1, PT), trash_val, np.int32)
    til[rows, cols] = vals
    return TileState(tiles=_to(til, device), direct=_to(direct, device),
                     tiles_ov=_to(ovt, device) if ovt is not None else None,
                     pt=PT, pt_ov=pt_ov, n_ov=n_ov, frac_over=frac_over,
                     scale=scale, packed=True, n_keys=n)
