"""The placer's device state.

* The dense route: the combined shifted plane and the combo table.
  :func:`build_plane_state` builds them from a database as
  ``epik_tpu/engine/placer.py`` does (:1892-2026): the shifted cells
  ``s - log10(eps)`` with the ``sp <= 0 -> 1e-37`` presence nudge, the width
  padded to a multiple of 128, the all-zero row at ``n_keys``, and the pair
  rows (each the f32 sum of two base rows) after it.
  :func:`plane_state_from_numpy` takes the JAX placer's own arrays instead,
  so tests can feed both engines the same state.
* The CSR step: the cuckoo table over the keys (payload: the key's row) and
  the postings, as ``JaxPlacer.table``/``_dev_postings``/``_dev_row_off``
  hold them (:2272-2305), built by :func:`build_csr_state`.
* The tiles route's state lives in ``tiles.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.hashtable import build_table
from .tables import build_combo_table, direct_table, enumerate_pairs

__all__ = ["CsrState", "PlaneState", "build_csr_state", "build_plane_state",
           "pair_tables", "plane_state_from_numpy", "shifted_cells"]

#: pair rows built per device step (bounds the build's extra memory to
#: one chunk of rows)
_PAIR_CHUNK = 1 << 16


@dataclasses.dataclass
class PlaneState:
    plane: torch.Tensor  # f32 (n_keys + 1 + n_pairs, plane_w); row n_keys is zero
    combo: torch.Tensor  # int32 (4**(k+1) + 4**k + 1,) slot -> plane row
    n_keys: int

    @property
    def n_pairs(self) -> int:
        return self.plane.shape[0] - self.n_keys - 1

    @property
    def nbytes(self) -> int:
        return (self.plane.numel() * self.plane.element_size()
                + self.combo.numel() * self.combo.element_size())


def plane_state_from_numpy(plane: np.ndarray, combo: np.ndarray, *, n_keys: int,
                           device) -> PlaneState:
    """State from host arrays, e.g. ``np.asarray(JaxPlacer._plane_s)`` and
    ``np.asarray(JaxPlacer._dev_combo)``."""
    if plane.dtype != np.float32 or plane.ndim != 2 or plane.shape[0] <= n_keys:
        raise ValueError(f"plane must be f32 (> {n_keys} rows, width), got "
                         f"{plane.dtype} {plane.shape}")
    # "W": arrays viewed from JAX buffers are read-only; torch needs a copy
    return PlaneState(
        plane=torch.from_numpy(np.require(plane, requirements=["C", "W"])).to(device),
        combo=torch.from_numpy(np.require(combo, np.int32, ["C", "W"])).to(device),
        n_keys=n_keys,
    )


def pair_tables(db, k: int):
    """(pu, pv, combo) for ``db``: the pair rows' two base rows and the
    slot-row table that resolves every 2-window slot in one gather."""
    n_keys = db.num_kmers
    direct = direct_table(db.keys, k, n_keys)
    pu, pv, key11 = enumerate_pairs(db.keys, k, direct, n_keys)
    direct11 = np.full(4 ** (k + 1), -1, dtype=np.int32)
    direct11[key11] = n_keys + 1 + np.arange(pu.shape[0], dtype=np.int32)
    return pu, pv, build_combo_table(direct, direct11, k, n_keys)


def shifted_cells(db, log_eps: np.float32):
    """(row, branch, value) of every present plane cell: the stored score
    shifted by -log10(eps), nudged to 1e-37 where it would not stay > 0."""
    lens = np.diff(db.row_off).astype(np.int64)
    rows = np.repeat(np.arange(db.num_kmers, dtype=np.int64), lens)
    sp = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)
    return rows, db.branches.astype(np.int64), np.where(sp <= 0.0, np.float32(1e-37), sp)


def build_plane_state(db, *, k: int, B: int, log_eps: np.float32, pu, pv, combo,
                      device) -> PlaneState:
    """Build the combined plane on ``device`` (see the module docstring)."""
    n_keys = db.num_kmers
    n_pairs = int(pu.shape[0])
    plane_w = -(-B // 128) * 128
    plane = torch.zeros((n_keys + 1 + n_pairs, plane_w), dtype=torch.float32,
                        device=device)
    rows, br, vals = shifted_cells(db, log_eps)
    plane.index_put_((torch.from_numpy(rows).to(device), torch.from_numpy(br).to(device)),
                     torch.from_numpy(vals).to(device))
    pu_t = torch.from_numpy(pu.astype(np.int64)).to(device)
    pv_t = torch.from_numpy(pv.astype(np.int64)).to(device)
    for s in range(0, n_pairs, _PAIR_CHUNK):
        e = min(s + _PAIR_CHUNK, n_pairs)
        base = n_keys + 1
        plane[base + s : base + e] = (plane.index_select(0, pu_t[s:e])
                                      + plane.index_select(0, pv_t[s:e]))
    return PlaneState(plane=plane,
                      combo=torch.from_numpy(combo).to(device), n_keys=n_keys)


@dataclasses.dataclass
class CsrState:
    table: torch.Tensor  # int64 (nb, 16) packed cuckoo table, uint32 words
    seed1: int
    seed2: int
    post_b: torch.Tensor  # int32 (n_postings,) branch ids (>= 1 entry)
    post_s: torch.Tensor  # f32 (n_postings,) stored scores
    row_off: torch.Tensor  # int64 (n_keys + 1,) CSR offsets


def build_csr_state(db, *, device) -> CsrState:
    """The cuckoo table and postings of ``db`` on ``device``. An empty
    database gets one dummy posting, so clamped gathers stay in range; no
    lookup ever reaches it."""
    n = db.num_kmers
    lens = np.diff(db.row_off)
    table = build_table(db.keys, np.arange(n, dtype=np.uint32), lens)
    post_b = db.branches.astype(np.int32)
    post_s = db.scores.astype(np.float32)
    if post_b.size == 0:
        post_b, post_s = np.zeros(1, np.int32), np.zeros(1, np.float32)
    return CsrState(
        table=table.to_device(device), seed1=table.seed1, seed2=table.seed2,
        post_b=torch.from_numpy(post_b).to(device),
        post_s=torch.from_numpy(np.require(post_s, requirements=["C", "W"])).to(device),
        row_off=torch.from_numpy(db.row_off.astype(np.int64)).to(device))
