"""The placer's device state.

* The dense route: the plane, and the table the device tokenizer resolves
  keys with. :func:`build_plane_state` builds them from a database as
  ``epik_tpu/engine/placer.py`` does (:1892-2026), the width padded to a
  multiple of 128 and the all-zero row at ``n_keys``, in one of the planes
  of :func:`plane_cells`: shifted f32 ``s - log10(eps)`` with the
  ``sp <= 0 -> 1e-37`` presence nudge, and then either the pair rows (each
  the f32 sum of two base rows) after the zero row and the combo table, or
  the direct key -> row table; classic f32 ``s`` with the
  ``0.0 -> -1e-37`` nudge; classic bf16 with a further ``-1.2e-38`` nudge;
  shifted int16, ``rint(sp * 32000 / -log_eps)`` clipped to [1, 32000].
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
           "pair_tables", "plane_cells", "plane_state_from_numpy"]

#: pair rows built per device step (bounds the build's extra memory to
#: one chunk of rows)
_PAIR_CHUNK = 1 << 16
#: the plane's cell type per ``precision`` (int16 only on the shifted plane)
_DTYPES = {"exact": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16}


@dataclasses.dataclass
class PlaneState:
    #: f32, bf16 or int16 (n_keys + 1 [+ n_pairs], plane_w); row n_keys is zero
    plane: torch.Tensor
    #: the pair plane's int32 (4**(k+1) + 4**k + 1,) slot -> plane row table
    combo: torch.Tensor | None
    n_keys: int
    #: the unpaired device tokenizer's int32 (4**k,) key -> row table
    direct: torch.Tensor | None = None
    #: an int16 plane's quantization scale (cells = rint(shifted * scale))
    scale: float = 1.0

    @property
    def n_pairs(self) -> int:
        return self.plane.shape[0] - self.n_keys - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.plane, self.combo, self.direct) if t is not None)


def _writable(a: np.ndarray, dtype=None) -> torch.Tensor:
    # "W": arrays viewed from JAX buffers are read-only; torch needs a copy
    return torch.from_numpy(np.require(a, dtype, ["C", "W"]))


def plane_state_from_numpy(plane: np.ndarray, combo: np.ndarray | None = None, *,
                           n_keys: int, device, direct: np.ndarray | None = None,
                           scale: float = 1.0) -> PlaneState:
    """State from host arrays, e.g. ``np.asarray(JaxPlacer._plane_s)`` (f32,
    bf16 or int16) with ``np.asarray(JaxPlacer._dev_combo)`` (the pair plane)
    or ``np.asarray(JaxPlacer._dev_direct)`` (the unpaired device tokenizer),
    and ``JaxPlacer._plane_scale``."""
    if (plane.dtype.name not in ("float32", "bfloat16", "int16") or plane.ndim != 2
            or plane.shape[0] <= n_keys):
        raise ValueError(f"plane must be f32, bf16 or int16 (> {n_keys} rows, width), "
                         f"got {plane.dtype} {plane.shape}")
    if plane.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        plane_t = _writable(plane.view(np.int16)).view(torch.bfloat16)
    else:
        plane_t = _writable(plane)
    return PlaneState(
        plane=plane_t.to(device),
        combo=None if combo is None else _writable(combo, np.int32).to(device),
        n_keys=n_keys,
        direct=None if direct is None else _writable(direct, np.int32).to(device),
        scale=scale,
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


def plane_cells(db, log_eps: np.float32, *, shifted: bool, precision: str):
    """(row, branch, value, scale) of every present plane cell, as
    ``JaxPlacer`` fills its plane (placer.py:1897-1936):

    * shifted: the stored score shifted by -log10(eps), nudged to 1e-37
      where it would not stay > 0; with ``precision="int16"`` quantized to
      ``rint(value * scale)`` clipped to [1, 32000], ``scale = 32000 /
      -log10(eps)`` (else 1.0);
    * classic: the stored score, an exact 0.0 nudged to -1e-37, and with
      ``precision="bf16"`` a remaining 0.0 to -1.2e-38 (f32 values: the
      caller rounds them to bf16)."""
    lens = np.diff(db.row_off).astype(np.int64)
    rows = np.repeat(np.arange(db.num_kmers, dtype=np.int64), lens)
    scale = 1.0
    if shifted:
        sp = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)
        sc = np.where(sp <= 0.0, np.float32(1e-37), sp)
    else:
        sc = np.where(db.scores == 0.0, np.float32(-1e-37), db.scores).astype(np.float32)
    if precision == "bf16":
        sc = np.where(sc == 0.0, np.float32(-1.2e-38), sc)
    if shifted and precision == "int16":
        scale = 32000.0 / max(float(-log_eps), 1e-6)
        sc = np.clip(np.rint(sc.astype(np.float64) * scale), 1, 32000).astype(np.int16)
    return rows, db.branches.astype(np.int64), sc, scale


def build_plane_state(db, *, k: int, B: int, log_eps: np.float32, shifted: bool,
                      precision: str, pairs=None, direct: np.ndarray | None = None,
                      device) -> PlaneState:
    """Build the plane on ``device`` (see the module docstring): the cells of
    :func:`plane_cells` in (n_keys + 1, plane_w), and with ``pairs`` =
    (pu, pv, combo) from :func:`pair_tables` (the shifted f32 plane only)
    the pair rows after the zero row; ``direct`` (a :func:`~.tables.
    direct_table`) rides along for the unpaired device tokenizer."""
    n_keys = db.num_kmers
    n_pairs = 0 if pairs is None else int(pairs[0].shape[0])
    dtype = _DTYPES[precision] if precision != "int16" or shifted else torch.float32
    plane_w = -(-B // 128) * 128
    plane = torch.zeros((n_keys + 1 + n_pairs, plane_w), dtype=dtype, device=device)
    rows, br, vals, scale = plane_cells(db, log_eps, shifted=shifted, precision=precision)
    plane.index_put_((torch.from_numpy(rows).to(device), torch.from_numpy(br).to(device)),
                     torch.from_numpy(vals).to(device).to(dtype))
    combo = None
    if pairs is not None:
        pu, pv, combo = pairs
        pu_t = torch.from_numpy(pu.astype(np.int64)).to(device)
        pv_t = torch.from_numpy(pv.astype(np.int64)).to(device)
        for s in range(0, n_pairs, _PAIR_CHUNK):
            e = min(s + _PAIR_CHUNK, n_pairs)
            base = n_keys + 1
            plane[base + s : base + e] = (plane.index_select(0, pu_t[s:e])
                                          + plane.index_select(0, pv_t[s:e]))
        combo = torch.from_numpy(combo).to(device)
    return PlaneState(plane=plane, combo=combo, n_keys=n_keys,
                      direct=None if direct is None else torch.from_numpy(direct).to(device),
                      scale=scale)


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
