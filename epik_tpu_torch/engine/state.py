"""The placer's device state.

* The dense route: the plane, and the table the device tokenizer resolves
  keys with. :func:`build_plane_state` builds them from a database as
  ``epik_tpu/engine/placer.py`` does (:1892-2026), the width padded to a
  multiple of 128 and the all-zero row at ``n_keys``, in one of the planes
  of :func:`plane_cells`: shifted f32 ``s - log10(eps)`` with the
  ``sp <= 0 -> 1e-37`` presence nudge, and then either the pair rows (each
  the f32 sum of two base rows) after the zero row and the combo table, or
  the direct key -> row table (DNA, k <= 13), or the radix index over the
  keys (``ops/radix_lookup.py``: amino, DNA k >= 14) and, with the pair
  plane, the pair rows and the radix index over their (k+1)-mer keys; classic f32 ``s`` with the
  ``0.0 -> -1e-37`` nudge; classic bf16 with a further ``-1.2e-38`` nudge;
  shifted int16, ``rint(sp * 32000 / -log_eps)`` clipped to [1, 32000].
  :func:`plane_state_from_numpy` takes the JAX placer's own arrays instead,
  so tests can feed both engines the same state. :func:`build_plane_shard`
  builds one model shard of the column-sharded f32 plane (the sharded
  placer's dense route) from the same cells. :func:`posted_index` reads a
  shifted f32 plane's non-zero cells back into a row-compressed copy
  (:class:`PostedCells`) where the plane is sparse enough, for the gather
  that reads only them (``kernels/rowgather.py::rowgather_sum_posted``).
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
from ..ops.radix_lookup import DeviceRadix
from .tables import build_combo_table, direct_table, enumerate_pairs

__all__ = ["POSTED_MAX_SHARE", "CsrState", "PlaneState", "PostedCells", "build_csr_state",
           "build_plane_shard", "build_plane_state", "build_posted", "pair_tables",
           "plane_cells", "plane_state_from_numpy", "posted_index"]

#: pair rows built per device step (bounds the build's extra memory to
#: one chunk of rows)
_PAIR_CHUNK = 1 << 16
#: the plane's cell type per ``precision`` (int16 only on the shifted plane)
_DTYPES = {"exact": torch.float32, "bf16": torch.bfloat16, "int16": torch.int16}
#: plane cells the posted index's build reads a step (bounds its extra
#: memory to a chunk's mask and positions)
_POSTED_CHUNK_CELLS = 1 << 26
#: the largest share of a plane's cells posted for which the posted index is
#: built: its 8 bytes a cell then move at most a quarter of a plane row's
#: bytes, and in a genome-scale tree's plane (~12 postings a key over 21,248
#: columns) 0.056% are posted
POSTED_MAX_SHARE = 1 / 32


@dataclasses.dataclass
class PostedCells:
    """A plane's non-zero cells, row by row: row ``r``'s in
    ``cells[off[r]:off[r + 1]]``, in column order, an all-zero row's range
    empty."""

    #: int64 (n_rows + 1,)
    off: torch.Tensor
    #: int32 (nnz, 2): the column and the f32 value's bits
    cells: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.cells.shape[0]

    @property
    def nbytes(self) -> int:
        return self.off.numel() * 8 + self.cells.numel() * 4


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
    #: the codes tokenizer's key -> row index over the sorted keys
    radix: DeviceRadix | None = None
    #: with the codes pair plane: the (k+1)-mer pair key -> pair index
    #: (plane row n_keys + 1 + index) over the sorted pair keys
    pair_radix: DeviceRadix | None = None
    #: the shifted f32 plane's posted cells, where the unfused shifted steps
    #: gather through them (:func:`posted_index`)
    posted: PostedCells | None = None

    @property
    def n_pairs(self) -> int:
        return self.plane.shape[0] - self.n_keys - 1

    @property
    def nbytes(self) -> int:
        return (sum(t.numel() * t.element_size()
                    for t in (self.plane, self.combo, self.direct) if t is not None)
                + sum(r.nbytes for r in (self.radix, self.pair_radix, self.posted)
                      if r is not None))


def _writable(a: np.ndarray, dtype=None) -> torch.Tensor:
    # "W": arrays viewed from JAX buffers are read-only; torch needs a copy
    return torch.from_numpy(np.require(a, dtype, ["C", "W"]))


def plane_state_from_numpy(plane: np.ndarray, combo: np.ndarray | None = None, *,
                           n_keys: int, device, direct: np.ndarray | None = None,
                           scale: float = 1.0, radix: DeviceRadix | None = None,
                           pair_radix: DeviceRadix | None = None) -> PlaneState:
    """State from host arrays, e.g. ``np.asarray(JaxPlacer._plane_s)`` (f32,
    bf16 or int16) with ``np.asarray(JaxPlacer._dev_combo)`` (the pair plane)
    or ``np.asarray(JaxPlacer._dev_direct)`` (the unpaired device tokenizer),
    and ``JaxPlacer._plane_scale``; the codes tokenizer's ``radix`` (and
    ``pair_radix``) ride along as given."""
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
        scale=scale, radix=radix, pair_radix=pair_radix,
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
                      radix: DeviceRadix | None = None,
                      pair_radix: DeviceRadix | None = None, device) -> PlaneState:
    """Build the plane on ``device`` (see the module docstring): the cells of
    :func:`plane_cells` in (n_keys + 1, plane_w), and with ``pairs`` =
    (pu, pv, combo) from :func:`pair_tables` (the shifted f32 plane only)
    the pair rows after the zero row; ``direct`` (a :func:`~.tables.
    direct_table`) rides along for the unpaired device tokenizer, ``radix``
    for the codes tokenizer. The codes pair plane passes ``pairs`` = (pu, pv,
    None) from :func:`~.tables.enumerate_pairs_generic` with its
    ``pair_radix``."""
    dtype = _DTYPES[precision] if precision != "int16" or shifted else torch.float32
    rows, br, vals, scale = plane_cells(db, log_eps, shifted=shifted, precision=precision)
    plane = _fill_plane(db.num_kmers, rows, br, vals, width=-(-B // 128) * 128, dtype=dtype,
                        pairs=pairs, device=device)
    combo = None if pairs is None else pairs[2]
    return PlaneState(plane=plane,
                      combo=None if combo is None else torch.from_numpy(combo).to(device),
                      n_keys=db.num_kmers,
                      direct=None if direct is None else torch.from_numpy(direct).to(device),
                      scale=scale, radix=radix, pair_radix=pair_radix)


def build_plane_shard(db, *, col0: int, width: int, log_eps: np.float32, shifted: bool,
                      pairs=None, device) -> torch.Tensor:
    """One model shard of the column-sharded f32 plane on ``device``
    (``epik_tpu/parallel/sharding.py::shard_db_columns`` :105 and the pair
    rows of :903-939): the cells of :func:`plane_cells` (exact precision) whose
    branch lies in [col0, col0 + width), re-based to local columns, in
    (n_keys + 1, width) with the all-zero row at n_keys; with ``pairs`` =
    (pu, pv, combo) the pair rows after it, each the f32 sum of two base rows
    of this shard, i.e. the column slice of the global pair rows."""
    rows, br, vals, _ = plane_cells(db, log_eps, shifted=shifted, precision="exact")
    mine = (br >= col0) & (br < col0 + width)
    return _fill_plane(db.num_kmers, rows[mine], br[mine] - col0, vals[mine], width=width,
                       dtype=torch.float32, pairs=pairs, device=device)


def _fill_plane(n_keys: int, rows, cols, vals, *, width: int, dtype, pairs,
                device) -> torch.Tensor:
    """(n_keys + 1 [+ n_pairs], width) zeros on ``device`` holding ``vals`` at
    (rows, cols); with ``pairs`` = (pu, pv, ...) the pair rows after the zero
    row, built a chunk of rows at a time."""
    n_pairs = 0 if pairs is None else int(pairs[0].shape[0])
    plane = torch.zeros((n_keys + 1 + n_pairs, width), dtype=dtype, device=device)
    plane.index_put_((torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)),
                     torch.from_numpy(vals).to(device).to(dtype))
    if pairs is not None:
        pu_t = torch.from_numpy(pairs[0].astype(np.int64)).to(device)
        pv_t = torch.from_numpy(pairs[1].astype(np.int64)).to(device)
        base = n_keys + 1
        for s in range(0, n_pairs, _PAIR_CHUNK):
            e = min(s + _PAIR_CHUNK, n_pairs)
            plane[base + s : base + e] = (plane.index_select(0, pu_t[s:e])
                                          + plane.index_select(0, pv_t[s:e]))
    return plane


def _row_chunks(plane: torch.Tensor):
    step = max(1, _POSTED_CHUNK_CELLS // max(1, plane.shape[1]))
    for s in range(0, plane.shape[0], step):
        yield s, min(s + step, plane.shape[0])


def build_posted(plane: torch.Tensor, counts: torch.Tensor | None = None) -> PostedCells:
    """The non-zero cells of ``plane`` (f32), read back from it on its device
    a chunk of rows at a time, so the index and the plane cannot differ (the
    pair rows, the nudged cells and the zero row included); ``counts``, each
    row's number of them, where already counted."""
    if plane.dtype != torch.float32 or plane.dim() != 2:
        raise ValueError(f"the posted index is of an f32 plane, got {plane.dtype} "
                         f"{tuple(plane.shape)}")
    n_rows, dev = plane.shape[0], plane.device
    if counts is None:
        counts = _posted_counts(plane)
    off = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=off[1:])
    off_host = off.cpu()
    cells = torch.empty((int(off_host[-1]), 2), dtype=torch.int32, device=dev)
    for s, e in _row_chunks(plane):
        a, b = int(off_host[s]), int(off_host[e])
        if a == b:
            continue
        chunk = plane[s:e]
        at = torch.nonzero(chunk)  # (row, column), row-major: a row's in column order
        cells[a:b, 0] = at[:, 1]
        cells[a:b, 1] = chunk[at[:, 0], at[:, 1]].view(torch.int32)
    return PostedCells(off=off, cells=cells)


def _posted_counts(plane: torch.Tensor) -> torch.Tensor:
    counts = torch.empty(plane.shape[0], dtype=torch.int64, device=plane.device)
    for s, e in _row_chunks(plane):
        counts[s:e] = torch.count_nonzero(plane[s:e], dim=1)
    return counts


def posted_index(plane: torch.Tensor, *, budget: int) -> PostedCells | None:
    """The posted index of a shifted f32 ``plane`` (:func:`build_posted`)
    where at most ``POSTED_MAX_SHARE`` of its cells are posted and the index
    takes at most ``budget`` bytes, else None: a rule of the plane's width
    and density, as the plane shows them."""
    counts = _posted_counts(plane)
    nnz = int(counts.sum())
    if nnz > plane.numel() * POSTED_MAX_SHARE or (plane.shape[0] + 1 + nnz) * 8 > budget:
        return None
    return build_posted(plane, counts)


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
