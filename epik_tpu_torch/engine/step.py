"""The port's device steps, from ``epik_tpu/engine/placer.py``:

* :func:`place_batch_dense_paired` -- ``_place_batch_dense_paired``
  (:694-736), the default dense pair-plane step;
* :func:`place_batch_dense_bytes` -- ``_place_batch_dense_bytes``
  (:623-685), the unpaired dense step with the device tokenizer, over the
  shifted (f32 or int16) or the classic (f32 or bf16) plane;
* :func:`place_batch_dense_rows` -- ``_place_batch_dense_rows`` (:565-613),
  the same with plane rows resolved on the host;
* :func:`place_batch_dense_codes` -- ``_place_batch_dense_codes``
  (:1306-1361), the generic-alphabet (amino, DNA k >= 14) shifted step: the
  codes tokenizer and the radix lookup on the device;
* :func:`place_batch_dense_codes_paired` -- ``_place_batch_dense_codes_paired``
  (:1372-1458), the same over the codes pair plane;
* :func:`place_batch_device_densedb` -- ``_place_batch_device_densedb``
  (:501-557), the classic plane with the keys resolved on the device through
  the cuckoo table;
* :func:`place_batch_tiles_bytes` -- ``_place_batch_tiles_bytes``
  (:1088-1203), the big-tree posting-tile step, both payloads;
* :func:`place_batch_tiles_paired` -- ``_place_batch_tiles_paired``
  (:1213-1266), the pair-fused posting-tile step (one 2*PT pair row per two
  windows, kernel 3 whole);
* :func:`place_batch_csr` -- ``_place_batch_device`` (:241), the CSR step:
  with ``dense=True`` (per-read posting cells) or, with ``flat``, the
  scatter engine's flat posting budget (``accumulate="scatter"``).

The dense steps take their gather as one value, decided once by the placer
(:func:`dense_gather`). The shifted ones end in kernel 1 with the finish
fused in (the slim (R, 2K+3) pack), or past its width rule or its
shared-memory limit in the gather over the plane's posted cells with the
finish fused in, where the state holds them (:class:`PostedGather`), else in
the gather and the finish apart; the classic ones in kernel
1 with counts and the counts finish fused in (the full (R+1, 4K+2) pack), or
past its limit in the gather with counts and the counts finish apart; the
CSR step in kernel 4 with counts (or its row-pointer form over the flat
cells) and the counts finish (``finish_topk_counts``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.accumulate_packed import accumulate_packed_topk, tile_width
from ..kernels.accumulate_sums import accumulate_sums
from ..kernels.finish import finish_topk, finish_topk_counts
from ..kernels.rowgather import (
    add_first_hits,
    counts_topk_fits,
    posted_topk_fits,
    rowgather_sum,
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_counts_topk,
    rowgather_sum_counts_topk_bf16,
    rowgather_sum_posted,
    rowgather_sum_posted_topk,
    rowgather_sum_topk,
    rowgather_sum_topk_int16,
    shifted_fused,
    topk_fits,
)
from ..kernels.tokenize import tokenize_combo_fused
from ..ops.csr import (
    ORDER_INF,
    accumulate_amb_firsthit,
    append_totals,
    exact_postings,
)
from ..ops.dense import amb_classic_deltas, amb_deltas, lookup_rows
from ..ops.tokenize import (
    tokenize_packed,
    tokenize_paired,
    tokenize_radix,
    tokenize_radix_paired,
)
from .outputs import U64
from .state import PostedCells

__all__ = ["PostedGather", "dense_gather", "place_batch_csr", "place_batch_dense_bytes",
           "place_batch_dense_codes", "place_batch_dense_codes_paired",
           "place_batch_dense_paired", "place_batch_dense_rows",
           "place_batch_device_densedb", "place_batch_tiles_bytes",
           "place_batch_tiles_paired", "sums_bytes", "window_counts"]

#: tile cells per read are padded with trash to a multiple of one warp's chunk
_PP_ALIGN = 32


def window_counts(lens: torch.Tensor, k: int) -> torch.Tensor:
    """The correction term's window count m of each read as f32,
    size_t-wrapped (quirk Q1): a read shorter than k has m = 2**64 +
    m_signed, which f32 rounds to 2**64."""
    m_signed = (lens - (k - 1)).to(torch.float32)
    return torch.where(m_signed >= 0, m_signed, m_signed + float(U64))


@dataclasses.dataclass(frozen=True, eq=False)
class PostedGather:
    """The dense gather over a shifted f32 plane's posted cells ``cells``:
    with ``fused``, the finish fused into it (``rowgather_sum_posted_topk``),
    else ``rowgather_sum_posted`` and ``finish_topk`` apart."""

    cells: PostedCells
    fused: bool

    @property
    def note(self) -> str:
        """The ``gather`` the ``place`` span notes."""
        return "posted_fused" if self.fused else "posted"


def dense_gather(plane, B: int, K: int, *, shifted: bool, posted=None):
    """The gather of every dense step over ``plane``, decided once from the
    plane's width, B, K and its device: ``"fused"``, a kernel with the
    finish fused in, on the shifted plane where the width rule takes #1
    (``shifted_fused``) and its shared memory fits (``topk_fits``), on the
    classic plane where the counts kernel's fits (``counts_topk_fits``);
    else, where the plane's posted cells ``posted`` are given (a shifted f32
    plane's :class:`~.state.PostedCells`), a :class:`PostedGather`, the
    finish fused into the posted gather where its shared memory fits at the
    width and B (``posted_topk_fits``) and apart past it; else
    ``"rows"``: the gather apart over the plane's rows (1d, or the gather
    with counts on the classic plane). The steps take this value as
    ``gather``."""
    fused = (shifted_fused(plane.shape[1]) and topk_fits(plane, B, K) if shifted
             else counts_topk_fits(plane, B, K))
    if fused:
        return "fused"
    if posted is None:
        return "rows"
    return PostedGather(posted, posted_topk_fits(plane.shape[1], B, plane.device))


def sums_bytes(plane, R: int, *, shifted: bool) -> int:
    """Bytes of the (R, bw) intermediate that the gather writes and the
    finish reads back where they run apart: f32 sums, and on the classic
    plane int32 counts beside them."""
    return R * plane.shape[1] * (4 if shifted else 8)


def place_batch_dense_paired(plane, combo, buf, arows, *, B: int, K: int, Amax: int,
                             k: int, Lmax: int, num_kmers: int, log_eps: float,
                             eps: float, gather) -> torch.Tensor:
    """Dense shifted step over the pair plane: the slot tokenizer's one
    kernel (rows and window counts, ``tokenize_combo_fused``), the ambiguous
    first-hit delta rows when ``Amax > 0``, then kernel 1 with the delta add
    and the finish fused in, or its unfused pair, as ``gather`` says
    (``_shifted_finish``; the pair rows in batch order: a read order that
    groups shared plane rows bought them no L2 reuse on the H100, PERF.md).
    Returns the slim (R, 2K+3) f32 pack on the plane's device."""
    rows, _, m_f32 = tokenize_combo_fused(buf, combo, k=k, Lmax=Lmax)
    return _shifted_finish(plane, rows, m_f32, arows, B=B, K=K, Amax=Amax, k=k,
                           zero_row=num_kmers, log_eps=log_eps, eps=eps, pair_rows=True,
                           gather=gather)


def _shifted_finish(plane, rows, m_f32, arows, *, B: int, K: int, Amax: int, k: int,
                    zero_row: int, log_eps: float, eps: float, gather,
                    plane_scale: float = 1.0, pair_rows: bool = False) -> torch.Tensor:
    """The shifted plane's sums (an int16 plane's dequantized by
    ``plane_scale``), the ambiguous reads' delta rows when ``Amax > 0``, and
    the finish, into the slim pack, through the gather of
    :func:`dense_gather`: ``"fused"``, kernel 1 with the finish fused in; a
    fused :class:`PostedGather`, the posted gather with the delta add and the
    finish fused in (``rowgather_sum_posted_topk``); else the gather, the
    delta add (the same f32 add) and ``finish_topk`` apart, the sums from the
    plane's rows (``"rows"``, ``rowgather_sum``) or from its posted cells (a
    :class:`PostedGather` apart, ``rowgather_sum_posted``, the same bits).
    ``pair_rows``: the rows are the pair plane's, which #1 and 1d take in read
    order."""
    quant = plane.dtype == torch.int16
    scale = plane_scale if quant else None
    amb_read = delta = None
    if Amax > 0:
        amb_read, delta = amb_deltas(plane, arows, zero_row=zero_row, B=B, k=k, eps=eps,
                                     log_eps=log_eps, plane_scale=plane_scale)
    kw = dict(B=B, K=K, k=k, log_eps=log_eps, pair_rows=pair_rows)
    if gather == "fused":
        if quant:
            return rowgather_sum_topk_int16(plane, rows, m_f32, amb_read, delta, scale=scale,
                                            **kw)
        return rowgather_sum_topk(plane, rows, m_f32, amb_read, delta, **kw)
    if gather == "rows":
        Sp = rowgather_sum(plane, rows, scale=scale, pair_rows=pair_rows)
    else:
        p, bw = gather.cells, plane.shape[1]
        if gather.fused:
            return rowgather_sum_posted_topk(p.off, p.cells, rows, m_f32, amb_read, delta, bw=bw,
                                             B=B, K=K, k=k, log_eps=log_eps)
        Sp = rowgather_sum_posted(p.off, p.cells, rows, bw=bw)
    if amb_read is not None and amb_read.numel() > 0:
        Sp[amb_read, :B] = Sp[amb_read, :B] + delta
    return finish_topk(Sp[:, :B], m_f32, K=K, k=k, log_eps=log_eps)


def _classic_finish(plane, rows, m_f32, arows, *, B: int, K: int, Amax: int, k: int,
                    zero_row: int, log_eps: float, eps: float, gather: str) -> torch.Tensor:
    """The classic plane's sums S and exact counts C (an f32 or a bf16
    plane), the ambiguous first hit when ``Amax > 0``, and the counts finish,
    into the full (R+1, 4K+2) pack with zero totals: with ``gather``
    ``"fused"`` kernel 1 with counts and the finish fused in, with ``"rows"``
    (past its shared-memory limit, :func:`dense_gather`) the gather with
    counts, the same adds of the first hit and ``finish_topk_counts``
    apart."""
    bf16 = plane.dtype == torch.bfloat16
    amb_read = dS = hit = None
    if Amax > 0:
        amb_read, dS, hit = amb_classic_deltas(plane, arows, zero_row=zero_row, B=B, k=k,
                                               eps=eps)
    kw = dict(K=K, k=k, log_eps=log_eps)
    if gather == "fused":
        fused = rowgather_sum_counts_topk_bf16 if bf16 else rowgather_sum_counts_topk
        return append_totals(fused(plane, rows, m_f32, amb_read, dS, hit, B=B, **kw), 0, 0)
    S, C = (rowgather_sum_counts_bf16 if bf16 else rowgather_sum_counts)(plane, rows)
    S, C = add_first_hits(S[:, :B], C[:, :B], amb_read, dS, hit)
    return append_totals(finish_topk_counts(S, C, m_f32, **kw), 0, 0)


def place_batch_dense_bytes(plane, direct, buf, arows, *, B: int, K: int, Amax: int, k: int,
                            Lmax: int, num_kmers: int, log_eps: float, eps: float,
                            shifted: bool, gather, plane_scale: float = 1.0) -> torch.Tensor:
    """Unpaired dense step: the device tokenizer through the direct key ->
    row table (one row per window, the miss row ``num_kmers``), then the
    shifted or the classic sums and finish. Returns the slim (R, 2K+3) pack
    (shifted) or the full (R+1, 4K+2) pack (classic) on the plane's device.
    JAX pads the rows to a multiple of 16 with the zero row; that adds
    nothing to a sum, so the port does not."""
    rows, lens = tokenize_packed(buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers)
    return place_batch_dense_rows(plane, rows, arows, window_counts(lens, k), B=B, K=K, Amax=Amax,
                                  k=k, zero_row=num_kmers, log_eps=log_eps, eps=eps,
                                  shifted=shifted, gather=gather, plane_scale=plane_scale)


def place_batch_dense_codes(plane, radix, buf, arows, *, B: int, K: int, Amax: int, k: int,
                            sigma: int, Lmax: int, num_kmers: int, log_eps: float,
                            eps: float, gather, plane_scale: float = 1.0) -> torch.Tensor:
    """Generic-alphabet dense step over the shifted plane (f32, or int16
    dequantized by ``plane_scale``): the codes tokenizer and the radix lookup
    (``radix``, a :class:`~..ops.radix_lookup.DeviceRadix`; a miss and a bad
    window take the zero row ``num_kmers``), then the shifted sums, the
    ambiguous delta rows and the finish (``_shifted_finish``). Returns the
    slim (R, 2K+3) pack."""
    rows, lens = tokenize_radix(buf, radix, k=k, sigma=sigma, Lmax=Lmax, num_kmers=num_kmers)
    return _shifted_finish(plane, rows, window_counts(lens, k), arows, B=B, K=K, Amax=Amax, k=k,
                           zero_row=num_kmers, log_eps=log_eps, eps=eps, gather=gather,
                           plane_scale=plane_scale)


def place_batch_dense_codes_paired(plane, radix, pair_radix, buf, arows, *, B: int, K: int,
                                   Amax: int, k: int, sigma: int, Lmax: int, num_kmers: int,
                                   n_pairs: int, log_eps: float, eps: float,
                                   gather) -> torch.Tensor:
    """Generic-alphabet dense step over the codes pair plane (shifted f32):
    one plane row per two windows (``tokenize_radix_paired``: a pair row found
    by ``pair_radix``, else the hitting window's row), then the shifted sums,
    the ambiguous delta rows and the finish. Returns the slim (R, 2K+3)
    pack."""
    rows, lens = tokenize_radix_paired(buf, radix, pair_radix, k=k, sigma=sigma, Lmax=Lmax,
                                       num_kmers=num_kmers, n_pairs=n_pairs)
    return _shifted_finish(plane, rows, window_counts(lens, k), arows, B=B, K=K, Amax=Amax, k=k,
                           zero_row=num_kmers, log_eps=log_eps, eps=eps, pair_rows=True,
                           gather=gather)


def place_batch_dense_rows(plane, rows, arows, m_f32, *, B: int, K: int, Amax: int, k: int,
                           zero_row: int, log_eps: float, eps: float, shifted: bool,
                           gather, plane_scale: float = 1.0) -> torch.Tensor:
    """Dense step over plane rows resolved on the host (int32 (R, Wmax),
    padding and misses on ``zero_row``) and the host's window counts
    ``m_f32``: the shifted or the classic sums and finish (the slim or the
    full pack) through ``gather`` (:func:`dense_gather`)."""
    kw = dict(B=B, K=K, Amax=Amax, k=k, zero_row=zero_row, log_eps=log_eps, eps=eps,
              gather=gather)
    if shifted:
        return _shifted_finish(plane, rows, m_f32, arows, plane_scale=plane_scale, **kw)
    return _classic_finish(plane, rows, m_f32, arows, **kw)


def place_batch_device_densedb(table, seed1: int, seed2: int, plane, e_hi, e_lo, a_hi,
                               a_lo, m_f32, *, B: int, K: int, k: int, zero_row: int,
                               log_eps: float, eps: float, gather: str) -> torch.Tensor:
    """Classic dense step with the keys resolved on the device: the window
    keys (R, Wmax) and the ambiguous keys (R, Amax) in processing order,
    sentinel-padded, through the cuckoo table (``ops/hashtable.py::lookup``,
    payload the plane row; a miss takes ``zero_row``), then the classic sums,
    the ambiguous first hit and the counts finish into the full pack
    (``gather``: :func:`dense_gather`)."""
    rows = lookup_rows(table, seed1, seed2, e_hi, e_lo, zero_row=zero_row)
    arows = lookup_rows(table, seed1, seed2, a_hi, a_lo, zero_row=zero_row)
    return _classic_finish(plane, rows, m_f32, arows, B=B, K=K, Amax=arows.shape[1], k=k,
                           zero_row=zero_row, log_eps=log_eps, eps=eps, gather=gather)


def _pad_trash(x: torch.Tensor, value) -> torch.Tensor:
    extra = -x.shape[1] % _PP_ALIGN
    if extra == 0:
        return x.contiguous()
    pad = torch.full((x.shape[0], extra), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def place_batch_tiles_bytes(tiles, direct, buf, tiles_ov=None, *, B: int, K: int,
                            k: int, Lmax: int, num_kmers: int, PT: int,
                            log_eps: float, packed: bool, scale: float = 1.0,
                            PT_OV: int = 0, OV: int = 0, N_OV: int = 0) -> torch.Tensor:
    """Posting-tile step: one tile-row gather per window, then

    * packed: the two-level overflow (when ``PT_OV > 0``: each window whose
      key has overflow postings -- tile row < ``N_OV`` -- adds overflow row
      ``row + 1``; the rows are compacted to ``OV`` per read, and each read's
      true overflow-window count is appended as a last column, so the host
      can retry with a bigger ``OV``) and kernel 3, the fused accumulate +
      finish, into the slim (R, 2K+3) pack;
    * f32: kernel 4 (sums) and kernel 2 (finish) into the slim pack.

    Reads with ambiguous characters are not handled here: the placer sends
    them to the CSR step."""
    rows, lens = tokenize_packed(buf, direct, k=k, Lmax=Lmax, num_kmers=num_kmers)
    m_f32 = window_counts(lens, k)
    R, W = rows.shape
    trash = tile_width(B) - 1
    g = tiles[rows.long()]  # (R, W, PT) packed, (R, W, 2*PT) f32 pairs
    if packed:
        g = g.reshape(R, W * PT)
        cnt_ov = None
        if PT_OV > 0:
            ovr = torch.where(rows < N_OV, rows + 1, 0)
            cnt_ov = (ovr > 0).sum(dim=1)
            # the order of the kept rows does not matter: the sums are integers
            sel = torch.topk(ovr, min(OV, W), dim=1).values
            g = torch.cat([g, tiles_ov[sel.long()].reshape(R, -1)], dim=1)
        pack = accumulate_packed_topk(_pad_trash(g, trash << 16), m_f32, B=B, K=K,
                                      k=k, log_eps=log_eps, scale=scale)
        if cnt_ov is not None:
            pack = torch.cat([pack, cnt_ov.to(torch.float32)[:, None]], dim=1)
        return pack
    g = g.reshape(R, W * PT, 2)
    b = _pad_trash(g[..., 0], trash)
    s = _pad_trash(g[..., 1], 0).view(torch.float32)
    Sp = accumulate_sums(b, s, B=B)
    return finish_topk(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def place_batch_tiles_paired(tiles, direct, direct11, buf, *, B: int, K: int, k: int,
                             Lmax: int, num_kmers: int, PT: int, log_eps: float,
                             scale: float) -> torch.Tensor:
    """Pair-fused posting-tile step (packed payload): the paired tokenizer
    (one tile row per 2-window slot: a pair row of 2*PT cells, the hitting
    window's row, or the miss row), one row gather per slot into (R,
    ceil(W/2) * 2*PT) cells, trash-padded, then kernel 3 whole into the slim
    (R, 2K+3) pack. No overflow plane, so no OV retry."""
    rows, lens = tokenize_paired(buf, direct, direct11, k=k, Lmax=Lmax, num_kmers=num_kmers)
    R, Wp = rows.shape
    g = tiles[rows.long()].reshape(R, Wp * 2 * PT)
    return accumulate_packed_topk(_pad_trash(g, (tile_width(B) - 1) << 16), window_counts(lens, k),
                                  B=B, K=K, k=k, log_eps=log_eps, scale=scale)


def place_batch_csr(table, seed1: int, seed2: int, post_b, post_s, row_off, e_hi, e_lo,
                    e_read, a_hi, a_lo, a_read, a_order, m_f32, *, R: int, B: int,
                    K: int, P: int, PA: int, k: int, log_eps: float, eps: float,
                    flat: bool = False) -> torch.Tensor:
    """CSR step: exact postings through per-read cells of budget ``P`` and
    kernel 4 with counts or, with ``flat``, through a flat budget of ``P``
    cells for the whole batch and kernel 4's row-pointer form; then the
    ambiguous first hit with budget ``PA`` and the counts finish
    (``finish_topk_counts``). Returns the (R+1, 4K+2) pack whose last row
    carries the largest per-read posting count (the batch's posting total
    with ``flat``) and the ambiguous posting total, so the host can retry
    with bigger budgets."""
    S, C, e_total = exact_postings(table, seed1, seed2, post_b, post_s, row_off, e_hi, e_lo,
                                   e_read, R=R, B=B, P=P, flat=flat)
    first, V, a_total = accumulate_amb_firsthit(table, seed1, seed2, post_b, post_s,
                                                row_off, a_hi, a_lo, a_read, a_order,
                                                R=R, B=B, PA=PA, k=k, eps=eps)
    hit = first < ORDER_INF
    S = S + torch.where(hit, V, torch.zeros((), dtype=V.dtype, device=V.device))
    C = C + hit.to(torch.int32)
    body = finish_topk_counts(S, C, m_f32, K=K, k=k, log_eps=log_eps)
    return append_totals(body, e_total, a_total)
