"""The port's device steps, from ``epik_tpu/engine/placer.py``:

* :func:`place_batch_dense_paired` -- ``_place_batch_dense_paired``
  (:694-736), the default dense pair-plane step;
* :func:`place_batch_tiles_bytes` -- ``_place_batch_tiles_bytes``
  (:1088-1203), the big-tree posting-tile step, both payloads;
* :func:`place_batch_csr` -- ``_place_batch_device`` (:241) with
  ``dense=True``, the CSR fallback step.
"""

from __future__ import annotations

import torch

from ..kernels.accumulate_packed import accumulate_packed_topk, tile_width
from ..kernels.accumulate_sums import accumulate_sums
from ..kernels.finish import finish_topk
from ..kernels.rowgather import rowgather_sum_topk
from ..ops.csr import (
    ORDER_INF,
    accumulate_amb_firsthit,
    accumulate_exact_dense,
    finish_scores,
    pack_outputs,
)
from ..ops.dense import amb_deltas
from ..ops.tokenize import tokenize_combo, tokenize_packed
from .outputs import U64

__all__ = ["place_batch_csr", "place_batch_dense_paired", "place_batch_tiles_bytes"]

#: tile cells per read are padded with trash to a multiple of one warp's chunk
_PP_ALIGN = 32


def _m_f32(lens: torch.Tensor, k: int) -> torch.Tensor:
    """The correction term's window count, size_t-wrapped (quirk Q1): a read
    shorter than k has m = 2**64 + m_signed, which f32 rounds to 2**64."""
    m_signed = (lens - (k - 1)).to(torch.float32)
    return torch.where(m_signed >= 0, m_signed, m_signed + float(U64))


def place_batch_dense_paired(plane, combo, buf, arows, *, B: int, K: int, Amax: int,
                             k: int, Lmax: int, num_kmers: int, log_eps: float,
                             eps: float) -> torch.Tensor:
    """Dense shifted step over the pair plane: slot tokenizer, the ambiguous
    first-hit delta rows when ``Amax > 0``, then kernel 1 with the delta add
    and the finish fused in (``rowgather_sum_topk``, reads in batch order: a
    read order that groups shared plane rows bought no L2 reuse on the H100,
    PERF.md). Returns the slim (R, 2K+3) f32 pack on the plane's device."""
    rows, lens = tokenize_combo(buf, combo, k=k, Lmax=Lmax)
    m_f32 = _m_f32(lens, k)
    amb_read = delta = None
    if Amax > 0:
        amb_read, delta = amb_deltas(plane, arows, zero_row=num_kmers, B=B, k=k, eps=eps,
                                     log_eps=log_eps)
    return rowgather_sum_topk(plane, rows, m_f32, amb_read, delta, B=B, K=K, k=k,
                              log_eps=log_eps)


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
    m_f32 = _m_f32(lens, k)
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


def place_batch_csr(table, seed1: int, seed2: int, post_b, post_s, row_off, e_hi, e_lo,
                    e_read, a_hi, a_lo, a_read, a_order, m_f32, *, R: int, B: int,
                    K: int, P: int, PA: int, k: int, log_eps: float,
                    eps: float) -> torch.Tensor:
    """CSR step: exact postings through per-read cells of budget ``P`` and
    kernel 4 with counts, the ambiguous first hit with budget ``PA``, and the
    counts finish. Returns the (R+1, 4K+2) pack whose last row carries the
    largest per-read posting count and the ambiguous posting total, so the
    host can retry with bigger budgets."""
    S, C, e_total = accumulate_exact_dense(table, seed1, seed2, post_b, post_s,
                                           row_off, e_hi, e_lo, e_read, R=R, B=B, PP=P)
    first, V, a_total = accumulate_amb_firsthit(table, seed1, seed2, post_b, post_s,
                                                row_off, a_hi, a_lo, a_read, a_order,
                                                R=R, B=B, PA=PA, k=k, eps=eps)
    hit = first < ORDER_INF
    S = S + torch.where(hit, V, torch.zeros((), dtype=V.dtype, device=V.device))
    C = C + hit.to(torch.int32)
    outs = finish_scores(S, C, m_f32, K=K, k=k, log_eps=log_eps)
    return pack_outputs(outs, e_total, a_total)
