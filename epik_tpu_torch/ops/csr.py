"""The CSR fallback's device work, ported from ``epik_tpu/engine/placer.py``.

* :func:`accumulate_exact_dense` (:306): cuckoo lookup of the exact window
  keys, per-read padded posting cells (one scatter-max, one cummax), and the
  segment accumulate with counts (kernel 4, ``accumulate_sums_counts``);
* :func:`accumulate_amb_firsthit` (:383): the ambiguous first hit (quirks
  Q6/Q7) through :func:`~.expand.ragged_expand`;
* :func:`finish_scores` (:464, with ``_lwr_topk`` :418): correction with
  exact counts, LWR over all branches, top-K;
* :func:`pack_outputs` (:1461, ``_totals_row`` :1484): the (R+1, 4K+2)
  result pack with the budget totals in its last row.

``.at[...].max/min(..., mode="drop")`` become ``scatter_reduce_`` into an
extra drop slot, ``lax.cummax`` becomes ``torch.cummax``, and the top-K is a
stable sort (ties to the lowest branch index).
"""

from __future__ import annotations

import math

import torch

from ..kernels.accumulate_packed import tile_width
from ..kernels.accumulate_sums import accumulate_sums_counts
from ..kernels.finish import POW10_ZERO, lwr_topk_plain
from .expand import ragged_expand
from .hashtable import lookup

__all__ = ["ORDER_INF", "U64", "accumulate_amb_firsthit", "accumulate_exact_dense",
           "finish_scores", "pack_outputs"]

#: "no ambiguous hit" marker for the first-order matrix
ORDER_INF = 2**31 - 1
U64 = float(1 << 64)


def accumulate_exact_dense(table, seed1: int, seed2: int, post_b, post_s, row_off,
                           e_hi, e_lo, e_read, *, R: int, B: int, PP: int):
    """Exact window postings laid out per read as (R, PP) cells and summed.

    ``e_read`` int64 (E,) is sorted; padding windows carry read id R. Cells
    past a read's postings, or past PP, hold the trash branch. Returns
    (S f32 (R, B), C int32 (R, B), max_count): a read with more than PP
    postings makes max_count > PP, and the caller retries with a bigger PP."""
    dev = e_read.device
    _, e_row, e_len = lookup(table, seed1, seed2, e_hi, e_lo)
    e_off = row_off[e_row]
    lens = e_len
    E = lens.shape[0]
    g = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(lens, 0)])
    # first window index of each read (padding windows use R)
    first_win = torch.searchsorted(e_read, torch.arange(R + 1, dtype=torch.int64,
                                                        device=dev))
    read_start = g[first_win]  # (R+1,)
    counts = read_start[1:] - read_start[:-1]  # postings per read
    max_count = counts.max()
    wstart = g[:-1] - read_start[e_read.clamp(0, R)]  # per-window column

    win_ids = torch.arange(1, E + 1, dtype=torch.int64, device=dev)
    droppable = (lens > 0) & (e_read < R) & (wstart < PP)
    pos = torch.where(droppable, e_read * PP + wstart, R * PP)
    mark = torch.zeros(R * PP + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, pos, win_ids, "amax")
    win = torch.cummax(mark[: R * PP].view(R, PP), 1).values - 1

    col = torch.arange(PP, dtype=torch.int64, device=dev)[None, :]
    valid = (col < counts[:, None]) & (win >= 0)
    sw = win.clamp(min=0)
    elem = col - wstart[sw]
    p_idx = (e_off[sw] + elem).clamp(0, post_b.shape[0] - 1)
    b_pad = torch.where(valid, post_b[p_idx], tile_width(B) - 1)
    s_pad = torch.where(valid, post_s[p_idx], 0.0)
    S, C = accumulate_sums_counts(b_pad.to(torch.int32).contiguous(),
                                  s_pad.contiguous(), B=B)
    return S, C, max_count


def accumulate_amb_firsthit(table, seed1: int, seed2: int, post_b, post_s, row_off,
                            a_hi, a_lo, a_read, a_order, *, R: int, B: int, PA: int,
                            k: int, eps: float):
    """Ambiguous path (quirks Q6/Q7). Returns per (read, branch):
    first int64 (R, B), the least processing order of a posting hitting it
    (ORDER_INF when none); V f32 (R, B), that posting's contribution
    (10**score + (k-1)*eps) / k; and a_total, the true number of ambiguous
    postings (the caller retries when it exceeds PA)."""
    dev = a_read.device
    f32 = torch.float32
    _, a_row, a_len = lookup(table, seed1, seed2, a_hi, a_lo)
    a_off = row_off[a_row]
    awin, aelem, a_total = ragged_expand(a_len, PA)
    avalid = awin >= 0
    asw = awin.clamp(min=0)
    ap_idx = (a_off[asw] + aelem).clamp(0, post_b.shape[0] - 1)
    ab = post_b[ap_idx].to(torch.int64)
    as_ = post_s[ap_idx]
    ar = torch.where(avalid, a_read[asw], R)
    aord = torch.where(avalid, a_order[asw], ORDER_INF)
    flat = ar * B + ab
    first = torch.full(((R + 1) * B,), ORDER_INF, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, flat, aord, "amin")
    sel = avalid & (aord == first[flat])
    eps_t = torch.tensor(eps, dtype=f32, device=dev)
    pow10 = torch.exp(as_ * torch.tensor(math.log(10.0), dtype=f32, device=dev))
    contrib = ((pow10 + torch.tensor(float(k - 1), dtype=f32, device=dev) * eps_t)
               / torch.tensor(float(k), dtype=f32, device=dev))
    # one selected posting per (read, branch): every other add is + 0.0
    V = torch.zeros((R + 1) * B, dtype=f32, device=dev)
    V.index_add_(0, flat, torch.where(sel, contrib, torch.zeros((), dtype=f32, device=dev)))
    return first.view(R + 1, B)[:R], V.view(R + 1, B)[:R], a_total


def finish_scores(S, C, m_f32, *, K: int, k: int, log_eps: float):
    """Correction with exact counts + LWR + top-K on the merged (R, B)
    sums and counts. Returns (scores, idx, counts, wr, n, zero_sum) with the
    top-K columns (R, K)."""
    dev = S.device
    f32 = torch.float32
    log_eps_t = torch.tensor(log_eps, dtype=f32, device=dev)
    touched = C > 0
    # size_t wraparound emulation: C > m only happens via ambiguity fan-out;
    # float32(2**64 - small) == float32(2**64) (quirk Q1 family)
    diff = m_f32[:, None] - C.to(f32)
    diff = torch.where(diff < 0, torch.tensor(U64, dtype=f32, device=dev), diff)
    corrected = torch.where(touched,
                            (S + diff * log_eps_t) / torch.tensor(float(k), dtype=f32,
                                                                  device=dev),
                            torch.tensor(-math.inf, dtype=f32, device=dev))
    scores, idx, n, log_sum, zero_sum = lwr_topk_plain(corrected, touched, m_f32,
                                                       K=K, k=k, log_eps=log_eps)
    counts = torch.gather(C, 1, idx)
    ln10 = torch.tensor(math.log(10.0), dtype=f32, device=dev)
    wr = torch.exp((scores - log_sum[:, None]) * ln10)
    wr = torch.where(zero_sum[:, None] | (scores < POW10_ZERO),
                     torch.zeros((), dtype=f32, device=dev), wr)
    return scores, idx, counts, wr, n, zero_sum


def pack_outputs(outs, e_total, a_total) -> torch.Tensor:
    """All step outputs in ONE (R+1, 4K+2) f32 tensor: [scores K | wr K |
    idx K | counts K | n | zero_sum], then a row holding the budget totals
    in 20-bit halves (a single f32 rounds above 2**24 and could round a true
    overflow down to the budget). Host decoder: ``outputs.unpack_outputs``."""
    scores, idx, counts, wr, n, zero_sum = outs
    f32 = torch.float32
    body = torch.cat([scores, wr, idx.to(f32), counts.to(f32), n.to(f32)[:, None],
                      zero_sum.to(f32)[:, None]], dim=1)
    e_t = e_total.to(torch.int64)
    a_t = a_total.to(torch.int64)
    totals = torch.zeros((1, body.shape[1]), dtype=f32, device=body.device)
    totals[0, :4] = torch.stack([e_t >> 20, e_t & 0xFFFFF, a_t >> 20,
                                 a_t & 0xFFFFF]).to(f32)
    return torch.cat([body, totals], dim=0)
