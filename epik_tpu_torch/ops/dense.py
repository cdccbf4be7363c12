"""The dense steps' ops around kernel 1, ported from ``epik_tpu/engine/placer.py``:
the ambiguous first-hit ``dense_amb_from_rows`` (:853), the contribution of
``_apply_amb`` (:814) for the shifted plane (delta rows, whose add runs in
kernel 1, ``kernels.rowgather.rowgather_sum_topk``) and for the classic plane
(:func:`amb_classic`, with the count), and the device cuckoo lookup of
``dense_exact_sums`` (:739) / ``dense_amb_firsthit`` (:837).
"""

from __future__ import annotations

import math

import torch

from ..kernels.rowgather import add_first_hits
from .hashtable import lookup

__all__ = ["ORDER_INF", "amb_classic", "amb_classic_deltas", "amb_deltas",
           "dense_amb_from_rows", "lookup_rows"]

#: "no ambiguous hit" marker for the first-order matrix (quirks Q6/Q7)
ORDER_INF = 2**31 - 1
#: reads per chunk of the ambiguous gather: keeps (reads, Amax, bw) f32
#: under ~256 MB whatever the batch
_AMB_CHUNK_BYTES = 256 << 20


def dense_amb_from_rows(plane: torch.Tensor, arows: torch.Tensor, *, B: int):
    """Ambiguous first-hit given plane row indices in processing order.

    Returns (first (R, B) int32, sel (R, B) f32): the first column whose row
    is nonzero at each branch (ORDER_INF when none) and that row's value
    (an int16 plane's still quantized)."""
    R, Amax = arows.shape
    g = plane[arows.long()][:, :, :B]  # (R, Amax, B): one gather serves both roles
    col = torch.arange(Amax, dtype=torch.int32, device=plane.device)[None, :, None]
    cand = torch.where(g != 0, col, torch.full_like(col, ORDER_INF))
    first = cand.min(dim=1).values
    # no hit: first is ORDER_INF and every gathered value is 0, so any column
    # yields sel == 0 like the JAX argmin-of-all-INF
    pick = first.clamp(max=Amax - 1).long()[:, None, :]
    sel = torch.gather(g, 1, pick)[:, 0, :].to(torch.float32)
    return first, sel


def _amb_contributions(plane: torch.Tensor, arows: torch.Tensor, *, zero_row: int, B: int,
                       k: int, eps: float, log_eps: float | None, plane_scale: float):
    """The reads with at least one ambiguous row (int64 (A,)) and, chunk by
    chunk of them, (hit (a, B) bool, V (a, B) f32): ``_apply_amb``'s
    contribution ``(10**s + (k-1)*eps) / k`` of each first hit, with ``s`` the
    selected cell (dequantized by ``plane_scale`` when it is not 1) plus
    ``log_eps`` on the shifted plane (``log_eps`` None: the classic plane)."""
    R, Amax = arows.shape
    reads = torch.nonzero((arows != zero_row).any(dim=1)).flatten()
    f32 = torch.float32
    dev = plane.device
    ln10 = torch.tensor(math.log(10.0), dtype=f32, device=dev)
    km1_eps = torch.tensor(float(k - 1), dtype=f32, device=dev) * torch.tensor(
        eps, dtype=f32, device=dev)
    k_t = torch.tensor(float(k), dtype=f32, device=dev)
    scale_t = torch.tensor(plane_scale, dtype=f32, device=dev)
    chunk = max(1, _AMB_CHUNK_BYTES // max(1, Amax * plane.shape[1] * 4))
    parts = []
    for s in range(0, reads.numel(), chunk):
        first, sel = dense_amb_from_rows(plane, arows[reads[s : s + chunk]], B=B)
        if plane_scale != 1.0:
            sel = sel / scale_t
        if log_eps is not None:
            sel = sel + torch.tensor(log_eps, dtype=f32, device=dev)
        V = (torch.exp(sel * ln10) + km1_eps) / k_t
        parts.append((first < ORDER_INF, V))
    return reads, parts


def amb_deltas(plane: torch.Tensor, arows: torch.Tensor, *, zero_row: int, B: int,
               k: int, eps: float, log_eps: float, plane_scale: float = 1.0):
    """The ambiguous first-hit contribution (quirks Q6/Q7) on the shifted
    plane, of the reads with at least one ambiguous row: (reads int64 (A,),
    delta f32 (A, B)), where ``_apply_amb(shifted=True)`` returns
    ``S + delta`` for those reads (and adds 0 to the others).

    The stored score is recovered as sel (/ plane_scale for an int16 plane)
    + log_eps and the contribution is shifted (V - log_eps), preserving
    S' = S - C*log_eps. The reads are gathered in chunks."""
    reads, parts = _amb_contributions(plane, arows, zero_row=zero_row, B=B, k=k, eps=eps,
                                      log_eps=log_eps, plane_scale=plane_scale)
    f32 = torch.float32
    log_eps_t = torch.tensor(log_eps, dtype=f32, device=plane.device)
    zero = torch.zeros((), dtype=f32, device=plane.device)
    deltas = [torch.where(hit, V - log_eps_t, zero) for hit, V in parts]
    delta = torch.cat(deltas) if deltas else torch.zeros((0, B), dtype=f32,
                                                         device=plane.device)
    return reads, delta


def amb_classic_deltas(plane: torch.Tensor, arows: torch.Tensor, *, zero_row: int, B: int,
                       k: int, eps: float):
    """The ambiguous first hit (quirks Q6/Q7) on the classic plane, of the
    reads with at least one ambiguous row: (reads int64 (A,), dS f32 (A, B),
    hit bool (A, B)), where ``_apply_amb(shifted=False)`` returns ``S + dS``
    and ``C + hit`` for those reads (and adds 0 to the others); ``dS`` is
    ``where(hit, V, 0)``. The reads are gathered in chunks."""
    reads, parts = _amb_contributions(plane, arows, zero_row=zero_row, B=B, k=k, eps=eps,
                                      log_eps=None, plane_scale=1.0)
    dev = plane.device
    if not parts:
        return (reads, torch.zeros((0, B), dtype=torch.float32, device=dev),
                torch.zeros((0, B), dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    hit = torch.cat([h for h, _ in parts])
    dS = torch.cat([torch.where(h, v, zero) for h, v in parts])
    return reads, dS, hit


def amb_classic(S: torch.Tensor, C: torch.Tensor, plane: torch.Tensor, arows: torch.Tensor,
                *, zero_row: int, B: int, k: int, eps: float):
    """``_apply_amb(shifted=False)`` on the classic plane's (S f32, C int32)
    (R, B) sums and counts: ``S + where(hit, V, 0)``, ``C + hit`` at the reads
    with an ambiguous row (every other read would add 0)."""
    return add_first_hits(S, C, *amb_classic_deltas(plane, arows, zero_row=zero_row, B=B, k=k,
                                                    eps=eps))


def lookup_rows(table: torch.Tensor, seed1: int, seed2: int, key_hi: torch.Tensor,
                key_lo: torch.Tensor, *, zero_row: int) -> torch.Tensor:
    """Keys (any shape) -> int32 plane rows through the cuckoo table whose
    payload is the key's row: misses, the padding sentinel included, take
    ``zero_row`` (``dense_exact_sums`` :752-753)."""
    found, row, _ = lookup(table, seed1, seed2, key_hi, key_lo)
    return torch.where(found, row, zero_row).to(torch.int32).contiguous()
