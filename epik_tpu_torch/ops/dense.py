"""The dense step's ops around kernel 1, ported from ``epik_tpu/engine/placer.py``:
the ambiguous first-hit ``dense_amb_from_rows`` (:853) and the delta rows
``_apply_amb`` (:814, shifted branch) adds (the add itself runs in kernel 1,
``kernels.rowgather.rowgather_sum_topk``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["ORDER_INF", "amb_deltas", "dense_amb_from_rows"]

#: "no ambiguous hit" marker for the first-order matrix (quirks Q6/Q7)
ORDER_INF = 2**31 - 1
#: reads per chunk of the ambiguous gather: keeps (reads, Amax, bw) f32
#: under ~256 MB whatever the batch
_AMB_CHUNK_BYTES = 256 << 20


def dense_amb_from_rows(plane: torch.Tensor, arows: torch.Tensor, *, B: int):
    """Ambiguous first-hit given plane row indices in processing order.

    Returns (first (R, B) int32, sel (R, B) f32): the first column whose row
    is nonzero at each branch (ORDER_INF when none) and that row's value."""
    R, Amax = arows.shape
    g = plane[arows.long()][:, :, :B]  # (R, Amax, B): one gather serves both roles
    col = torch.arange(Amax, dtype=torch.int32, device=plane.device)[None, :, None]
    cand = torch.where(g != 0, col, torch.full_like(col, ORDER_INF))
    first = cand.min(dim=1).values
    # no hit: first is ORDER_INF and every gathered value is 0, so any column
    # yields sel == 0 like the JAX argmin-of-all-INF
    pick = first.clamp(max=Amax - 1).long()[:, None, :]
    sel = torch.gather(g, 1, pick)[:, 0, :]
    return first, sel


def amb_deltas(plane: torch.Tensor, arows: torch.Tensor, *, zero_row: int, B: int,
               k: int, eps: float, log_eps: float):
    """The ambiguous first-hit contribution (quirks Q6/Q7) of the reads with
    at least one ambiguous row: (reads int64 (A,), delta f32 (A, B)), where
    ``_apply_amb(shifted=True)`` returns ``S + delta`` for those reads (and
    adds 0 to the others).

    The stored score is recovered as sel + log_eps and the contribution is
    shifted (V - log_eps), preserving S' = S - C*log_eps. The reads are
    gathered in chunks."""
    R, Amax = arows.shape
    reads = torch.nonzero((arows != zero_row).any(dim=1)).flatten()
    f32 = torch.float32
    dev = plane.device
    log_eps_t = torch.tensor(log_eps, dtype=f32, device=dev)
    ln10 = torch.tensor(math.log(10.0), dtype=f32, device=dev)
    km1_eps = torch.tensor(float(k - 1), dtype=f32, device=dev) * torch.tensor(
        eps, dtype=f32, device=dev)
    k_t = torch.tensor(float(k), dtype=f32, device=dev)
    chunk = max(1, _AMB_CHUNK_BYTES // max(1, Amax * plane.shape[1] * 4))
    deltas = []
    for s in range(0, reads.numel(), chunk):
        first, sel = dense_amb_from_rows(plane, arows[reads[s : s + chunk]], B=B)
        hit = first < ORDER_INF
        pow10 = torch.exp((sel + log_eps_t) * ln10)
        V = (pow10 + km1_eps) / k_t
        deltas.append(torch.where(hit, V - log_eps_t, torch.zeros((), dtype=f32, device=dev)))
    delta = torch.cat(deltas) if deltas else torch.zeros((0, B), dtype=f32, device=dev)
    return reads, delta
