"""Ragged posting-list expansion into a fixed-size slot array, as torch ops.

Ports ``epik_tpu/ops/expand.py::ragged_expand`` (:33): the scatter-max of
window ids at their row starts and a cumulative max give each slot its
window; ``.at[pos].max(..., mode="drop")`` becomes ``scatter_reduce_("amax")``
into one extra drop slot, and ``lax.cummax`` becomes ``torch.cummax``.
"""

from __future__ import annotations

import torch

__all__ = ["ragged_expand"]


def ragged_expand(lens: torch.Tensor, budget: int):
    """Expand ragged rows into a flat slot array of ``budget`` slots.

    lens: int64 (W,) row lengths (>= 0). Returns (win int64 (budget,), the
    window of each slot, -1 past the total; elem int64 (budget,), the index
    within the window's list; total, a 0-dim tensor: the true number of
    postings -- the caller retries with a bigger budget when it exceeds it)."""
    dev = lens.device
    lens = lens.to(torch.int64)
    csum = torch.cumsum(lens, 0)
    starts = csum - lens
    total = csum[-1] if lens.numel() else torch.zeros((), dtype=torch.int64, device=dev)
    w = lens.shape[0]
    win_ids = torch.arange(1, w + 1, dtype=torch.int64, device=dev)
    # window-id marks at row starts; empty rows and starts past the budget
    # park in the drop slot `budget` (equal starts cannot collide otherwise)
    pos = torch.where((lens > 0) & (starts < budget), starts, budget)
    mark = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, pos, win_ids, "amax")
    win = torch.cummax(mark[:budget], 0).values - 1
    slot = torch.arange(budget, dtype=torch.int64, device=dev)
    in_range = slot < total
    win = torch.where(in_range, win, -1)
    elem = torch.where(in_range, slot - starts[win.clamp(min=0)], 0)
    return win, elem, total
