"""The yardstick of ``score_roofline_pct``: the least work a batch's
placement needs, whatever engine does it.

* bytes: 8 for each posting (branch id + score) of every distinct database
  k-mer that the batch's reads hit, plus one a base read in, plus 8 for each
  of the K placements a read gives out (edge id + likelihood);
* operations: one add for each posting of each hit window.

Only the exact windows are counted (the few one-ambiguity windows' expansions
are left out), which can only lower the count. The least time is the larger
of bytes over the card's bandwidth and operations over its float32 rate.
"""

from __future__ import annotations

import numpy as np

from .reference import CODE, SIGMA

#: published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W)
PEAKS = {"NVIDIA H100": {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12}}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of a card whose name starts with a known name, or None."""
    for name, peaks in PEAKS.items():
        if device_name.startswith(name):
            return peaks
    return None


def key_rows(keys: np.ndarray, k: int) -> np.ndarray | None:
    """The row of every possible key (-1 where the database has none), or
    None where the key space is too large for a table."""
    if SIGMA ** k > 1 << 28:  # k <= 14 for DNA
        return None
    table = np.full(SIGMA ** k, -1, np.int32)
    table[keys.astype(np.int64)] = np.arange(keys.size, dtype=np.int32)
    return table


def batch_work(buf: np.ndarray, off: np.ndarray, first: int, last: int, keys: np.ndarray,
               row_off: np.ndarray, k: int, K: int, table: np.ndarray | None = None
               ) -> tuple[int, int]:
    """(bytes, operations) of placing reads ``first`` .. ``last - 1``, which
    lie back to back in ``buf``; ``table`` is :func:`key_rows`."""
    lo, hi = int(off[first]), int(off[last])
    codes = CODE[buf[lo:hi]]
    n_win = codes.size - k + 1
    plen = np.diff(row_off)
    if n_win <= 0:
        return hi - lo + 8 * K * (last - first), 0
    bad = np.concatenate([[0], np.cumsum(codes >= SIGMA, dtype=np.int32)])
    ok = (bad[k:] - bad[:-k]) == 0
    # no window across two reads: the k - 1 starts before each read's end
    ends = off[first + 1:last] - lo
    across = (ends[:, None] - np.arange(1, k)[None, :]).ravel()
    ok[across[(across >= 0) & (across < n_win)]] = False
    digits = np.where(codes < SIGMA, codes, 0).astype(np.uint64 if table is None else np.uint32)
    wk = digits[:n_win].copy()
    for j in range(1, k):
        wk *= SIGMA
        wk += digits[j:j + n_win]
    wk = wk[ok]
    if table is not None:
        i = table[wk]
        i = i[i >= 0]
    else:
        i = np.minimum(np.searchsorted(keys, wk), keys.size - 1)
        i = i[keys[i] == wk]
    ops = int(plen[i].sum())
    seen = np.zeros(keys.size, bool)
    seen[i] = True
    nbytes = 8 * int(plen[seen].sum()) + (hi - lo) + 8 * K * (last - first)
    return nbytes, ops


def least_seconds(nbytes: float, ops: float, peaks: dict) -> tuple[float, str]:
    """The least time and what bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / peaks["bytes_per_s"]
    t_ops = ops / peaks["f32_flop_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
