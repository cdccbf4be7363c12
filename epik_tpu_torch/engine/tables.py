"""Host-built lookup tables of the pair-plane paths, copied as numpy from
``epik_tpu/engine/placer.py`` (``enumerate_pairs`` :214,
``enumerate_pairs_generic`` :188, ``build_combo_table`` :1004)."""

from __future__ import annotations

import numpy as np

__all__ = ["build_combo_table", "direct_table", "enumerate_pairs", "enumerate_pairs_generic"]


def direct_table(keys: np.ndarray, k: int, n_keys: int) -> np.ndarray:
    """4**k int32 key -> plane row; absent keys map to the zero row n_keys."""
    direct = np.full(4**k, n_keys, dtype=np.int32)
    direct[keys.astype(np.int64)] = np.arange(n_keys, dtype=np.int32)
    return direct


def enumerate_pairs(keys: np.ndarray, k: int, direct: np.ndarray, n_keys: int):
    """Enumerate every (k+1)-mer whose prefix and suffix k-mers are both
    DB keys: for each key u and each of the 4 suffix extensions c, the
    pair exists iff v = (u mod 4**(k-1))*4 + c is also a key.  Returns
    (pu, pv, key11): prefix row, suffix row, and the (k+1)-mer code of
    each pair (vectorized; ~20 ms per 400k keys)."""
    keys = keys.astype(np.uint64)
    suf_core = (keys % np.uint64(4 ** (k - 1))) * np.uint64(4)
    pu_l, pv_l, k11_l = [], [], []
    for c in range(4):
        v = suf_core + np.uint64(c)
        vr = direct[v.astype(np.int64)]
        m = vr != n_keys
        pu_l.append(np.flatnonzero(m).astype(np.int32))
        pv_l.append(vr[m].astype(np.int32))
        k11_l.append((keys[m] * np.uint64(4) + np.uint64(c)).astype(np.int64))
    return (
        np.concatenate(pu_l),
        np.concatenate(pv_l),
        np.concatenate(k11_l),
    )


def enumerate_pairs_generic(keys: np.ndarray, k: int, sigma: int):
    """Generic-alphabet pair enumeration (no direct table): for each key u
    and each of the ``sigma`` suffix extensions c, the (k+1)-mer pair
    exists iff v = (u mod sigma**(k-1))*sigma + c is also a key -- found by
    binary search over the sorted key array.  Returns (pu, pv, key11)
    SORTED by key11 (the pair radix index requires sorted keys and its row
    answers are positions in that order)."""
    keys = keys.astype(np.uint64)
    n = keys.shape[0]
    suf_core = (keys % np.uint64(sigma ** (k - 1))) * np.uint64(sigma)
    pu_l, pv_l, k11_l = [], [], []
    for c in range(sigma):
        v = suf_core + np.uint64(c)
        pos = np.searchsorted(keys, v)
        pos_c = np.minimum(pos, max(n - 1, 0))
        m = keys[pos_c] == v
        pu_l.append(np.flatnonzero(m).astype(np.int32))
        pv_l.append(pos_c[m].astype(np.int32))
        k11_l.append(keys[m] * np.uint64(sigma) + np.uint64(c))
    pu = np.concatenate(pu_l)
    pv = np.concatenate(pv_l)
    key11 = np.concatenate(k11_l)
    order = np.argsort(key11, kind="stable")
    return pu[order], pv[order], key11[order]


def build_combo_table(direct: np.ndarray, direct11: np.ndarray, k: int,
                      num_kmers: int) -> np.ndarray:
    """ONE-gather slot-row table for the paired tokenizer.

    Layout (int32, size 4**(k+1) + 4**k + 1):

      [0, 4**(k+1))              fully-valid slots indexed by the
                                 (k+1)-mer: pair row if the pair exists,
                                 else the one hitting single's row (the
                                 pair identity guarantees at most one),
                                 else the miss row;
      [4**(k+1), 4**(k+1)+4**k)  single-window fallback region indexed by
                                 a k-mer (mixed-validity slots: read
                                 tails, windows adjacent to bad chars) --
                                 a copy of ``direct`` with misses mapped
                                 to the zero row;
      last cell                  the miss row (slots with no valid window).
    """
    n11 = direct11.shape[0]
    nk = direct.shape[0]
    combo = np.empty(n11 + nk + 1, np.int32)
    pre = direct[np.arange(n11, dtype=np.int64) >> (2 * 1)]  # key11 // 4
    # suffix k-mer = key11 mod 4**k
    suf = direct[np.arange(n11, dtype=np.int64) & (nk - 1)]
    single = np.where(pre != num_kmers, pre, suf)
    combo[:n11] = np.where(direct11 >= 0, direct11, single)
    combo[n11 : n11 + nk] = direct
    combo[-1] = num_kmers
    return combo
