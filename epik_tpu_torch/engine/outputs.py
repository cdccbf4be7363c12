"""Host-side result decoding and jplace-row assembly, copied as numpy from
``epik_tpu/engine/placer.py``: ``unpack_outputs`` (:1501),
``unpack_outputs_slim`` (:1553), ``_Pending`` (:1574), ``_SplitPending``
(:1586), the merge of ``_merge_split`` (:2787) and ``assemble_arrays``
(:2920). The quirk Q2/Q3 fallback and the keep-factor filter are unchanged."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .staging import wrapped_m
from .types import ArrayPlacedCollection

__all__ = ["POW10_ZERO", "U64", "_Pending", "_SplitPending", "assemble_arrays",
           "merge_split", "pack_totals", "unpack_body", "unpack_outputs", "unpack_outputs_slim"]

U64 = 1 << 64
#: exponent below which IEEE-double 10**x rounds to exactly 0.0
#: (reference computes pow in double: place.h:29, place.cpp:39-48)
POW10_ZERO = -323.6


def unpack_outputs(arr: np.ndarray, K: int):
    """Host-side inverse of the full (R+1, 4K+2) pack of the CSR step
    (``ops/csr.py::pack_outputs``)."""
    return (*unpack_body(arr[:-1], K), *pack_totals(arr))


def pack_totals(arr: np.ndarray) -> tuple[int, int]:
    """The totals row of a pack with one (rows, width), or of each group's
    pack in (groups, rows, width): the exact and ambiguous postings, in
    20-bit halves, which the CSR step's budgets must hold; the largest over
    the groups."""
    totals = arr[..., -1, :4].reshape(-1, 4).astype(np.int64)
    return (int(((totals[:, 0] << 20) + totals[:, 1]).max()),
            int(((totals[:, 2] << 20) + totals[:, 3]).max()))


def unpack_body(body: np.ndarray, K: int):
    """The rows of the full pack without its totals row: (scores, idx,
    counts, wr, n, zero_sum)."""
    scores_k = body[:, 0:K]
    wr_k = body[:, K : 2 * K].astype(np.float64)
    idx_k = body[:, 2 * K : 3 * K].astype(np.int32)
    counts_k = body[:, 3 * K : 4 * K].astype(np.int64)
    n = body[:, 4 * K].astype(np.int32)
    zero_sum = body[:, 4 * K + 1] != 0
    return scores_k, idx_k, counts_k, wr_k, n, zero_sum


def unpack_outputs_slim(arr: np.ndarray, K: int):
    """Host-side inverse of the slim (R, 2K+3) pack; recomputes wr exactly as
    the JAX device path would (f32 exp of score - log_sum, zeroed below the
    double-pow underflow floor)."""
    scores_k = arr[:, 0:K]
    idx_k = arr[:, K : 2 * K].astype(np.int32)
    log_sum = arr[:, 2 * K]
    n = arr[:, 2 * K + 1].astype(np.int32)
    zero_sum = arr[:, 2 * K + 2] != 0
    dead = zero_sum[:, None] | (scores_k < np.float32(POW10_ZERO))
    # mask BEFORE subtracting: dead lanes can hold -inf - -inf
    z = np.where(dead, np.float32(0), scores_k) - np.where(
        dead, np.float32(0), np.broadcast_to(log_sum[:, None], scores_k.shape)
    )
    wr = np.exp(z.astype(np.float32) * np.float32(math.log(10.0)))
    wr = np.where(dead, np.float32(0), wr).astype(np.float64)
    counts_k = np.full((arr.shape[0], K), -1, dtype=np.int64)
    return scores_k, idx_k, counts_k, wr, n, zero_sum, 0, 0


@dataclasses.dataclass
class _Pending:
    """In-flight batch: device work enqueued, results not yet fetched.

    ``budget`` says how ``place_wait`` checks the result and re-runs the
    step with the same staged inputs when a static budget was too small:
    None (the dense path: never), ``("tiles_ov", OV, rerun)`` with
    ``rerun(OV)`` (two-level tiles), or ``("csr", P, PA, rerun)`` with
    ``rerun(P, PA)`` (the CSR step)."""

    sequence_map: dict
    seqs: list
    m_signed: object
    out: object | None  # f32 result tensor, None for an empty batch
    K: int
    budget: tuple | None = None


@dataclasses.dataclass
class _SplitPending:
    """A batch split between two engines (tiles for clean reads, CSR for
    ambiguous ones); results merge back into original row order."""

    sequence_map: dict
    seqs: list
    idx_clean: np.ndarray
    idx_amb: np.ndarray
    clean: _Pending
    amb: _Pending


def merge_split(pending: _SplitPending, col_c: ArrayPlacedCollection,
                col_a: ArrayPlacedCollection) -> ArrayPlacedCollection:
    """Merge a split batch's two array collections back into the original
    unique-sequence row order."""
    R = len(pending.seqs)
    Kmax = max(col_c.ids.shape[1], col_a.ids.shape[1])

    def alloc(ref):
        return np.zeros((R, Kmax), ref.dtype)

    ids = alloc(col_c.ids)
    scores = alloc(col_c.scores)
    wr = alloc(col_c.wr)
    counts = alloc(col_c.counts)
    dist = alloc(col_c.dist)
    pend = alloc(col_c.pend)
    keep = np.zeros((R, Kmax), bool)
    for idx, col in ((pending.idx_clean, col_c), (pending.idx_amb, col_a)):
        w = col.ids.shape[1]
        ids[idx, :w] = col.ids
        scores[idx, :w] = col.scores
        wr[idx, :w] = col.wr
        counts[idx, :w] = col.counts
        dist[idx, :w] = col.dist
        pend[idx, :w] = col.pend
        keep[idx, :w] = col.keep
    return ArrayPlacedCollection(
        pending.sequence_map, pending.seqs, ids, scores, wr, counts,
        dist, pend, keep,
    )


def assemble_arrays(
    seqs, sequence_map, m_signed, scores_k, idx_k, counts_k, wr_k,
    n_touched, zero_sum, K, *, distal, pendant, log_eps, k, B,
    keep_at_most, keep_factor,
) -> ArrayPlacedCollection:
    """Vectorized jplace-row decisions; returns an array-backed batch."""
    n_eff = np.minimum(n_touched, K)
    # keep-factor filter precomputed: threshold = best_wr * kf (quirk Q3
    # zeroes kf); placements are score-desc so wr_k[:, 0] is the best
    kf = np.where(zero_sum, 0.0, keep_factor)
    thresh = wr_k[:, 0] * kf
    jcols = np.arange(K)[None, :]
    keep = (jcols < n_eff[:, None]) & (wr_k >= thresh[:, None])

    ids = idx_k.astype(np.int32, copy=True)
    scores = scores_k.astype(np.float32, copy=True)
    wr = wr_k.astype(np.float64, copy=True)
    counts = counts_k.astype(np.int32, copy=True)
    dist = distal[idx_k]
    pend = pendant[idx_k]

    fb = n_touched == 0
    if fb.any() and keep_at_most > K:
        # the fallback fabricates keep_at_most rows even when the tree
        # has fewer branches (reference loops 0..keep_at_most regardless,
        # place.cpp:141-152); widen the batch to hold them
        pad = ((0, 0), (0, keep_at_most - K))
        ids = np.pad(ids, pad)
        scores = np.pad(scores, pad)
        wr = np.pad(wr, pad)
        counts = np.pad(counts, pad)
        dist = np.pad(dist, pad)
        pend = np.pad(pend, pad)
        keep = np.pad(keep, pad)  # padded columns stay filtered out
        K = keep_at_most
    if fb.any():
        # no-match fallback, vectorized (quirk Q2; reference:
        # place.cpp:141-152,164-184): K fabricated placements on branches
        # 0..K-1, score ts = f32(log_eps * m / k) with the size_t-wrapped
        # window count m (quirk Q1), weight ratio power/(B*power) in
        # double with underflow-to-zero (Q3).
        ts32 = log_eps * wrapped_m(m_signed) / np.float32(k)  # f32 math
        power = 10.0 ** ts32.astype(np.float64)
        score_sum = float(B) * power
        wr_fb = np.divide(
            power, score_sum,
            out=np.zeros_like(power),
            where=(score_sum != 0.0) & (power != 0.0),
        )
        ids[fb] = np.arange(K, dtype=np.int32)[None, :]
        scores[fb] = ts32[fb][:, None]
        wr[fb] = wr_fb[fb][:, None]
        counts[fb] = 0
        dist[fb] = 0.0
        pend[fb] = 0.0
        # all K fabricated rows survive the ratio filter: equal ratios
        # always pass wr >= wr*kf (and Q3 zeroes kf when the sum is 0)
        keep[fb] = True

    return ArrayPlacedCollection(
        sequence_map, seqs, ids, scores, wr, counts, dist, pend, keep
    )
