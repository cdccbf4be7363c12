"""Multi-device placement of the port: data-parallel reads x column-sharded
planes, posting tiles or hash-sharded tables.

Ports ``epik_tpu/parallel/sharding.py``:

* database partitioning, copied as numpy: :func:`shard_db_columns` (:105-132),
  the column-sharded dense planes (the placer builds each shard on its device
  with ``engine/state.py::build_plane_shard`` instead), :func:`shard_tiles_columns`
  (:135-236), the column-sharded posting tiles with their two-level
  main/overflow split, and :func:`shard_db_by_hash` (:250-313), the
  hash-sharded cuckoo tables and postings of the CSR step;
* the column finish (:321-400) over a list of per-shard ``(R, bwl)`` tensors:
  the shifted one (:func:`finish_scores_cols_shifted`) and the classic one
  with counts (:func:`finish_scores_cols`), one launch of
  ``kernels/finish_cols.py``'s kernel per shard (its count, maximum, sum of
  exponentials against that maximum and top-K candidates, and the classic
  form's candidate counts), then the merge (:func:`_merge_cols`): ``psum``
  becomes a sum over the shards in shard order, ``pmax`` a maximum,
  ``all_gather`` a concatenation in shard order, and each shard's exp-sum is
  rescaled to the merged maximum;
* the steps, each for one data group (one mesh row) over its model shards:
  :func:`sharded_dense_bytes_step` (:421-469), :func:`sharded_dense_paired_step`
  (:479-520) and :func:`sharded_dense_rows_step` (:634-667), per shard one
  launch of kernel 1 with the ambiguous adds and the shard's column finish
  fused in (``rowgather_sum_cols``, classic ``rowgather_sum_counts_cols``);
  :func:`sharded_tiles_bytes_step` (``_sharded_tiles_bytes_step``
  :530-626, kernel 3's sums alone or kernel 4); :func:`sharded_csr_bytes_step`
  (:745-802) and :func:`sharded_csr_step` (:675-737), both through kernel 4
  with counts (per-read cells) or, with ``accumulate="scatter"``, its
  row-pointer form over a flat posting budget (JAX's ``dense_acc=False``),
  and the counts finish (``finish_topk_counts``, slim pack);
* :class:`ShardedTorchPlacer` (``ShardedJaxPlacer`` :810-1410), its routing
  and dispatch; the dedup, budget retries and assembly are the surface it
  shares with the single-device placer (``engine/surface.py``).

Each step takes ``exchange``: on a mesh row whose shards lie in several
processes, a step runs the kernels of this process's shards, then
``exchange.py::ModelExchange.gather`` brings the other ranks' shard tensors,
and the merge runs on every shard in shard order, as in one process.

The JAX package's ``_pad_split``/``_pad_i32`` (:1413-1425) are
``engine/staging.py``'s ``pad_u64_split``/``pad_i32``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import zlib

import numpy as np
import torch

from ..engine.config import PlacerConfig, device_budget
from ..engine.outputs import _Pending
from ..engine.staging import _bucket, pad_i32, pad_u64_split, wrapped_m
from ..engine.state import CsrState, build_plane_shard, pair_tables
from ..engine.step import window_counts
from ..engine.surface import MAX_DIRECT_K, MAX_PAIR_K, MAX_TILE_PLEN, PlacerSurface
from ..engine.tables import direct_table
from ..engine.tiles import Q_MAX
from ..kernels.accumulate_packed import MAX_PACKED_BRANCHES, accumulate_packed_sums, tile_width
from ..kernels.accumulate_sums import accumulate_sums
from ..kernels.finish import POW10_ZERO, finish_topk_counts
from ..kernels.finish_cols import finish_cols_partial, finish_cols_partial_counts
from ..kernels.rowgather import (
    add_first_hits,
    cols_fits,
    counts_cols_fits,
    rowgather_sum,
    rowgather_sum_cols,
    rowgather_sum_counts,
    rowgather_sum_counts_cols,
    shifted_fused,
)
from ..kernels.tokenize import tokenize_combo_fused
from ..ops.csr import (
    ORDER_INF,
    accumulate_amb_firsthit,
    append_totals,
    exact_postings,
    pack_outputs,
)
from ..ops.dense import amb_classic_deltas, amb_deltas
from ..ops.hashtable import BUCKET, _next_pow2, build_table
from ..ops.tokenize import tokenize_core, tokenize_packed
from .exchange import ModelExchange
from .mesh import DATA_AXIS, MODEL_AXIS, CollectiveError, Mesh

__all__ = ["ShardedTorchPlacer", "finish_scores_cols", "finish_scores_cols_shifted",
           "shard_db_by_hash", "shard_db_columns", "shard_tiles_columns",
           "sharded_csr_bytes_step", "sharded_csr_step", "sharded_dense_bytes_step",
           "sharded_dense_paired_step", "sharded_dense_rows_step", "sharded_tiles_bytes_step"]

#: largest k whose window keys fit the CSR bytes step's 32-bit low word
_MAX_BYTES_K = 16
#: tile cells per read are trash-padded to a multiple of this
_CH = 512


def _shard_of_key(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Stable hash-based shard assignment (balanced, key-range-free)."""
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        x = lo ^ (hi * np.uint32(0x9E3779B9))
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
    return (x % np.uint32(n_shards)).astype(np.int64)


# ---------------------------------------------------------------------------
# database partitioning (numpy, as the JAX package builds it)
# ---------------------------------------------------------------------------


def shard_db_columns(db, n_model: int, num_branches: int, shifted: bool = False,
                     log_eps: float = 0.0):
    """Column-sharded dense score planes: f32 (n_model, n_keys+1, bwl).

    Shard ``s`` owns global branch columns [s*bwl, (s+1)*bwl), ``bwl`` =
    ceil(B / (128 n_model)) * 128. Absent cells are exactly 0.0; a stored
    score of exactly 0.0 is nudged to -1e-37 so presence stays ``!= 0``, and
    with ``shifted`` the cells hold s - log10(eps), nudged to 1e-37 where that
    is not > 0. The last plane row is the all-zero miss row. Returns (planes,
    bwl)."""
    bwl = -(-num_branches // (128 * n_model)) * 128
    n_keys = db.num_kmers
    lens = np.diff(db.row_off)
    rows_pp = np.repeat(np.arange(n_keys, dtype=np.int64), lens.astype(np.int64))
    br = db.branches.astype(np.int64)
    if shifted:
        sp = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)
        sc = np.where(sp <= 0.0, np.float32(1e-37), sp)
    else:
        sc = np.where(db.scores == 0.0, np.float32(-1e-37), db.scores).astype(np.float32)
    shard = br // bwl
    planes = np.zeros((n_model, n_keys + 1, bwl), np.float32)
    planes[shard, rows_pp, br - shard * bwl] = sc
    return planes, bwl


def shard_tiles_columns(db, n_model: int, B: int, log_eps: float):
    """Column-sharded posting tiles for the big-tree mode.

    Shard m keeps, per key, only the postings whose branch falls in its
    block [m*bwl, (m+1)*bwl), re-based to local ids, trash-padded to a
    common PT (the max per-shard local posting count). Packed int32 cells
    ``(local_branch << 16) | q`` whenever the trash branch ``tile_width(bwl)
    - 1`` fits 15 bits, with the two-level main/overflow split (overflow
    keys -- any shard over PT_main -- permuted to rows [0, n_ov), common to
    all shards through the shared direct table); else the f32 interleaved
    ``[branch | score bits]`` pairs, single-level.

    Returns (tiles, bwl, PT, scale, tiles_ov, PT_OV, n_ov, frac_over, perm):
    tiles int32[n_model, n_keys+1, PT] with quantization ``scale`` when
    packed, or uint32[n_model, n_keys+1, 2*PT] with scale == 0.0."""
    n_keys = db.num_kmers
    bwl = -(-B // (128 * n_model)) * 128
    trash = tile_width(bwl) - 1
    lens = np.diff(db.row_off)
    rows_pp = np.repeat(np.arange(n_keys, dtype=np.int64), lens)
    br = db.branches.astype(np.int64)
    shard = br // bwl
    shifted = (db.scores.astype(np.float64) - float(log_eps)).astype(np.float32)

    counts = np.zeros((n_model, n_keys), np.int64)
    np.add.at(counts, (shard, rows_pp), 1)
    max_cnt = max(int(counts.max()), 1)
    PT = -(-max_cnt // 8) * 8
    packed = trash < MAX_PACKED_BRANCHES
    perm = np.arange(n_keys, dtype=np.int64)
    PT_OV = 0
    n_ov = 0
    frac_over = 0.0
    if packed and PT > 8 and n_keys:
        key_max = counts.max(axis=0)
        best, best_cost = PT, float(PT)
        for cand in range(8, PT, 8):
            fo = float((key_max > cand).mean())
            ptov = -(-(max_cnt - cand) // 8) * 8
            cost = cand + 2.0 * fo * ptov
            if cost < best_cost - 0.5:
                best, best_cost = cand, cost
        if best < PT and bool((key_max > best).any()):
            PT_main = best
            PT_OV = -(-(max_cnt - PT_main) // 8) * 8
            frac_over = float((key_max > PT_main).mean())
            ov_keys = np.flatnonzero(key_max > PT_main)
            n_ov = ov_keys.shape[0]
            perm = np.empty(n_keys, np.int64)
            perm[ov_keys] = np.arange(n_ov)
            perm[np.flatnonzero(key_max <= PT_main)] = np.arange(n_ov, n_keys)
            PT = PT_main
    if packed:
        span = max(float(-log_eps), 1e-6)
        scale = float(Q_MAX) / span
        q = np.clip(np.rint(shifted.astype(np.float64) * scale), 1, Q_MAX).astype(np.int64)
        tiles = np.full((n_model, n_keys + 1, PT), np.int32(trash << 16), np.int32)
    else:
        scale = 0.0
        shifted = np.where(shifted <= 0.0, np.float32(1e-37), shifted)
        sbits = shifted.view(np.uint32)
        tiles = np.empty((n_model, n_keys + 1, 2 * PT), np.uint32)
        tiles[:, :, 0::2] = np.uint32(trash)
        tiles[:, :, 1::2] = np.float32(0.0).view(np.uint32)
    tiles_ov = None
    if PT_OV:
        tiles_ov = np.full((n_model, n_ov + 1, PT_OV), np.int32(trash << 16), np.int32)
    for m in range(n_model):
        mask = shard == m
        rows_m = rows_pp[mask]  # nondecreasing (rows_pp sorted)
        cm = counts[m]
        starts = np.concatenate([[0], np.cumsum(cm)])[:-1]
        cols = np.arange(rows_m.size, dtype=np.int64) - np.repeat(starts, cm)
        local = br[mask] - m * bwl
        if packed:
            vals = ((local << 16) | q[mask]).astype(np.int32)
            main = cols < PT
            tiles[m, perm[rows_m[main]], cols[main]] = vals[main]
            if PT_OV:
                ov = ~main
                tiles_ov[m, perm[rows_m[ov]] + 1, cols[ov] - PT] = vals[ov]
        else:
            tiles[m, rows_m, 2 * cols] = local.astype(np.uint32)
            tiles[m, rows_m, 2 * cols + 1] = sbits[mask]
    return tiles, bwl, PT, scale, tiles_ov, PT_OV, n_ov, frac_over, perm


@dataclasses.dataclass
class ShardedDB:
    """Stacked per-shard cuckoo tables + posting arrays (leading model axis)."""

    packed: np.ndarray  # [n_model, nb, 4*BUCKET] uint32 (packed cuckoo rows)
    postings: np.ndarray  # [n_model, Pmax, 2] uint32 rows [branch | score bits]
    row_off: np.ndarray  # [n_model, rows_pad] int32 local CSR offsets
    seeds: list[tuple[int, int]]
    avg_plen: float

    def shard_state(self, m: int, device) -> CsrState:
        """Shard ``m``'s arrays as the CSR step's device state."""
        post = self.postings[m]
        return CsrState(
            table=torch.from_numpy(self.packed[m].astype(np.int64)).to(device),
            seed1=int(self.seeds[m][0]), seed2=int(self.seeds[m][1]),
            post_b=torch.from_numpy(np.ascontiguousarray(post[:, 0]).view(np.int32)).to(device),
            post_s=torch.from_numpy(np.ascontiguousarray(post[:, 1]).view(np.float32)).to(device),
            row_off=torch.from_numpy(self.row_off[m].astype(np.int64)).to(device))


def shard_db_by_hash(db, n_model: int) -> ShardedDB:
    """Partition the CSR database by key hash (the big-DB mode).

    Postings are permuted once by a stable argsort over the per-posting
    shard id (stable => within a shard, postings keep the ascending-key
    order that the local CSR expects); every shard's table has the same
    geometry (required for stacking)."""
    lens_all = np.diff(db.row_off).astype(np.int64)
    shard_ids = _shard_of_key(db.keys, n_model)

    post_shard = np.repeat(shard_ids, lens_all)
    perm = np.argsort(post_shard, kind="stable")
    branches_sorted = db.branches[perm]
    scores_sorted = db.scores[perm]
    post_counts = np.bincount(post_shard, minlength=n_model).astype(np.int64)
    post_starts = np.concatenate([[0], np.cumsum(post_counts)])

    key_counts = np.bincount(shard_ids, minlength=n_model)
    max_n = max(1, int(key_counts.max()) if db.num_kmers else 1)
    nb_target = _next_pow2(max(1, int(np.ceil(max_n / (BUCKET * 0.85)))))

    per_shard = []
    tables = []
    for s in range(n_model):
        sel = shard_ids == s
        keys = db.keys[sel]
        lens = lens_all[sel]
        local_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        branches = branches_sorted[post_starts[s] : post_starts[s + 1]]
        scores = scores_sorted[post_starts[s] : post_starts[s + 1]]
        per_shard.append((keys, local_off, branches, scores))
        tables.append(build_table(keys, np.arange(keys.shape[0], dtype=np.uint32), lens,
                                  min_buckets=nb_target))

    p_max = max(1, max(x[2].shape[0] for x in per_shard))
    rows_pad = max(len(x[1]) for x in per_shard)

    def stack(f):
        return np.stack([f(i) for i in range(n_model)])

    def pack_postings(i):
        br, sc = per_shard[i][2], per_shard[i][3]
        pp = np.stack([br.astype(np.uint32), sc.astype(np.float32).view(np.uint32)], axis=1)
        return np.pad(pp, ((0, p_max - pp.shape[0]), (0, 0)))

    return ShardedDB(
        packed=stack(lambda i: tables[i].packed()),
        postings=stack(pack_postings),
        row_off=stack(lambda i: np.pad(per_shard[i][1].astype(np.int32),
                                       (0, rows_pad - len(per_shard[i][1])), mode="edge")),
        seeds=[(t.seed1, t.seed2) for t in tables],
        avg_plen=float(lens_all.mean()) if lens_all.size else 1.0,
    )


# ---------------------------------------------------------------------------
# the column finish: correction + LWR + two-stage top-K over the shards
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _f32(x: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor on ``device``: PyTorch's CUDA ops with a CPU scalar
    divide by multiplying with the reciprocal, which rounds differently. Made
    once per (value, device): each copy to a card waits for its stream, and
    the column finish would wait for the card at every constant. Read only."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _top(x: torch.Tensor, n: int):
    """The n largest of each row, ties to the lowest index (as
    ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def finish_scores_cols_shifted(Sps: list[torch.Tensor | None], m_f32: torch.Tensor, *, B: int,
                               K: int, k: int, log_eps: float, exchange=None):
    """Column-sharded finish from the shards' SHIFTED sums S' = S - C*log_eps,
    each f32 (R, bwl) on its shard's device (padded columns stay untouched):
    one ``finish_cols_partial`` per shard (its count, maximum, exp-sum and
    top-K candidates), then the merge (:func:`_merge_cols`). Per-branch
    counts are never materialized (reported as -1). ``Sps[s]`` is None for a
    shard another process holds, whose partial pack ``exchange`` brings
    (:func:`_all_shards`). Returns (scores, idx, counts, wr, n, zero_sum,
    log_sum) on the first shard's device (across processes, this process's
    first)."""
    local = [Sp for Sp in Sps if Sp is not None]
    bwl = local[0].shape[1]
    m_on = _on_devices([Sp.device for Sp in local], lambda dev: m_f32.to(dev).contiguous())
    partials = [None if Sp is None else
                (finish_cols_partial(Sp, m_on[Sp.device], K=K, k=k, log_eps=log_eps,
                                     col0=s * bwl),) for s, Sp in enumerate(Sps)]
    partials = [p[0] for p in _all_shards(partials, exchange)]
    return _merge_cols(partials, m_f32, B=B, K=K, k=k, log_eps=log_eps)


def finish_scores_cols(S: list[torch.Tensor], C: list[torch.Tensor], m_f32: torch.Tensor, *,
                       B: int, K: int, k: int, log_eps: float):
    """Column-sharded finish of the classic sums and exact counts (JAX
    :321-342): one ``finish_cols_partial_counts`` per shard (``touched = C >
    0``, the Q1 wrap of ``m - C`` to 2**64, each shard's candidates carrying
    their counts), then :func:`_merge_cols`. Returns (scores, idx, counts, wr,
    n, zero_sum, log_sum) on the first shard's device."""
    bwl = S[0].shape[1]
    m_on = _on_devices([S_s.device for S_s in S], lambda dev: m_f32.to(dev).contiguous())
    partials, counts = zip(*(finish_cols_partial_counts(S_s, C_s, m_on[S_s.device], K=K, k=k,
                                                        log_eps=log_eps, col0=s * bwl)
                             for s, (S_s, C_s) in enumerate(zip(S, C))))
    return _merge_cols(list(partials), m_f32, B=B, K=K, k=k, log_eps=log_eps,
                       counts=list(counts))


def _on_devices(devices, make) -> dict:
    """``make(dev)`` once per distinct device."""
    out = {}
    for dev in devices:
        if dev not in out:
            out[dev] = make(dev)
    return out


def _all_shards(parts: list, exchange) -> list:
    """Every shard's tuple of tensors, in shard order, for the merge. In one
    process ``parts`` holds them all; on a row that spans processes
    ``parts[s]`` is None for a shard another rank holds, and ``exchange``
    (``exchange.py::ModelExchange.gather``) fills it in, so that every rank
    of the row merges the same tensors in the same order."""
    return parts if exchange is None else exchange(parts)


def _merge_cols(partials, m_f32, *, B: int, K: int, k: int, log_eps: float, counts=None):
    """The column-sharded LWR over all B branches and the distributed top-K
    (JAX ``_lwr_topk_cols`` :358-400) from the shards' partial packs ``[values
    Kl | global ids Kl | n_s | max_s | e_s]``: n and max_c merge over the
    shards; each shard's exp-sum ``e_s``, taken against its own ``max_s``,
    is rescaled to the merged max_t, ``sum10 = sum_s e_s * 10**(max_s -
    max_t)`` in shard order (0 where ``n_s = 0``; the factor is exactly 1
    where ``max_s = max_t``), plus the untouched (B - n) term; the shards'
    candidates, in shard order, go through one more top-K (shards in column
    order and each shard's candidates in ascending column keep the
    lowest-global-index tie-break). ``counts``: the shards' (R, Kl) candidate
    counts, else -1."""
    lead = partials[0].device
    f32 = torch.float32
    neg_inf = _f32(-math.inf, lead)
    zero = _f32(0.0, lead)
    ln10 = _f32(math.log(10.0), lead)
    m = m_f32.to(lead).to(f32)
    parts = [p.to(lead) for p in partials]
    Kl = (parts[0].shape[1] - 3) // 2

    n = functools.reduce(torch.add, [p[:, 2 * Kl].to(torch.int32) for p in parts])
    npl_exp = m * _f32(log_eps, lead) / _f32(float(k), lead)
    n_not = float(B) - n.to(f32)
    max_c = functools.reduce(torch.maximum, [p[:, 2 * Kl + 1] for p in parts])
    max_t = torch.maximum(max_c, torch.where(n_not > 0, npl_exp, neg_inf))
    sum10 = functools.reduce(torch.add, [
        torch.where(p[:, 2 * Kl] > 0,
                    p[:, 2 * Kl + 2] * torch.exp((p[:, 2 * Kl + 1] - max_t) * ln10), zero)
        for p in parts])
    sum10 = sum10 + n_not * torch.exp(torch.where(n_not > 0, (npl_exp - max_t) * ln10, neg_inf))
    log_sum = max_t + torch.log(sum10) / ln10
    zero_sum = (max_c < POW10_ZERO) & ((npl_exp < POW10_ZERO) | (n_not <= 0))

    top_s, sel = _top(torch.cat([p[:, :Kl] for p in parts], dim=1), K)
    top_i = torch.gather(torch.cat([p[:, Kl:2 * Kl] for p in parts], dim=1), 1, sel).long()
    if counts is None:
        top_c = torch.full(top_i.shape, -1, dtype=torch.int32, device=lead)
    else:
        top_c = torch.gather(torch.cat([c.to(lead) for c in counts], dim=1), 1, sel)
    wr = torch.exp((top_s - log_sum[:, None]) * ln10)
    wr = torch.where(zero_sum[:, None] | (top_s < POW10_ZERO), zero, wr)
    return top_s, top_i, top_c, wr, n, zero_sum, log_sum


def _pack_slim(outs) -> torch.Tensor:
    """The slim (R, 2K+3) f32 pack [scores K | idx K | log_sum | n | zero_sum]
    (host decoder: ``engine/outputs.py::unpack_outputs_slim``)."""
    scores, idx, _counts, _wr, n, zero_sum, log_sum = outs
    f32 = torch.float32
    return torch.cat([scores, idx.to(f32), log_sum[:, None], n.to(f32)[:, None],
                      zero_sum.to(f32)[:, None]], dim=1)


# ---------------------------------------------------------------------------
# the steps: one data group (one mesh row) over its model shards
# ---------------------------------------------------------------------------


def _pad_cells(x: torch.Tensor, value) -> torch.Tensor:
    """Right-pad the columns of ``x`` with ``value`` to a multiple of 512."""
    extra = -x.shape[1] % _CH
    if extra == 0:
        return x.contiguous()
    pad = torch.full((x.shape[0], extra), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def _shifted_cols(plane, rows, m_f32, amb_read, delta, *, K: int, k: int, log_eps: float,
                  col0: int, pair_rows: bool = False) -> torch.Tensor:
    """One shard's partial pack from its shifted plane: kernel 1 with the
    delta add and the column finish fused in where the width rule takes it
    (:func:`shifted_fused`, the crossover measured on the H100) and its
    shared memory fits (:func:`cols_fits`), else the gather, the same f32 add
    at the ambiguous reads and ``finish_cols_partial`` apart, decided before
    any launch (``pair_rows``: the rows are the pair plane's, which both
    routes take in read order)."""
    kw = dict(K=K, k=k, log_eps=log_eps, col0=col0)
    if shifted_fused(plane.shape[1], cols=True) and cols_fits(plane, K):
        return rowgather_sum_cols(plane, rows, m_f32, amb_read, delta, pair_rows=pair_rows,
                                  **kw)
    Sp = rowgather_sum(plane, rows, pair_rows=pair_rows)
    if amb_read is not None and amb_read.numel() > 0:
        Sp[amb_read] = Sp[amb_read] + delta
    return finish_cols_partial(Sp, m_f32, **kw)


def _classic_cols(plane, rows, m_f32, amb_read, dS, hit, *, K: int, k: int, log_eps: float,
                  col0: int):
    """One shard's (partial pack, candidate counts) from its classic plane:
    kernel 1 with counts, the first hit and the counts form of the column
    finish fused in, or past its limit (:func:`counts_cols_fits`) the gather
    with counts, the same adds and ``finish_cols_partial_counts`` apart."""
    kw = dict(K=K, k=k, log_eps=log_eps, col0=col0)
    if counts_cols_fits(plane, K):
        return rowgather_sum_counts_cols(plane, rows, m_f32, amb_read, dS, hit, **kw)
    S, C = add_first_hits(*rowgather_sum_counts(plane, rows), amb_read, dS, hit)
    return finish_cols_partial_counts(S, C, m_f32, **kw)


def _dense_step(planes, tokenize, arows, m_f32, *, shifted: bool, B: int, K: int, Amax: int,
                k: int, zero_row: int, eps: float, log_eps: float, pair_rows: bool = False,
                exchange=None) -> torch.Tensor:
    """The body of the three column-sharded dense steps, for one data group.
    ``tokenize(s, device)`` gives the group's (rows, lens) on the device of
    shard s (lens None where ``m_f32`` is given), run once per distinct
    device. Per shard, the ambiguous first hits over its own columns, then
    one kernel: shifted, kernel 1's sums with each ambiguous read's delta row
    added and the shard's column finish fused in (:func:`_shifted_cols`,
    ``pair_rows``: the rows are the pair plane's);
    classic, the sums with counts, the first hit and the counts form of the
    finish (:func:`_classic_cols`). Column sharding needs no collective
    there: each branch column lives on one shard, which sees every window's
    row (JAX :408-411). Then the merge into the slim (R, 2K+3) pack (shifted)
    or the full (R+1, 4K+2) pack with zero totals (classic), on the first
    shard's device. JAX pads the rows to a multiple of 16 with the zero row;
    that adds nothing to a sum, so the port does not. ``planes[s]`` is None
    for a shard another process holds; ``exchange`` then brings its partial
    pack (and counts) before the merge (:func:`_all_shards`)."""
    devs = [None if p is None else p.device for p in planes]
    here = [dev for dev in devs if dev is not None]
    tok = _on_devices(here, lambda dev: (*tokenize(devs.index(dev), dev), arows.to(dev)))
    if m_f32 is None:
        m_f32 = window_counts(tok[here[0]][1], k)
    m_on = _on_devices(here, lambda dev: m_f32.to(dev).contiguous())
    fkw = dict(K=K, k=k, log_eps=log_eps)
    parts = [None] * len(planes)
    for s, plane in enumerate(planes):
        if plane is None:
            continue
        rows, _, arows_d = tok[plane.device]
        bwl = plane.shape[1]
        akw = dict(zero_row=zero_row, B=bwl, k=k, eps=eps)
        if shifted:
            amb = amb_deltas(plane, arows_d, log_eps=log_eps, **akw) if Amax > 0 else (None,
                                                                                       None)
            parts[s] = (_shifted_cols(plane, rows, m_on[plane.device], *amb, col0=s * bwl,
                                      pair_rows=pair_rows, **fkw),)
        else:
            amb = amb_classic_deltas(plane, arows_d, **akw) if Amax > 0 else (None, None, None)
            parts[s] = _classic_cols(plane, rows, m_on[plane.device], *amb, col0=s * bwl, **fkw)
    parts = _all_shards(parts, exchange)
    outs = _merge_cols([p[0] for p in parts], m_f32, B=B,
                       counts=None if shifted else [p[1] for p in parts], **fkw)
    return _pack_slim(outs) if shifted else pack_outputs(outs, 0, 0)


def sharded_dense_bytes_step(planes, direct, buf, arows, *, B: int, K: int, Amax: int, k: int,
                             Lmax: int, num_kmers: int, log_eps: float, eps: float,
                             shifted: bool, exchange=None) -> torch.Tensor:
    """Column-sharded dense step with the device tokenizer, for one data
    group: ``planes`` and ``direct`` (the replicated key -> row table) one
    tensor per model shard on the shard's device; ``buf`` the group's packed
    reads, ``arows`` int32 (R, Amax) its ambiguous reads' plane rows, both
    anywhere. Kernel 1's sums per shard (shifted, or classic with counts),
    then the column finish (:func:`_dense_step`; ``exchange``: the row's
    model-axis exchange across processes, None in one process)."""
    return _dense_step(
        planes, lambda s, dev: tokenize_packed(buf.to(dev), direct[s], k=k, Lmax=Lmax,
                                               num_kmers=num_kmers),
        arows, None, shifted=shifted, B=B, K=K, Amax=Amax, k=k, zero_row=num_kmers, eps=eps,
        log_eps=log_eps, exchange=exchange)


def sharded_dense_paired_step(planes, combo, buf, arows, *, B: int, K: int, Amax: int, k: int,
                              Lmax: int, num_kmers: int, log_eps: float, eps: float,
                              exchange=None) -> torch.Tensor:
    """Column-sharded dense step over the pair plane (shifted only), for one
    data group: each shard's pair rows are the column slice of the global pair
    rows, so the slot sums compose per column as on one device. ``combo``: the
    replicated slot -> row table, one tensor per shard; the rest as
    :func:`sharded_dense_bytes_step`."""
    return _dense_step(
        planes, lambda s, dev: tokenize_combo_fused(buf.to(dev), combo[s], k=k, Lmax=Lmax)[:2],
        arows, None, shifted=True, B=B, K=K, Amax=Amax, k=k, zero_row=num_kmers, eps=eps,
        log_eps=log_eps, pair_rows=True, exchange=exchange)


def sharded_dense_rows_step(planes, rows, arows, m_f32, *, B: int, K: int, Amax: int, k: int,
                            zero_row: int, log_eps: float, eps: float,
                            shifted: bool, exchange=None) -> torch.Tensor:
    """Column-sharded dense step over plane rows resolved on the host, for
    one data group: ``rows`` int32 (R, Wmax) and ``arows`` int32 (R, Amax)
    (padding and misses on ``zero_row``) and the host's window counts
    ``m_f32`` (R,), anywhere. Any k, reads shorter than k and reads past
    65,535 bp."""
    return _dense_step(planes, lambda s, dev: (rows.to(dev), None), arows, m_f32,
                       shifted=shifted, B=B, K=K, Amax=Amax, k=k, zero_row=zero_row, eps=eps,
                       log_eps=log_eps, exchange=exchange)


def sharded_tiles_bytes_step(tiles, direct, buf, tiles_ov=None, *, B: int, bwl: int,
                             K: int, k: int, Lmax: int, num_kmers: int, PT: int,
                             log_eps: float, tile_scale: float = 0.0, PT_OV: int = 0,
                             OV: int = 0, N_OV: int = 0, exchange=None) -> torch.Tensor:
    """Column-sharded posting-tile step for one data group.

    ``tiles``, ``direct`` and ``tiles_ov``: one tensor per model shard, each
    on the shard's device (the direct table is the same on every shard);
    ``buf``: the group's packed reads (R, nbytes) uint8, anywhere. Per
    distinct device the reads are tokenized once; per shard its tile rows
    are gathered and summed -- ``tile_scale > 0``: the packed payload, the
    two-level overflow rows compacted to ``OV`` per read, kernel 3's sums
    (``accumulate_packed_sums``) and one f32 divide by ``tile_scale``;
    otherwise the f32 pairs through kernel 4 (``accumulate_sums``). Then the
    column finish. Returns the slim (R, 2K+3) pack on the first shard's
    device, plus each read's overflow-window count as a last column when
    ``PT_OV > 0`` (the host retries with a bigger OV when it exceeds OV).
    ``tiles[s]`` is None for a shard another process holds; ``exchange``
    brings its partial pack (:func:`finish_scores_cols_shifted`). The
    overflow counts need no exchange: every shard tokenizes the same reads
    through the same direct table, so every rank of the row counts alike."""
    trash = tile_width(bwl) - 1
    tok = {}
    Sps = []
    for s, til in enumerate(tiles):
        if til is None:
            Sps.append(None)
            continue
        dev = til.device
        if dev not in tok:
            tok[dev] = tokenize_packed(buf.to(dev), direct[s], k=k, Lmax=Lmax,
                                       num_kmers=num_kmers)
        rows, _ = tok[dev]
        R, W = rows.shape
        g = til[rows.long()]  # (R, W, PT) packed, (R, W, 2*PT) f32 pairs
        if tile_scale > 0.0:
            g = g.reshape(R, W * PT)
            if PT_OV > 0:
                ovr = torch.where(rows < N_OV, rows + 1, 0)
                # the order of the kept rows does not matter: the sums are integers
                sel = torch.topk(ovr, min(OV, W), dim=1).values
                g = torch.cat([g, tiles_ov[s][sel.long()].reshape(R, -1)], dim=1)
            Sq = accumulate_packed_sums(_pad_cells(g, trash << 16), B=bwl)
            Sps.append(Sq / _f32(tile_scale, dev))
        else:
            g = g.reshape(R, W * PT, 2)
            b = _pad_cells(g[..., 0], trash)
            sc = _pad_cells(g[..., 1], 0).view(torch.float32)
            Sps.append(accumulate_sums(b, sc, B=bwl))
    rows, lens = next(iter(tok.values()))
    outs = finish_scores_cols_shifted(Sps, window_counts(lens, k), B=B, K=K, k=k, log_eps=log_eps,
                                      exchange=exchange)
    pack = _pack_slim(outs)
    if tile_scale > 0.0 and PT_OV > 0:
        cnt_ov = (rows < N_OV).sum(dim=1)
        pack = torch.cat([pack, cnt_ov.to(torch.float32)[:, None]], dim=1)
    return pack


def _merge_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """``psum``: the shards' tensors summed on the first one's device, in
    shard order."""
    lead = parts[0].device
    return functools.reduce(torch.add, [p.to(lead) for p in parts])


def _merge_max(parts: list[torch.Tensor]) -> torch.Tensor:
    """``pmax`` on the first shard's device."""
    lead = parts[0].device
    return functools.reduce(torch.maximum, [p.to(lead) for p in parts])


def sharded_csr_bytes_step(shards: list[CsrState | None], buf, *, R: int, B: int, K: int,
                           Pb: int, k: int, Lmax: int, log_eps: float, flat: bool = False,
                           exchange=None) -> torch.Tensor:
    """Hash-sharded CSR step with on-device tokenization, for one data group
    of clean DNA reads: every shard looks up the full key stream of the
    group's packed reads ``buf`` in its own table (a key misses everywhere but
    its owner; invalid windows take the all-ones sentinel key, which misses
    too), lays its postings out per read in ``Pb`` cells (with ``flat``, over
    ``Pb`` cells for the group) and sums them with kernel 4 with counts (its
    row-pointer form); S and C merge over the shards, then the counts
    finish. Returns the (R+1, 2K+3) slim pack with the largest per-read
    posting count (the largest shard total with ``flat``) in its totals
    row. ``shards[s]`` is None for a shard another process holds; ``exchange``
    brings its S, C and total (:func:`_all_shards`), so that the totals row,
    which decides the budget retries, is the whole row's on every rank."""
    tok = {}
    parts = []
    for st in shards:
        if st is None:
            parts.append(None)
            continue
        dev = st.table.device
        if dev not in tok:
            key, ok, _, lens = tokenize_core(buf.to(dev), k=k, Lmax=Lmax)
            W = key.shape[1]
            e_hi = torch.where(ok, 0, 0xFFFFFFFF).reshape(-1)
            e_lo = torch.where(ok, key, 0xFFFFFFFF).reshape(-1)
            e_read = torch.arange(R, dtype=torch.int64, device=dev).repeat_interleave(W)
            tok[dev] = (e_hi, e_lo, e_read, lens)
        e_hi, e_lo, e_read, _ = tok[dev]
        parts.append(exact_postings(st.table, st.seed1, st.seed2, st.post_b, st.post_s,
                                    st.row_off, e_hi, e_lo, e_read, R=R, B=B, P=Pb, flat=flat))
    lens = next(iter(tok.values()))[3]
    S, C, e_tot = zip(*_all_shards(parts, exchange))
    slim = finish_topk_counts(_merge_sum(S), _merge_sum(C), window_counts(lens, k), K=K, k=k,
                              log_eps=log_eps, full=False)
    return append_totals(slim, _merge_max(e_tot), 0)


def sharded_csr_step(shards: list[CsrState | None], e_hi, e_lo, e_read, a_hi, a_lo, a_read,
                     a_order, m_f32, *, R: int, B: int, K: int, Pb: int, PAb: int, k: int,
                     log_eps: float, eps: float, flat: bool = False,
                     exchange=None) -> torch.Tensor:
    """Hash-sharded CSR step on host-staged key streams, for one data group:
    per shard the exact postings (kernel 4 with counts, per-read budget Pb;
    with ``flat`` its row-pointer form over a flat budget Pb) and the
    ambiguous first hit (budget PAb); S and C merge by sum, the first
    hit by minimum over processing order plus a sum of V masked to the
    shard that owns it (each key lives on exactly one shard). Returns the
    (R+1, 2K+3) slim pack with both budget totals in its last row.
    ``shards[s]`` is None for a shard another process holds; ``exchange``
    brings its six tensors (:func:`_all_shards`)."""
    parts = []
    for st in shards:
        if st is None:
            parts.append(None)
            continue
        dev = st.table.device
        S_s, C_s, e_s = exact_postings(st.table, st.seed1, st.seed2, st.post_b, st.post_s,
                                       st.row_off, e_hi.to(dev), e_lo.to(dev), e_read.to(dev),
                                       R=R, B=B, P=Pb, flat=flat)
        first, V, a_s = accumulate_amb_firsthit(
            st.table, st.seed1, st.seed2, st.post_b, st.post_s, st.row_off, a_hi.to(dev),
            a_lo.to(dev), a_read.to(dev), a_order.to(dev), R=R, B=B, PA=PAb, k=k, eps=eps)
        parts.append((S_s, C_s, first, V, e_s, a_s))
    S, C, firsts, Vs, e_tot, a_tot = zip(*_all_shards(parts, exchange))
    lead = S[0].device
    S, C = _merge_sum(S), _merge_sum(C)
    first_g = functools.reduce(torch.minimum, [f.to(lead) for f in firsts])
    hit = first_g < ORDER_INF
    zero = _f32(0.0, lead)
    V_g = _merge_sum([torch.where((f.to(lead) == first_g) & hit, V.to(lead), zero)
                      for f, V in zip(firsts, Vs)])
    S = S + torch.where(hit, V_g, zero)
    C = C + hit.to(torch.int32)
    slim = finish_topk_counts(S, C, m_f32.to(lead), K=K, k=k, log_eps=log_eps, full=False)
    return append_totals(slim, _merge_max(e_tot), _merge_max(a_tot))


# ---------------------------------------------------------------------------
# the placer
# ---------------------------------------------------------------------------


def _shards_per_device(mesh: Mesh) -> int:
    """The most distinct model shards one device of the mesh holds (1 on a
    mesh of distinct devices; n_model on a mesh laid on one device). Counted
    over every process's cells, so that every rank decides alike."""
    cells = {(m, mesh.owner(d, m), dev) for d, row in enumerate(mesh.devices)
             for m, dev in enumerate(row)}
    per = {}
    for _, owner, dev in cells:
        per[owner, dev] = per.get((owner, dev), 0) + 1
    return max(per.values())


def _per_device(mesh: Mesh, n_model: int, make) -> list[list | None]:
    """``out[d][m]`` = ``make(m, device)`` for mesh row d and model column m,
    built once per distinct device of each column and shared by its rows;
    ``out[d][m]`` is None for a cell another process holds, ``out[d]`` None
    for a row where this process holds no cell."""
    cache = {}
    out = []
    for d, row in enumerate(mesh.devices):
        local = mesh.local_shards(d)
        if not local:
            out.append(None)
            continue
        cells = []
        for m in range(n_model):
            if m not in local:
                cells.append(None)
                continue
            if (m, row[m]) not in cache:
                cache[(m, row[m])] = make(m, row[m])
            cells.append(cache[(m, row[m])])
        out.append(cells)
    return out


def _agreed_budget(budget: int) -> int:
    """The least budget over the processes, so that every rank takes the
    same route and the collectives stay matched."""
    import torch.distributed as dist

    t = torch.tensor([budget], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _gather_groups(local: dict, tag) -> dict:
    """Every process's ``{group: pack}`` merged, through one all-gather of
    host objects (JAX's ``process_allgather``). ``tag`` names the batch: a
    rank that gathers another batch raises. A failed collective (a peer that
    died) raises :class:`~.mesh.CollectiveError`."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    try:
        dist.all_gather_object(every, (tag, local))
    except (RuntimeError, ConnectionError) as e:
        raise CollectiveError(f"all-gather of the placed batch failed: {e}") from e
    merged = {}
    for their_tag, packs in every:
        if their_tag != tag:
            raise RuntimeError(f"ranks gather different batches: {their_tag} and {tag}; "
                               "every rank must place the same batches in the same order")
        merged.update(packs)
    return merged


class ShardedTorchPlacer(PlacerSurface):
    """Multi-device placer over a :class:`~.mesh.Mesh`, with the
    ``place``/``place_async``/``place_wait`` surface that
    ``engine/pipeline.py::run_pipeline`` drives
    (``engine/surface.py::PlacerSurface``).

    Routing (``ShardedJaxPlacer`` :851-1013):

    * ``dense`` -- the column-sharded dense plane, when ``dense_db`` is "on"
      (a plane over the budget raises ValueError), or "auto" with
      ``accumulate="auto"`` and the plane bytes on one device within the
      budget. JAX's flags pick the plane: shifted when ``plane_mode="shifted"``,
      ``precision="exact"`` and every stored score is >= log10(eps), else the
      classic f32 plane (so ``precision="int16"`` or ``"bf16"`` gives the classic
      f32 plane, as in JAX); the device tokenizer (``tokenize_where``, DNA, k <= 13)
      over the column pair plane when it is shifted, k <= 12 and the pair plane
      fits ``pair_plane_budget`` (or ``pair_plane="on"``), else over the direct
      table. A batch the device tokenizer cannot take (every read shorter than
      k, a read over 65,535 bp), and every batch without it, is tokenized on
      the host (the rows step: any k, and every amino database).
    * ``tiles`` -- otherwise, the column-sharded posting tiles when the
      database takes them (DNA, k <= 13, posting lists of at most 128, scores
      >= log10(eps); ``precision="exact"`` and the device tokenizer) and one
      shard's tiles fit the budget; a batch holding an IUPAC read, reads too
      long for the packed payload's exact sums, or no read of k characters
      goes to the CSR step whole;
    * ``csr`` -- the hash-sharded CSR tables for every batch; with
      ``accumulate="scatter"`` always (JAX's sharded tiles need its matmul
      accumulate), each shard's postings laid out flat over one budget.

    ``accumulate`` "auto" and "matmul" both mean the kernel-backed engines on
    any device; ``tile_payload`` is not read: the payload is packed whenever
    the shard's branch ids fit 15 bits, as in the JAX package.

    The budget is ``config.dense_db_budget``, or what this process's first
    device has free. A device that holds several model shards (a mesh laid on
    one card) holds all their planes, so their bytes add up there.

    On a mesh over several processes (``mesh.init_distributed``) each rank
    builds the shards of the cells it owns and runs their kernels; where a
    data group's shards lie in several processes, the step exchanges the
    shards' partial results within the row (``exchange.py``) and every rank
    of the row merges them alike (``model_exchanges``,
    ``model_exchange_seconds``). ``_fetch`` all-gathers the groups' packs,
    each from its row's lead rank, so every rank returns the whole batch and
    takes the same budget retries (JAX's ``_fetch`` :1302-1314).
    The budget is the least over the ranks, so every rank takes the same
    route. Every rank must place the same batches in the same order."""

    def __init__(self, db, tree, mesh: Mesh, keep_at_most: int | None = None,
                 keep_factor: float | None = None, config: PlacerConfig | None = None):
        super().__init__(db, tree, keep_at_most, keep_factor, config)
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = mesh.shape[MODEL_AXIS]
        cfg = self.config
        #: a retried per-read budget rounds to min_bucket, as in JAX (:1316-1387)
        self._csr_floor = cfg.min_bucket
        #: the device tokenizers, the tiles and the CSR bytes step are DNA-only
        #: (the JAX package's sigma == 4 gates, :892, 984, 1200): an amino
        #: database takes the host-tokenized rows step or the CSR key streams
        self._dna = self.alphabet.sigma == 4
        #: this process's data groups (every group in one process)
        self._local = frozenset(mesh.local_rows)
        #: all-gathers of the data groups' packs across processes, and their time
        self.gathers = 0
        self.gather_seconds = 0.0
        #: the model-axis exchanges of the rows that span processes
        self._exchange = ModelExchange(mesh)
        d0 = min(self._local)
        budget = (device_budget(mesh.devices[d0][mesh.local_shards(d0)[0]])
                  if cfg.dense_db_budget is None else cfg.dense_db_budget)
        if mesh.multi_process:
            budget = _agreed_budget(budget)
        self._bwl = -(-self.B // (128 * self.n_model)) * 128
        # the planes one device holds: column sharding divides the plane
        self._per_dev = _shards_per_device(mesh)
        plane_bytes = (db.num_kmers + 1) * self._bwl * 4 * self._per_dev
        shift_ok = db.scores.size == 0 or float(db.scores.min()) >= float(self.log_eps)
        self._dense_db = cfg.dense_db == "on" or (
            cfg.dense_db == "auto" and cfg.accumulate == "auto" and plane_bytes <= budget)
        self._shifted = self._fast_bytes = self._paired = self._tiles_mode = False
        #: the scatter engine: flat CSR posting budgets, no tiles
        self._flat = cfg.accumulate == "scatter"
        self._tile_scale = 0.0
        self._tile_pt = self._tile_pt_ov = self._tile_n_ov = 0
        self._tile_frac_over = 0.0
        if self._dense_db:
            if cfg.dense_db == "on" and plane_bytes > budget:
                raise ValueError(
                    f"dense_db='on' but the column-sharded plane needs {plane_bytes} bytes "
                    f"on one device ({db.num_kmers + 1} rows x {self._bwl} f32 x "
                    f"{self._per_dev} shard(s)), over the budget of {budget} bytes")
            self._init_dense(budget, shift_ok)
            return
        self._sdb = shard_db_by_hash(db, self.n_model)
        #: per mesh row, per model shard: the CSR step's state on that device
        self._csr = _per_device(mesh, self.n_model, self._sdb.shard_state)
        lens = np.diff(db.row_off)
        max_plen = int(lens.max()) if lens.size else 0
        if (not self._flat and self._dna and self.k <= MAX_DIRECT_K and shift_ok
                and db.num_kmers > 0
                and 0 < max_plen <= MAX_TILE_PLEN and cfg.precision == "exact"
                and cfg.tokenize_where in ("auto", "device")):
            (tiles, bwl_t, PT, t_scale, tiles_ov, PT_OV, n_ov, frac_over,
             perm) = shard_tiles_columns(db, self.n_model, self.B, float(self.log_eps))
            if tiles.nbytes // self.n_model <= budget:
                self._tiles_mode = True
                self._bwl = bwl_t
                self._tile_pt = PT
                self._tile_scale = t_scale
                self._tile_pt_ov = PT_OV
                self._tile_n_ov = n_ov
                self._tile_frac_over = frac_over
                # the two-level permutation (overflow keys -> rows [0, n_ov))
                # rides in the shared direct table
                direct = np.full(4**self.k, db.num_kmers, dtype=np.int32)
                direct[db.keys.astype(np.int64)] = perm.astype(np.int32)
                self._tiles = _per_device(
                    mesh, self.n_model,
                    lambda m, dev: torch.from_numpy(tiles[m].view(np.int32)).to(dev))
                self._tiles_ov = (_per_device(mesh, self.n_model,
                                              lambda m, dev: torch.from_numpy(tiles_ov[m]).to(dev))
                                  if tiles_ov is not None else None)
                self._direct = self._replicated(direct)

    def _replicated(self, table: np.ndarray) -> list[list[torch.Tensor]]:
        """``table`` on every device of the mesh, one copy per device, as
        ``out[d][m]``."""
        t = torch.from_numpy(table)
        by_dev = {}

        def make(_m, dev):
            if dev not in by_dev:
                by_dev[dev] = t.to(dev)
            return by_dev[dev]

        return _per_device(self.mesh, self.n_model, make)

    def _init_dense(self, budget: int, shift_ok: bool) -> None:
        """JAX's dense flags (:865-939) and the column-sharded planes: each
        model shard's plane built on its device (``build_plane_shard``), the
        pair rows after the base rows when the pair plane is taken, and the
        replicated tokenizer table (the combo table or the direct table)."""
        cfg, db = self.config, self.db
        self._shifted = (cfg.plane_mode == "shifted" and cfg.precision == "exact"
                         and shift_ok)
        self._fast_bytes = (cfg.tokenize_where in ("auto", "device") and self._dna
                            and self.k <= MAX_DIRECT_K)
        pairs = None
        if (self._fast_bytes and self._shifted and cfg.pair_plane in ("auto", "on")
                and self.k <= MAX_PAIR_K and db.num_kmers > 0):
            pu, pv, combo = pair_tables(db, self.k)
            n_pairs = int(pu.shape[0])
            paired_bytes = (db.num_kmers + 1 + n_pairs) * self._bwl * 4 * self._per_dev
            pair_budget = budget if cfg.pair_plane_budget is None else cfg.pair_plane_budget
            if n_pairs > 0 and (paired_bytes <= pair_budget or cfg.pair_plane == "on"):
                pairs = (pu, pv, combo)
                self._paired = True
        bwl = self._bwl
        self._planes = _per_device(self.mesh, self.n_model, lambda m, dev: build_plane_shard(
            db, col0=m * bwl, width=bwl, log_eps=self.log_eps, shifted=self._shifted,
            pairs=pairs, device=dev))
        #: the device tokenizer's table per mesh cell: combo (paired) or direct
        self._table = None
        if self._paired:
            self._table = self._replicated(pairs[2])
        elif self._fast_bytes:
            self._table = self._replicated(direct_table(db.keys, self.k, db.num_kmers))

    @property
    def model_exchanges(self) -> int:
        """Model-axis exchanges this process took part in (0 in one process)."""
        return self._exchange.exchanges

    @property
    def model_exchange_seconds(self) -> float:
        return self._exchange.seconds

    @property
    def route(self) -> str:
        """``"dense"`` (every batch on the column-sharded plane), ``"tiles"``
        (clean batches on the posting tiles, the rest on the CSR tables) or
        ``"csr"`` (every batch on the CSR tables)."""
        return "dense" if self._dense_db else "tiles" if self._tiles_mode else "csr"

    def _padded_batch_geometry(self, R_true: int) -> int:
        """Per-data-group read count: a multiple of 64 (256 past 2,048 reads)."""
        per = -(-R_true // self.n_data)
        gran = 256 if R_true > 2048 else 64
        return -(-per // gran) * gran

    # -- the engine's part of the place surface --------------------------------

    def _prepare_dense(self, sequence_map, seqs):
        """Column-sharded dense dispatch (``_place_async_dense`` :1112-1183):
        with the device tokenizer, one packed buffer and the host-tokenized
        ambiguous rows, through the paired or the bytes step; otherwise (no
        device tokenizer, every read shorter than k, a read over 65,535 bp)
        the host tokenizer's plane rows through the rows step. The batch's
        reads split into contiguous groups, one per mesh row."""
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        R_tot = self.n_data * R_loc
        K = self._K()
        kw = dict(B=self.B, K=K, k=self.k, log_eps=float(self.log_eps), eps=float(self.eps))

        def groups(a: np.ndarray) -> list[torch.Tensor]:
            t = torch.from_numpy(a)
            return [t[d * R_loc:(d + 1) * R_loc] for d in range(self.n_data)]

        staged = self._stage_bytes(seqs, R_tot) if self._fast_bytes else None
        if staged is not None:
            buf, arows, Amax, Lmax, m_signed = staged
            kw.update(Amax=Amax, Lmax=Lmax, num_kmers=self.db.num_kmers)
            step = (functools.partial(sharded_dense_paired_step, **kw) if self._paired
                    else functools.partial(sharded_dense_bytes_step, shifted=self._shifted,
                                           **kw))
            bufs, arows_g = groups(buf), groups(arows)

            def launch_bytes() -> _Pending:
                out = self._run_groups(lambda d, x: step(self._planes[d], self._table[d],
                                                         bufs[d], arows_g[d], exchange=x))
                return _Pending(sequence_map, seqs, m_signed, out, K)

            return "dense.bytes", launch_bytes
        tokens = self._tokenize(seqs)
        m_signed = tokens.seq_lengths - self.k + 1  # int64, may be negative
        ex, am = tokens.exact_read, tokens.amb_read
        # JAX pads the window columns to a multiple of 16 (its jit cache);
        # extra zero-row slots add nothing to a sum
        Wmax = max(1, int(np.bincount(ex, minlength=R_tot).max()) if ex.size else 1)
        Amax = _bucket(int(np.bincount(am).max()), 8) if am.size else 0
        rows = self._rows_matrix(tokens.exact_keys, ex, R_tot, Wmax)
        arows = self._rows_matrix(tokens.amb_keys, am, R_tot, Amax)
        m_pad = np.zeros(R_tot, np.float32)
        m_pad[:R_true] = wrapped_m(m_signed)
        step = functools.partial(sharded_dense_rows_step, Amax=Amax,
                                 zero_row=self.db.num_kmers, shifted=self._shifted, **kw)
        rows_g, arows_g, m_g = groups(rows), groups(arows), groups(m_pad)

        def launch_rows() -> _Pending:
            out = self._run_groups(lambda d, x: step(self._planes[d], rows_g[d], arows_g[d],
                                                     m_g[d], exchange=x))
            return _Pending(sequence_map, seqs, m_signed, out, K)

        return "dense.host", launch_rows

    def _prepare_tiles(self, sequence_map, seqs):
        """Column-sharded tile dispatch; None for a batch the tile step cannot
        take (an IUPAC read, reads too long for the packed payload, no read
        of k characters): the CSR step takes it whole."""
        gate = self._read_lengths(seqs)
        if gate is None:
            return None
        lens_arr, Lmax = gate
        R_loc = self._padded_batch_geometry(len(seqs))
        W = Lmax - self.k + 1
        # packed exactness gate: per-(read, branch) integer sums are bounded
        # by W * 64000 and must stay < 2**24 for exact f32 sums
        if self._tile_scale > 0.0 and W * Q_MAX >= 1 << 24:
            return None
        buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, self.n_data * R_loc)
        if amb_mask.any():
            return None  # ambiguity: the CSR step handles quirks Q6/Q7
        buf_t = torch.from_numpy(buf)
        step = functools.partial(
            sharded_tiles_bytes_step, B=self.B, bwl=self._bwl, K=self._K(), k=self.k,
            Lmax=Lmax, num_kmers=self.db.num_kmers, PT=self._tile_pt,
            log_eps=float(self.log_eps), tile_scale=float(self._tile_scale),
            PT_OV=self._tile_pt_ov, N_OV=self._tile_n_ov)

        def run(OV: int) -> list[torch.Tensor | None]:
            return self._run_groups(lambda d, x: step(
                self._tiles[d], self._direct[d], buf_t[d * R_loc:(d + 1) * R_loc],
                self._tiles_ov[d] if self._tiles_ov else None, OV=OV, exchange=x))

        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        if self._tile_pt_ov == 0:
            return "tiles", lambda: _Pending(sequence_map, seqs, m_signed, run(0), self._K())
        # static overflow-window budget: expected overflow windows per read
        # x2 safety, bucketed; place_wait retries on a read above it
        OV = min(W, _bucket(max(8, int(W * self._tile_frac_over * 2.0) + 4), 8))
        return "tiles", lambda: _Pending(sequence_map, seqs, m_signed, run(OV), self._K(),
                                         ("tiles_ov", OV, lambda ov: run(min(ov, W))))

    def _prepare_csr(self, sequence_map, seqs):
        """Hash-sharded CSR dispatch: clean DNA batches through the bytes
        step (``csr.bytes``), the rest through host-staged key streams."""
        cfg = self.config
        R_loc = self._padded_batch_geometry(len(seqs))
        R_tot = self.n_data * R_loc
        K = self._K()
        est = max(1, int(self._sdb.avg_plen * cfg.budget_headroom))
        gate = self._read_lengths(seqs) if self._dna and self.k <= _MAX_BYTES_K else None
        if gate is not None:
            lens_arr, Lmax = gate
            buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R_tot)
            if not amb_mask.any():
                W = Lmax - self.k + 1
                # per-read (flat: per-group) posting budget, each shard owning
                # ~1/n_model of it
                Pb = (_bucket(max(1, R_loc * W * est // self.n_model), cfg.min_bucket)
                      if self._flat else
                      _bucket(max(512, W * est // self.n_model), max(cfg.min_bucket, 512)))
                buf_t = torch.from_numpy(buf)
                step = functools.partial(sharded_csr_bytes_step, R=R_loc, B=self.B, K=K,
                                         k=self.k, Lmax=Lmax, log_eps=float(self.log_eps),
                                         flat=self._flat)

                def run_bytes(Pb_: int, _PAb: int) -> list[torch.Tensor | None]:
                    return self._run_groups(lambda d, x: step(
                        self._csr[d], buf_t[d * R_loc:(d + 1) * R_loc], Pb=Pb_, exchange=x))

                return "csr.bytes", lambda: _Pending(sequence_map, seqs, lens_arr - self.k + 1,
                                                     run_bytes(Pb, 0), K,
                                                     ("csr", Pb, 0, run_bytes))

        groups = [seqs[g * R_loc:(g + 1) * R_loc] for g in range(self.n_data)]
        toks = [self._tokenize(g) for g in groups]
        m_signed = np.concatenate([t.seq_lengths - self.k + 1 for t in toks])
        E = _bucket(max(t.exact_keys.shape[0] for t in toks), cfg.min_bucket)
        A = _bucket(max(t.amb_keys.shape[0] for t in toks), cfg.min_bucket)
        if self._flat:
            Pb = _bucket(max(1, E * est // self.n_model), cfg.min_bucket)
        else:
            wpr = max((int(np.bincount(t.exact_read).max()) if t.exact_read.size else 1)
                      for t in toks)
            Pb = _bucket(max(512, wpr * est // self.n_model), max(cfg.min_bucket, 512))
        PAb = _bucket(max(1, A * est // self.n_model), cfg.min_bucket)

        def i64(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.astype(np.int64))

        def stage_group(t):
            e_hi, e_lo = pad_u64_split(t.exact_keys, E)
            a_hi, a_lo = pad_u64_split(t.amb_keys, A)
            m_f32 = wrapped_m(t.seq_lengths - self.k + 1)
            m_pad = np.zeros(R_loc, np.float32)
            m_pad[: m_f32.shape[0]] = m_f32
            return (i64(e_hi), i64(e_lo), i64(pad_i32(t.exact_read, E, R_loc)),
                    i64(a_hi), i64(a_lo), i64(pad_i32(t.amb_read, A, R_loc)),
                    i64(pad_i32(t.amb_order, A, ORDER_INF)), torch.from_numpy(m_pad))

        staged = [stage_group(t) for t in toks]
        step = functools.partial(sharded_csr_step, R=R_loc, B=self.B, K=K, k=self.k,
                                 log_eps=float(self.log_eps), eps=float(self.eps),
                                 flat=self._flat)

        def run(Pb_: int, PAb_: int) -> list[torch.Tensor | None]:
            return self._run_groups(lambda d, x: step(self._csr[d], *staged[d], Pb=Pb_, PAb=PAb_,
                                                      exchange=x))

        return "csr", lambda: _Pending(sequence_map, seqs, m_signed, run(Pb, PAb), K,
                                       ("csr", Pb, PAb, run))

    def _run_groups(self, step) -> list[torch.Tensor | None]:
        """``step(d, exchange)`` for each data group d this process holds a
        shard of, in group order, with the row's model-axis exchange (None
        where the row lies in this process); None for the other groups."""
        return [step(d, self._exchange.row(d)) if d in self._local else None
                for d in range(self.n_data)]

    def _fetch(self, out: list[torch.Tensor | None], seqs) -> np.ndarray:
        """The data groups' packs as one (n_data, rows, width) host array. On
        a mesh over several processes each row's lead rank holds its pack
        (every rank of the row merged the same one); an all-gather gives
        every rank the whole batch, so that each rank assembles it and
        decides the budget retries alike. The batch is known to every rank
        by its distinct reads' count and its first read (``seqs``)."""
        rank = self.mesh.rank
        packs = {d: o.cpu().numpy() for d, o in enumerate(out)
                 if o is not None and self.mesh.lead(d) == rank}
        if self.mesh.multi_process:
            t0 = time.perf_counter()
            packs = _gather_groups(packs, (len(seqs), zlib.crc32(seqs[0])))
            with self._retry_lock:
                self.gather_seconds += time.perf_counter() - t0
                self.gathers += 1
        return np.stack([packs[d] for d in range(self.n_data)])
