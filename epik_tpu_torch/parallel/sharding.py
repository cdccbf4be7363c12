"""Multi-device placement of the port: data-parallel reads x column-sharded tiles.

Ports the big-tree mode of ``epik_tpu/parallel/sharding.py``:

* database partitioning, copied as numpy: :func:`shard_tiles_columns`
  (:135-236), the column-sharded posting tiles with their two-level
  main/overflow split, and :func:`shard_db_by_hash` (:250-313), the
  hash-sharded cuckoo tables and postings of the CSR step;
* the column finish (:345-400) as torch ops over a list of per-shard
  ``(R, bwl)`` tensors: ``psum`` becomes a sum over the shards in shard order,
  ``pmax``/``pmin`` a maximum/minimum, ``all_gather`` a concatenation in shard
  order;
* the steps: :func:`sharded_tiles_bytes_step` (``_sharded_tiles_bytes_step``
  :530-626, kernel 3's sums alone or kernel 4), :func:`sharded_csr_bytes_step`
  (:745-802) and :func:`sharded_csr_step` (:675-737), both through kernel 4
  with counts; each runs one data group (one mesh row) over its model shards;
* :class:`ShardedTorchPlacer` (``ShardedJaxPlacer`` :810-1410), its routing,
  dispatch, budget retries and assembly.

The column-sharded dense steps (:421, :479, :634) are not ported yet:
ROADMAP.md queue 1 item 9a. The JAX package's ``_pad_split``/``_pad_i32``
(:1413-1425) are ``engine/staging.py``'s ``pad_u64_split``/``pad_i32``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading

import numpy as np
import torch

from ..core.alphabet import get_alphabet
from ..core.scoring import score_threshold
from ..engine.config import PlacerConfig, check_supported, device_budget
from ..engine.outputs import _Pending, assemble_arrays, unpack_outputs_slim
from ..engine.placer import _MAX_DIRECT_K, _MAX_READ_LEN, _MAX_TILE_PLEN
from ..engine.staging import HostStaging, _bucket, _bucket_lmax, pad_i32, pad_u64_split
from ..engine.state import CsrState
from ..engine.step import _m_f32
from ..engine.tiles import Q_MAX
from ..engine.types import PlacedCollection
from ..kernels.accumulate_packed import MAX_PACKED_BRANCHES, accumulate_packed_sums, tile_width
from ..kernels.accumulate_sums import accumulate_sums
from ..kernels.finish import POW10_ZERO
from ..ops.csr import (
    ORDER_INF,
    accumulate_amb_firsthit,
    accumulate_exact_dense,
    append_totals,
    finish_scores,
)
from ..ops.hashtable import BUCKET, _next_pow2, build_table
from ..ops.tokenize import tokenize_core, tokenize_packed
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

__all__ = ["ShardedTorchPlacer", "finish_scores_cols_shifted", "shard_db_by_hash",
           "shard_tiles_columns", "sharded_csr_bytes_step", "sharded_csr_step",
           "sharded_tiles_bytes_step"]

#: largest k whose window keys fit the CSR bytes step's 32-bit low word
_MAX_BYTES_K = 16
#: tile cells per read are trash-padded to a multiple of this
_CH = 512
_NOT_PORTED_DENSE = "ROADMAP.md queue 1 item 9a"


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


def _f32(x: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor on ``device``: PyTorch's CUDA ops with a CPU scalar
    divide by multiplying with the reciprocal, which rounds differently."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def _top(x: torch.Tensor, n: int):
    """The n largest of each row, ties to the lowest index (as
    ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def finish_scores_cols_shifted(Sps: list[torch.Tensor], m_f32: torch.Tensor, *, B: int,
                               K: int, k: int, log_eps: float):
    """Column-sharded finish from the shards' SHIFTED sums S' = S - C*log_eps,
    each (R, bwl) on its shard's device (padded columns stay untouched).
    Per-branch counts are never materialized (reported as -1). Returns
    (scores, idx, counts, wr, n, zero_sum, log_sum) on the first shard's
    device."""
    corrected, touched = [], []
    for Sp in Sps:
        dev = Sp.device
        t = Sp > 0
        c = (Sp + m_f32.to(dev)[:, None] * _f32(log_eps, dev)) / _f32(float(k), dev)
        corrected.append(torch.where(t, c, _f32(-math.inf, dev)))
        touched.append(t)
    return _lwr_topk_cols(corrected, touched, m_f32, B=B, K=K, k=k, log_eps=log_eps)


def _lwr_topk_cols(corrected, touched, m_f32, *, B: int, K: int, k: int, log_eps: float):
    """The column-sharded LWR over all B branches and the distributed top-K:
    per-read scalars merge over the shards, then each shard's Kl = min(K,
    bwl) candidates (global column ids), in shard order, go through one more
    top-K. Shards in column order and each shard's candidates in ascending
    local index keep the lowest-global-index tie-break."""
    lead = corrected[0].device
    f32 = torch.float32
    neg_inf = _f32(-math.inf, lead)
    ln10 = _f32(math.log(10.0), lead)
    m = m_f32.to(lead).to(f32)

    n = sum(t.sum(dim=1, dtype=torch.int32).to(lead) for t in touched)
    npl_exp = m * _f32(log_eps, lead) / _f32(float(k), lead)
    n_not = float(B) - n.to(f32)
    max_c = functools.reduce(torch.maximum, [c.max(dim=1).values.to(lead) for c in corrected])
    max_t = torch.maximum(max_c, torch.where(n_not > 0, npl_exp, neg_inf))
    partial = []
    for c, t in zip(corrected, touched):
        dev = c.device
        terms = torch.where(t, torch.exp((c - max_t.to(dev)[:, None]) * ln10.to(dev)),
                            _f32(0.0, dev))
        partial.append(terms.sum(dim=1).to(lead))
    sum10 = functools.reduce(torch.add, partial) + n_not * torch.exp(
        torch.where(n_not > 0, (npl_exp - max_t) * ln10, neg_inf))
    log_sum = max_t + torch.log(sum10) / ln10
    zero_sum = (max_c < POW10_ZERO) & ((npl_exp < POW10_ZERO) | (n_not <= 0))

    bwl = corrected[0].shape[1]
    Kl = min(K, bwl)
    cand_s, cand_i = [], []
    for s, c in enumerate(corrected):
        vals, idx = _top(c, Kl)
        cand_s.append(vals.to(lead))
        cand_i.append(idx.to(lead) + s * bwl)
    top_s, sel = _top(torch.cat(cand_s, dim=1), K)
    top_i = torch.gather(torch.cat(cand_i, dim=1), 1, sel)
    counts = torch.full(top_i.shape, -1, dtype=torch.int32, device=lead)
    wr = torch.exp((top_s - log_sum[:, None]) * ln10)
    wr = torch.where(zero_sum[:, None] | (top_s < POW10_ZERO), _f32(0.0, lead), wr)
    return top_s, top_i, counts, wr, n, zero_sum, log_sum


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


def sharded_tiles_bytes_step(tiles, direct, buf, tiles_ov=None, *, B: int, bwl: int,
                             K: int, k: int, Lmax: int, num_kmers: int, PT: int,
                             log_eps: float, tile_scale: float = 0.0, PT_OV: int = 0,
                             OV: int = 0, N_OV: int = 0) -> torch.Tensor:
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
    ``PT_OV > 0`` (the host retries with a bigger OV when it exceeds OV)."""
    trash = tile_width(bwl) - 1
    tok = {}
    Sps = []
    for s, til in enumerate(tiles):
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
    rows, lens = tok[tiles[0].device]
    outs = finish_scores_cols_shifted(Sps, _m_f32(lens, k), B=B, K=K, k=k, log_eps=log_eps)
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


def sharded_csr_bytes_step(shards: list[CsrState], buf, *, R: int, B: int, K: int,
                           Pb: int, k: int, Lmax: int, log_eps: float) -> torch.Tensor:
    """Hash-sharded CSR step with on-device tokenization, for one data group
    of clean DNA reads: every shard looks up the full key stream of the
    group's packed reads ``buf`` in its own table (a key misses everywhere but
    its owner; invalid windows take the all-ones sentinel key, which misses
    too), lays its postings out per read in ``Pb`` cells and sums them with
    kernel 4 with counts; S and C merge over the shards, then the counts
    finish. Returns the (R+1, 2K+3) slim pack with the largest per-read
    posting count in its totals row."""
    tok = {}
    S, C, e_tot = [], [], []
    for st in shards:
        dev = st.table.device
        if dev not in tok:
            key, ok, _, lens = tokenize_core(buf.to(dev), k=k, Lmax=Lmax)
            W = key.shape[1]
            e_hi = torch.where(ok, 0, 0xFFFFFFFF).reshape(-1)
            e_lo = torch.where(ok, key, 0xFFFFFFFF).reshape(-1)
            e_read = torch.arange(R, dtype=torch.int64, device=dev).repeat_interleave(W)
            tok[dev] = (e_hi, e_lo, e_read, lens)
        e_hi, e_lo, e_read, _ = tok[dev]
        S_s, C_s, e_s = accumulate_exact_dense(st.table, st.seed1, st.seed2, st.post_b,
                                               st.post_s, st.row_off, e_hi, e_lo, e_read,
                                               R=R, B=B, PP=Pb)
        S.append(S_s)
        C.append(C_s)
        e_tot.append(e_s)
    lens = tok[shards[0].table.device][3]
    outs = finish_scores(_merge_sum(S), _merge_sum(C), _m_f32(lens, k), K=K, k=k,
                         log_eps=log_eps)
    return append_totals(_pack_slim(outs), _merge_max(e_tot), 0)


def sharded_csr_step(shards: list[CsrState], e_hi, e_lo, e_read, a_hi, a_lo, a_read,
                     a_order, m_f32, *, R: int, B: int, K: int, Pb: int, PAb: int, k: int,
                     log_eps: float, eps: float) -> torch.Tensor:
    """Hash-sharded CSR step on host-staged key streams, for one data group:
    per shard the exact postings (kernel 4 with counts, per-read budget Pb)
    and the ambiguous first hit (budget PAb); S and C merge by sum, the first
    hit by minimum over processing order plus a sum of V masked to the
    shard that owns it (each key lives on exactly one shard). Returns the
    (R+1, 2K+3) slim pack with both budget totals in its last row."""
    S, C, firsts, Vs, e_tot, a_tot = [], [], [], [], [], []
    for st in shards:
        dev = st.table.device
        S_s, C_s, e_s = accumulate_exact_dense(
            st.table, st.seed1, st.seed2, st.post_b, st.post_s, st.row_off, e_hi.to(dev),
            e_lo.to(dev), e_read.to(dev), R=R, B=B, PP=Pb)
        first, V, a_s = accumulate_amb_firsthit(
            st.table, st.seed1, st.seed2, st.post_b, st.post_s, st.row_off, a_hi.to(dev),
            a_lo.to(dev), a_read.to(dev), a_order.to(dev), R=R, B=B, PA=PAb, k=k, eps=eps)
        for acc, x in ((S, S_s), (C, C_s), (firsts, first), (Vs, V), (e_tot, e_s),
                       (a_tot, a_s)):
            acc.append(x)
    lead = shards[0].table.device
    S, C = _merge_sum(S), _merge_sum(C)
    first_g = functools.reduce(torch.minimum, [f.to(lead) for f in firsts])
    hit = first_g < ORDER_INF
    zero = _f32(0.0, lead)
    V_g = _merge_sum([torch.where((f.to(lead) == first_g) & hit, V.to(lead), zero)
                      for f, V in zip(firsts, Vs)])
    S = S + torch.where(hit, V_g, zero)
    C = C + hit.to(torch.int32)
    outs = finish_scores(S, C, m_f32.to(lead), K=K, k=k, log_eps=log_eps)
    return append_totals(_pack_slim(outs), _merge_max(e_tot), _merge_max(a_tot))


# ---------------------------------------------------------------------------
# the placer
# ---------------------------------------------------------------------------


def _per_device(mesh: Mesh, n_model: int, make) -> list[list]:
    """``out[d][m]`` = ``make(m, device)`` for mesh row d and model column m,
    built once per distinct device of each column and shared by its rows."""
    cache = {}
    out = []
    for row in mesh.devices:
        cells = []
        for m in range(n_model):
            if (m, row[m]) not in cache:
                cache[(m, row[m])] = make(m, row[m])
            cells.append(cache[(m, row[m])])
        out.append(cells)
    return out


class ShardedTorchPlacer(HostStaging):
    """Multi-device placer over a :class:`~.mesh.Mesh`, with the
    ``place``/``place_async``/``place_wait`` surface that
    ``engine/pipeline.py::run_pipeline`` drives.

    Routing (``ShardedJaxPlacer`` :851-1013): the column-sharded dense plane
    when ``dense_db`` is "on", or "auto" with ``accumulate="auto"`` and a
    per-device plane within the budget -- not ported yet, so that raises
    ``NotImplementedError``; otherwise the hash-sharded CSR tables, and the
    column-sharded posting tiles when the database takes them (DNA, k <= 13,
    posting lists of at most 128, scores >= log10(eps); ``precision="exact"``
    and the device tokenizer) and one shard's tiles
    fit the budget. A batch holding an IUPAC read, reads too long for the
    packed payload's exact sums, or no read of k characters goes to the CSR
    step whole. ``accumulate`` "auto" and "matmul" both mean the kernel-backed
    engines on any device; ``tile_payload`` is not read: the payload is packed
    whenever the shard's branch ids fit 15 bits, as in the JAX package.

    The budget is ``config.dense_db_budget``, or what the mesh's first device
    has free."""

    def __init__(self, db, tree, mesh: Mesh, keep_at_most: int | None = None,
                 keep_factor: float | None = None, config: PlacerConfig | None = None):
        self.db = db
        self.tree = tree
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        self.n_model = mesh.shape[MODEL_AXIS]
        # copy: never mutate a caller-supplied config; explicit kwargs win
        self.config = dataclasses.replace(config) if config else PlacerConfig()
        if keep_at_most is not None:
            self.config.keep_at_most = keep_at_most
        if keep_factor is not None:
            self.config.keep_factor = keep_factor
        check_supported(self.config)
        self.alphabet = get_alphabet(db.sequence_type)
        if self.alphabet.sigma != 4:
            raise NotImplementedError(
                "amino databases are not ported yet: ROADMAP.md queue 1 item 8")
        self.k = db.kmer_size
        self.B = tree.get_node_count()
        self._init_staging()
        #: budget-overflow re-dispatches (the tiles' OV, the CSR steps' Pb/PAb)
        self.overflow_retries = 0
        self._retry_lock = threading.Lock()
        self.eps = np.float32(score_threshold(db.omega, self.k, self.alphabet.sigma))
        self.log_eps = np.float32(np.log10(self.eps))
        num, tot = tree.tree_index()
        self.distal = tree.branch_lengths / 2.0
        mean = np.where(num > 1, tot / np.maximum(num, 1), 0.0)
        self.pendant = mean + self.distal

        cfg = self.config
        budget = (device_budget(mesh.devices[0][0]) if cfg.dense_db_budget is None
                  else cfg.dense_db_budget)
        bwl = -(-self.B // (128 * self.n_model)) * 128
        # per-DEVICE plane bytes decide fit: column sharding divides the plane
        plane_bytes = (db.num_kmers + 1) * bwl * 4
        if cfg.dense_db == "on" or (cfg.dense_db == "auto" and cfg.accumulate == "auto"
                                    and plane_bytes <= budget):
            raise NotImplementedError(
                f"the column-sharded dense plane ({plane_bytes} bytes per device) is "
                f"not ported yet: {_NOT_PORTED_DENSE}; PlacerConfig(dense_db='off') "
                "takes the column-sharded posting tiles")
        self._sdb = shard_db_by_hash(db, self.n_model)
        #: per mesh row, per model shard: the CSR step's state on that device
        self._csr = _per_device(mesh, self.n_model, self._sdb.shard_state)
        self._tiles_mode = False
        self._bwl = bwl
        self._tile_scale = 0.0
        self._tile_pt = self._tile_pt_ov = self._tile_n_ov = 0
        self._tile_frac_over = 0.0
        lens = np.diff(db.row_off)
        max_plen = int(lens.max()) if lens.size else 0
        shift_ok = db.scores.size == 0 or float(db.scores.min()) >= float(self.log_eps)
        if (self.k <= _MAX_DIRECT_K and shift_ok and db.num_kmers > 0
                and 0 < max_plen <= _MAX_TILE_PLEN and cfg.precision == "exact"
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
                direct_t = torch.from_numpy(direct)
                by_dev = {}

                def replicated(_m, dev):
                    if dev not in by_dev:
                        by_dev[dev] = direct_t.to(dev)
                    return by_dev[dev]

                self._tiles = _per_device(
                    mesh, self.n_model,
                    lambda m, dev: torch.from_numpy(tiles[m].view(np.int32)).to(dev))
                self._tiles_ov = (_per_device(mesh, self.n_model,
                                              lambda m, dev: torch.from_numpy(tiles_ov[m]).to(dev))
                                  if tiles_ov is not None else None)
                self._direct = _per_device(mesh, self.n_model, replicated)

    @property
    def route(self) -> str:
        """``"tiles"`` (clean batches on the posting tiles, the rest on the
        CSR tables) or ``"csr"`` (every batch on the CSR tables)."""
        return "tiles" if self._tiles_mode else "csr"

    def _padded_batch_geometry(self, R_true: int) -> int:
        """Per-data-group read count: a multiple of 64 (256 past 2,048 reads)."""
        per = -(-R_true // self.n_data)
        gran = 256 if R_true > 2048 else 64
        return -(-per // gran) * gran

    def _K(self) -> int:
        return min(self.config.keep_at_most, self.B)

    # -- the place surface ----------------------------------------------------

    def place(self, records: list[tuple[str, bytes]]) -> PlacedCollection:
        """Synchronous place (reference surface: place.cpp:201)."""
        return self.place_wait(self.place_async(records))

    def place_async(self, records: list[tuple[str, bytes]]) -> _Pending:
        """Stage a batch and enqueue its device steps without waiting."""
        sequence_map: dict[bytes, list[str]] = {}
        for header, seq in records:
            sequence_map.setdefault(seq, []).append(header)
        seqs = list(sequence_map.keys())
        if not seqs:
            return _Pending(sequence_map, [], None, None, self._K())
        if self._tiles_mode:
            pending = self._place_async_tiles(sequence_map, seqs)
            if pending is not None:
                return pending
        return self._place_async_csr(sequence_map, seqs)

    def _place_async_tiles(self, sequence_map, seqs):
        """Column-sharded tile dispatch; None for a batch the tile step cannot
        take (an IUPAC read, reads too long for the packed payload, no read
        of k characters): the CSR step takes it whole."""
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        Lmax_true = int(lens_arr.max())
        if not self.k <= Lmax_true <= _MAX_READ_LEN:
            return None
        Lmax = _bucket_lmax(Lmax_true)
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

        def run(OV: int) -> list[torch.Tensor]:
            return [step(self._tiles[d], self._direct[d], buf_t[d * R_loc:(d + 1) * R_loc],
                         self._tiles_ov[d] if self._tiles_ov else None, OV=OV)
                    for d in range(self.n_data)]

        m_signed = lens_arr - self.k + 1  # host copy for assembly (quirk Q1)
        if self._tile_pt_ov == 0:
            return _Pending(sequence_map, seqs, m_signed, run(0), self._K())
        # static overflow-window budget: expected overflow windows per read
        # x2 safety, bucketed; place_wait retries on a read above it
        OV = min(W, _bucket(max(8, int(W * self._tile_frac_over * 2.0) + 4), 8))
        return _Pending(sequence_map, seqs, m_signed, run(OV), self._K(),
                        ("tiles_ov", OV, lambda ov: run(min(ov, W))))

    def _place_async_csr(self, sequence_map, seqs) -> _Pending:
        """Hash-sharded CSR dispatch: clean DNA batches through the bytes
        step, the rest through host-staged key streams."""
        cfg = self.config
        R_true = len(seqs)
        R_loc = self._padded_batch_geometry(R_true)
        R_tot = self.n_data * R_loc
        K = self._K()
        nd = self.n_data
        est = max(1, int(self._sdb.avg_plen * cfg.budget_headroom))
        lens_arr = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
        Lmax_true = int(lens_arr.max())
        if self.k <= _MAX_BYTES_K and self.k <= Lmax_true <= _MAX_READ_LEN:
            Lmax = _bucket_lmax(Lmax_true)
            buf, amb_mask = self._pack_reads_fast(seqs, lens_arr, Lmax, R_tot)
            if not amb_mask.any():
                W = Lmax - self.k + 1
                # per-read posting budget, each shard owning ~1/n_model of it
                Pb = _bucket(max(512, W * est // self.n_model), max(cfg.min_bucket, 512))
                buf_t = torch.from_numpy(buf)
                step = functools.partial(sharded_csr_bytes_step, R=R_loc, B=self.B, K=K,
                                         k=self.k, Lmax=Lmax, log_eps=float(self.log_eps))

                def run_bytes(Pb_: int, _PAb: int) -> list[torch.Tensor]:
                    return [step(self._csr[d], buf_t[d * R_loc:(d + 1) * R_loc], Pb=Pb_)
                            for d in range(nd)]

                return _Pending(sequence_map, seqs, lens_arr - self.k + 1, run_bytes(Pb, 0),
                                K, ("csr", Pb, 0, run_bytes))

        groups = [seqs[g * R_loc:(g + 1) * R_loc] for g in range(nd)]
        toks = [self._tokenize(g) for g in groups]
        m_signed = np.concatenate([t.seq_lengths - self.k + 1 for t in toks])
        E = _bucket(max(t.exact_keys.shape[0] for t in toks), cfg.min_bucket)
        A = _bucket(max(t.amb_keys.shape[0] for t in toks), cfg.min_bucket)
        wpr = max((int(np.bincount(t.exact_read).max()) if t.exact_read.size else 1)
                  for t in toks)
        Pb = _bucket(max(512, wpr * est // self.n_model), max(cfg.min_bucket, 512))
        PAb = _bucket(max(1, A * est // self.n_model), cfg.min_bucket)

        def i64(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.astype(np.int64))

        def stage_group(t):
            e_hi, e_lo = pad_u64_split(t.exact_keys, E)
            a_hi, a_lo = pad_u64_split(t.amb_keys, A)
            ms = t.seq_lengths - self.k + 1
            m_f32 = np.where(ms >= 0, ms.astype(np.float32),
                             np.float32(float(1 << 64)) + ms.astype(np.float32))
            m_pad = np.zeros(R_loc, np.float32)
            m_pad[: m_f32.shape[0]] = m_f32
            return (i64(e_hi), i64(e_lo), i64(pad_i32(t.exact_read, E, R_loc)),
                    i64(a_hi), i64(a_lo), i64(pad_i32(t.amb_read, A, R_loc)),
                    i64(pad_i32(t.amb_order, A, ORDER_INF)), torch.from_numpy(m_pad))

        staged = [stage_group(t) for t in toks]
        step = functools.partial(sharded_csr_step, R=R_loc, B=self.B, K=K, k=self.k,
                                 log_eps=float(self.log_eps), eps=float(self.eps))

        def run(Pb_: int, PAb_: int) -> list[torch.Tensor]:
            return [step(self._csr[d], *staged[d], Pb=Pb_, PAb=PAb_) for d in range(nd)]

        return _Pending(sequence_map, seqs, m_signed, run(Pb, PAb), K, ("csr", Pb, PAb, run))

    # -- wait + assembly ------------------------------------------------------

    @staticmethod
    def _fetch(out: list[torch.Tensor]) -> np.ndarray:
        """The data groups' packs as one (n_data, rows, width) host array."""
        return np.stack([o.cpu().numpy() for o in out])

    def _count_retry(self) -> None:
        with self._retry_lock:  # the pipeline waits on batches from several threads
            self.overflow_retries += 1

    def place_wait(self, pending: _Pending) -> PlacedCollection:
        """Fetch a batch's packs, re-running its steps while a static budget
        was too small (``ShardedJaxPlacer.place_wait`` :1316-1387), and
        assemble its jplace rows."""
        if pending.out is None:
            return PlacedCollection(sequence_map=pending.sequence_map, placed_seqs=[])
        R_true = len(pending.seqs)
        arr = self._fetch(pending.out)
        budget = pending.budget
        if budget is None:
            body = arr
        elif budget[0] == "tiles_ov":
            # the last column carries each read's true overflow-window count
            _, OV, rerun = budget
            while int(arr[:, :, -1].max()) > OV:
                self._count_retry()
                OV = _bucket(int(arr[:, :, -1].max()), 8)  # rerun clamps to W
                arr = self._fetch(rerun(OV))
            body = arr[:, :, :-1]
        else:
            # the last row carries the budget totals in 20-bit halves; a hot
            # shard (skewed posting lengths) overflows the uniform estimate
            _, Pb, PAb, rerun = budget
            while True:
                totals = arr[:, -1, :].astype(np.int64)
                e_tot = int(((totals[:, 0] << 20) + totals[:, 1]).max())
                a_tot = int(((totals[:, 2] << 20) + totals[:, 3]).max())
                if e_tot <= Pb and a_tot <= PAb:
                    break
                self._count_retry()
                Pb = _bucket(e_tot, self.config.min_bucket) if e_tot > Pb else Pb
                PAb = _bucket(a_tot, self.config.min_bucket) if a_tot > PAb else PAb
                arr = self._fetch(rerun(Pb, PAb))
            body = arr[:, :-1, :]
        return self._assemble_flat(pending, body.reshape(-1, body.shape[2])[:R_true])

    def _assemble_flat(self, pending: _Pending, flat: np.ndarray) -> PlacedCollection:
        """Array-backed jplace rows from the batch's (R_true, 2K+3) slim pack
        (the shared vectorised assembly of ``engine/outputs.py``)."""
        K = pending.K
        scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, _, _ = unpack_outputs_slim(
            flat, K)
        return assemble_arrays(
            pending.seqs, pending.sequence_map, pending.m_signed,
            scores_k, idx_k, counts_k, wr_k, n_touched, zero_sum, K,
            distal=self.distal, pendant=self.pendant, log_eps=self.log_eps,
            k=self.k, B=self.B, keep_at_most=self.config.keep_at_most,
            keep_factor=self.config.keep_factor,
        )
