#!/usr/bin/env python3
"""CUDA-event times of the port's device steps and kernels, for this checkout
of the port or another one, on one card.

    python3 step_times.py [--repo PATH] [--profile] [--only d652]

On ``chip_smoke.py``'s D652 database (652 leaves, 1,303 branches, k = 10) with
its first batch of 16,384 reads (IUPAC reads among them), and
``TorchPlacer`` on the dense route, it times:

* the dense device step;
* the slot tokenizer's kernel (``tokenize_combo_fused``) and the torch ops
  it replaces (``tokenize_combo`` + ``window_counts``), on the batch and on its
  first 2,000 reads (the benchmark cell's batch);
* the gather alone (``rowgather_sum``) and the finish alone (``finish_topk``)
  on its sums, and their sum: what the dense step ran before the fusion;
  where the gather takes a read order, also the gather in locality order,
  its sort included, and the sort (``locality_order``) alone;
* the fused kernel (``rowgather_sum_topk``) and, on the same rows, its
  unfused pair (the gather in the step's order, the delta add,
  ``finish_topk``), and the dense step with the width rule
  (``kernels/rowgather.py::shifted_fused``) set to each route in turns,
  where the port has the rule (``dense_step_by_route``; the sharded shifted
  step's likewise, ``d652_sharded_step_by_route``);
* under ``pair_plane="off"``, ``precision="int16"``, ``plane_mode="classic"``
  and ``precision="bf16"`` (each its own plane), the unpaired dense step
  (``place_batch_dense_bytes``) and the kernel it ends in
  (``rowgather_sum_topk``, ``rowgather_sum_topk_int16``, and on the classic
  planes ``rowgather_sum_counts_topk`` and ``_bf16``, or in a port without
  them ``rowgather_sum_counts`` and ``_bf16``; the shifted kernels from the
  call at the step's router, and beside them their unfused pair and the
  route the step took), and on the same rows the
  gather apart: with counts (kernel 1c, ``rowgather_sum_counts`` and
  ``_bf16``) on the classic planes, alone (kernel 1d, ``rowgather_sum``) on
  the int16 plane; on the classic planes also the unfused pair of the fused
  counts kernel (1c, the first hits added, ``finish_topk_counts``) and that
  finish alone on 1c's sums;
* with ``lookup_where="device"`` (the classic plane), the step the batch
  takes (the device tokenizer's, or ``place_batch_device_densedb`` where the
  keys are looked up on the device), its fused counts kernel and the
  unfused pair on its rows;
* ``ShardedTorchPlacer`` on a 1x1 mesh, the column-sharded dense step with
  the default config (the pair plane in one column shard) and with
  ``plane_mode="classic"``, and the kernel each shard ends in, where the port
  has it: ``rowgather_sum_cols`` / ``rowgather_sum_counts_cols`` (the gather
  with the shard's column finish fused in; the shifted one from the call at
  the shard's router, with its unfused pair beside it and the route the
  step took); in a port without them, the
  gather alone (``rowgather_sum`` / ``rowgather_sum_counts``) that the step
  ran before its column finish; on the classic plane also kernel A's counts
  form (``finish_cols_partial_counts``) on the shard's sums and counts with
  their first hits, and the unfused pair (1c, the first hits, kernel A).

``--only d652`` stops there.

On ``chip_smoke.py``'s config-4 database (10,000 leaves, 19,999 branches,
k = 10) with 4,096 clean 150 bp reads and 4,096 400 bp reads, and
``TorchPlacer(dense_db="off")`` with packed tiles, then f32 tiles:

* the packed and the f32 tile steps on the 150 bp batch;
* the CSR step on the 400 bp batch, and its counts finish alone on the
  step's (4,096 x 19,999) sums and counts: ``finish_topk_counts`` where the
  port has it, else the torch ``finish_scores`` + ``pack_outputs`` the step
  ran;
* kernel 2 (``accumulate_packed_topk``) on the packed tile step's cells;
* kernel 4 with counts (``accumulate_sums_counts``) on the CSR step's cells,
  and without (``accumulate_sums``) on the f32 tile step's cells;
* the finish (``finish_topk``) on the f32 tile step's (4,096 x 19,999) sums;
* with ``pair_plane="on"``, the pair-fused tile step on the 150 bp batch and
  kernel 2 on its pair-row cells; with ``accumulate="scatter"``, the flat CSR
  step on the 400 bp batch and kernel 4's row-pointer form
  (``accumulate_sums_counts_csr``) on its flat cells;
* on the dense route (the unpaired 51.8 GB plane, the CLI's default route on
  an 80 GB card), the dense step on the 150 bp batch and its fused kernel;
* ``ShardedTorchPlacer(dense_db="off")`` on a 1x1 mesh: the sharded tile step
  on the 150 bp batch and its column finish at (4,096 x 20,096), which is
  torch ops up to the parent of the column-finish kernels and those kernels
  after, and kernel A (``finish_cols_partial``) alone there;
* ``ShardedTorchPlacer`` with the default config on a 1x1 mesh (the unpaired
  51.8 GB column plane): the sharded dense step on the 150 bp batch and its
  kernel, as for D652.

On ``chip_smoke.py``'s wide classic database (11,100 leaves, 22,199
branches, k = 10, past the fused counts kernel's limit) with 4,096 150 bp
reads, the classic f32 and bf16 steps (the gather with counts and
``finish_topk_counts`` apart) and kernel 1c alone on their rows; with 4,096
400 bp reads under ``accumulate="scatter"``, the flat CSR step and kernel
4's row-pointer form on its flat cells, its plain version and one
``index_put_(accumulate=True)`` (the sums alone); ``ShardedTorchPlacer`` on a
1x1 mesh with ``plane_mode="classic"`` there (one shard of 22,272 columns,
past the fused counts column kernel's limit): the sharded step (1c and
kernel A's counts form apart) and kernel A on its sums and counts.

On ``chip_smoke.py``'s wide shifted database (20,000 leaves, 39,999
branches, k = 10, past the fused kernel's limit) with 4,096 150 bp reads,
the f32 and int16 shifted steps (the gather alone, kernel 1d, and
``finish_topk`` apart), 1d alone on their rows, and ``embedding_bag`` on the
f32 rows.

On ``chip_smoke.py``'s config-2 database (652 leaves, 1,303 branches, amino
k = 8) with its first batch of 4,096 reads (X/B/Z reads among them), and
``TorchPlacer`` on the codes path, it times the codes step, the codes
tokenizer alone, the radix lookup alone (the window keys given), the two
together, and the fused kernel (``rowgather_sum_topk``) on their rows.

``--repo`` times the ``epik_tpu_torch`` of another checkout of this
repository (the fixture and the timing helpers stay this checkout's
``chip_smoke.py``); an entry point that port lacks is skipped and named under
``"skipped"``. To compare two commits on one card, unpack the other one under
``build/`` and run this script for it and for ``.`` in turns, in one call.
``--profile`` also prints the dense, the codes and the CSR step's time by operator
(``torch.profiler`` over 20 steps). Prints the card line of ``nvidia-smi``
and one JSON object. Needs a CUDA device; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import sys

import chip_smoke
from chip_smoke import (
    AA_BATCH,
    BATCH,
    BT_BATCH,
    BT_LONG,
    CELL_BATCH,
    TIMING_REPS,
    bigtree_db,
    card_line,
    cuda_ms,
    d652_fixture,
    fused_call,
    recording,
    unfused_pair,
)


def _fused_kw(fn, call):
    """A fused shifted call (:func:`chip_smoke.fused_call`) for the wrapper
    ``fn`` of the port timed: without ``pair_rows`` where the wrapper takes
    none (a port whose fused kernel had one read order)."""
    args, kw = call
    if "pair_rows" not in inspect.signature(fn).parameters:
        kw = {n: v for n, v in kw.items() if n != "pair_rows"}
    return args, kw


def route_turns(torch, step, cols: bool):
    """The shifted ``step`` timed with the width rule set to each side in
    turns (fused, pair, pair, fused): what the step pays on either route, the
    kernels each side launched beside its times; None in a port without the
    rule."""
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels import rowgather as rg

    name = "SHIFTED_COLS_MAX_BW" if cols else "SHIFTED_TOPK_MAX_BW"
    if not hasattr(rg, name):
        return None
    keep = getattr(rg, name)
    times = {}
    try:
        for side in ("fused", "pair", "pair", "fused"):
            setattr(rg, name, 1 << 20 if side == "fused" else 0)
            reset_launch_counts()
            times.setdefault(side, {"ms": []})["ms"].append(cuda_ms(torch, step))
            times[side]["launched"] = sorted(n for n, c in launch_counts().items() if c)
    finally:
        setattr(rg, name, keep)
    return times


def print_profile(torch, fn, title: str) -> None:
    """Device and host time by operator of ``TIMING_REPS`` runs of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMING_REPS):
            fn()
        torch.cuda.synchronize()
    print(f"{title}, {TIMING_REPS} steps:")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                    max_name_column_width=60))


def dense_times(torch, dev, out: dict, profile: bool = False) -> None:
    """The D652 dense step and its kernels into ``out``; with ``profile``,
    print the step's profile."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.step import dense_gather, place_batch_dense_paired, window_counts
    from epik_tpu_torch.ops import dense as dense_mod
    from epik_tpu_torch.ops.tokenize import tokenize_combo

    db, records = d652_fixture()
    tree = parse_newick(db.tree())
    placer = TorchPlacer(db, tree, device=dev)
    st = placer.state
    seqs = list(dict.fromkeys(s for _, s in records[:BATCH]))
    buf, arows, Amax, Lmax, _ = placer._stage_bytes(seqs)
    buf_t, arows_t = torch.from_numpy(buf).to(dev), torch.from_numpy(arows).to(dev)
    B, K, k = placer.B, placer._K(), placer.k
    kw = dict(K=K, k=k, log_eps=float(placer.log_eps))
    step_kw = dict(B=B, Amax=Amax, Lmax=Lmax, num_kmers=st.n_keys, eps=float(placer.eps),
                   **kw)

    def dense_step():  # the gather as the width rule gives it at each call
        return place_batch_dense_paired(st.plane, st.combo, buf_t, arows_t, gather=dense_gather(
            st.plane, B, K, shifted=True), **step_kw)

    out["dense_R"] = len(seqs)
    out["dense_step_ms"] = cuda_ms(torch, dense_step)
    routes = route_turns(torch, dense_step, cols=False)
    if routes is not None:
        out["dense_step_by_route"] = routes
    if profile:
        print_profile(torch, dense_step, f"dense step, R={len(seqs)}, Amax={Amax}")
    fused_tok = getattr(kernels_mod, "tokenize_combo_fused", None)
    if fused_tok is None:
        out["skipped"].append("tokenize_combo_fused: the port has no tokenizer kernel")
    for tag, batch in (("", seqs), ("_2000", seqs[:CELL_BATCH])):
        b, _, _, L, _ = placer._stage_bytes(batch)
        b_t = torch.from_numpy(b).to(dev)
        out[f"tokenize_combo_torch{tag}_ms"] = cuda_ms(
            torch, lambda: window_counts(tokenize_combo(b_t, st.combo, k=k, Lmax=L)[1], k))
        if fused_tok is not None:
            out[f"tokenize_combo_fused{tag}_ms"] = cuda_ms(
                torch, lambda: fused_tok(b_t, st.combo, k=k, Lmax=L))
    rows, lens = tokenize_combo(buf_t, st.combo, k=k, Lmax=Lmax)
    m_signed = (lens - (k - 1)).float()
    m_f32 = torch.where(m_signed >= 0, m_signed, m_signed + float(2**64))
    # the pair rows as the paired step gathers them past the fused limit
    gkw = ({"pair_rows": True}
           if "pair_rows" in inspect.signature(kernels_mod.rowgather_sum).parameters else {})
    Sp = kernels_mod.rowgather_sum(st.plane, rows, **gkw)[:, :B]
    out["rowgather_sum_ms"] = cuda_ms(torch, lambda: kernels_mod.rowgather_sum(st.plane, rows,
                                                                               **gkw))
    out["finish_topk_d652_ms"] = cuda_ms(torch, lambda: kernels_mod.finish_topk(Sp, m_f32,
                                                                                **kw))
    out["rowgather_sum_plus_finish_topk_ms"] = (out["rowgather_sum_ms"]
                                                + out["finish_topk_d652_ms"])
    if gkw:  # what the read order saves there: the wrapper with its sort, the sort alone
        out["rowgather_sum_sorted_ms"] = cuda_ms(torch, lambda: kernels_mod.rowgather_sum(
            st.plane, rows))
        out["locality_order_d652_pair_ms"] = cuda_ms(
            torch, lambda: kernels_mod.rowgather.locality_order(rows))
    if hasattr(kernels_mod, "rowgather_sum_topk"):
        fused = kernels_mod.rowgather_sum_topk
        amb_read, delta = dense_mod.amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=B,
                                               k=k, eps=float(placer.eps),
                                               log_eps=float(placer.log_eps))
        call = ((st.plane, rows, m_f32, amb_read, delta), dict(B=B, pair_rows=True, **kw))
        f_args, f_kw = _fused_kw(fused, call)
        out["rowgather_sum_topk_ms"] = cuda_ms(torch, lambda: fused(*f_args, **f_kw))
        out["d652_pair_unfused_pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, call,
                                                                       cols=False))
    else:
        out["skipped"].append("rowgather_sum_topk: the port has no fused kernel 1")
    del placer, st
    torch.cuda.empty_cache()
    variant_times(torch, dev, out, db, tree, seqs)
    lookup_device_times(torch, dev, out, db, tree, seqs)
    sharded_dense_times(torch, out, db, tree, seqs)


def codes_times(torch, dev, out: dict, profile: bool = False) -> None:
    """Config 2's codes step and its parts into ``out``, where the port has
    it; with ``profile``, print the step's profile."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine import step as step_mod

    if not hasattr(step_mod, "place_batch_dense_codes"):
        out["skipped"].append("config 2: the port has no codes step")
        return
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.ops.dense import amb_deltas
    from epik_tpu_torch.ops.tokenize import tokenize_codes, tokenize_radix

    db, records = chip_smoke.config2_fixture()
    placer = TorchPlacer(db, parse_newick(db.tree()), device=dev)
    st = placer.state
    seqs = list(dict.fromkeys(s for _, s in records[:AA_BATCH]))
    buf, arows, Amax, Lmax, _ = placer._stage_codes(seqs)
    buf_t, arows_t = torch.from_numpy(buf).to(dev), torch.from_numpy(arows).to(dev)
    B, K, k = placer.B, placer._K(), placer.k
    ck = dict(k=k, sigma=placer.alphabet.sigma, Lmax=Lmax)
    fin = dict(B=B, K=K, k=k, log_eps=float(placer.log_eps))

    def step():
        return step_mod.place_batch_dense_codes(
            st.plane, st.radix, buf_t, arows_t, Amax=Amax, num_kmers=st.n_keys,
            eps=float(placer.eps), plane_scale=st.scale, sigma=ck["sigma"], Lmax=Lmax,
            gather=placer._gather, **fin)

    out["config2_R"] = len(seqs)
    out["config2_radix_form"] = st.radix.form
    out["config2_step_ms"] = cuda_ms(torch, step)
    key, _, _ = tokenize_codes(buf_t, **ck)
    rows, lens = tokenize_radix(buf_t, st.radix, num_kmers=st.n_keys, **ck)
    out["config2_tokenize_ms"] = cuda_ms(torch, lambda: tokenize_codes(buf_t, **ck))
    out["config2_lookup_ms"] = cuda_ms(torch, lambda: st.radix.lookup(key, st.n_keys))
    out["config2_tokenize_lookup_ms"] = cuda_ms(
        torch, lambda: tokenize_radix(buf_t, st.radix, num_kmers=st.n_keys, **ck))
    amb_read, delta = amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=B, k=k,
                                 eps=float(placer.eps), log_eps=float(placer.log_eps))
    m_f32 = step_mod.window_counts(lens, k)
    out["config2_rowgather_sum_topk_ms"] = cuda_ms(torch, lambda: kernels_mod.rowgather_sum_topk(
        st.plane, rows, m_f32, amb_read, delta, **fin))
    out["config2_rowgather_sum_topk_shape"] = list(rows.shape)
    out["config2_unfused_pair_ms"] = cuda_ms(torch, unfused_pair(
        kernels_mod, ((st.plane, rows, m_f32, amb_read, delta), fin), cols=False))
    if profile:
        print_profile(torch, step, f"config 2 codes step, R={len(seqs)}, Amax={Amax}")
    del placer, st, key, rows, amb_read, delta
    torch.cuda.empty_cache()


def sharded_dense_times(torch, out: dict, db, tree, seqs, prefix: str = "d652",
                        configs=(("", {}), ("_classic", {"plane_mode": "classic"}))) -> None:
    """The column-sharded dense step on a 1x1 mesh under each of ``configs``
    (name suffix, PlacerConfig fields) and the kernel its shard ends in (its
    first call recorded) into ``out``, where the port has the step; on the
    classic plane also kernel A's counts form on the shard's sums and counts
    with its first hits, and the unfused pair (1c, the first hits, kernel A)."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.parallel import sharding as sh_mod
    from epik_tpu_torch.parallel.mesh import make_mesh

    if not hasattr(sh_mod, "sharded_dense_paired_step"):
        out["skipped"].append(f"{prefix} sharded dense: the port has no column-sharded dense "
                              f"step")
        return
    for suffix, fields in configs:
        placer = sh_mod.ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                           config=PlacerConfig(**fields))
        name = ("sharded_dense_paired_step" if placer._paired else "sharded_dense_bytes_step")
        fused = "rowgather_sum_cols" if placer._shifted else "rowgather_sum_counts_cols"
        kernel = fused if hasattr(sh_mod, fused) else (
            "rowgather_sum" if placer._shifted else "rowgather_sum_counts")
        # the shifted shard's call at its router, whichever route it takes
        at = "_shifted_cols" if kernel == "rowgather_sum_cols" else kernel
        calls, kcalls = [], []
        reset_launch_counts()
        with recording(sh_mod, name, calls, limit=1), \
                recording(sh_mod, at, kcalls, limit=1):
            placer.place([(f"r{i}", s) for i, s in enumerate(seqs)])
        if at == "_shifted_cols":
            out[f"{prefix}_sharded{suffix}_route"] = sorted(
                n for n, c in launch_counts().items() if c)
        args, kw = calls[0]
        out[f"{prefix}_sharded{suffix}_R"] = args[2].shape[0]
        out[f"{prefix}_sharded{suffix}_step_ms"] = cuda_ms(
            torch, lambda: getattr(sh_mod, name)(*args, **kw))
        if at == "_shifted_cols":
            routes = route_turns(torch, lambda: getattr(sh_mod, name)(*args, **kw), cols=True)
            if routes is not None:
                out[f"{prefix}_sharded{suffix}_step_by_route"] = routes
        fn = getattr(sh_mod, kernel)
        k_args, k_kw = _fused_kw(fn, kcalls[0])
        out[f"{prefix}_sharded{suffix}_{kernel}_ms"] = cuda_ms(torch, lambda: fn(*k_args,
                                                                                **k_kw))
        out[f"{prefix}_sharded{suffix}_{kernel}_shape"] = [*k_args[1].shape, k_args[0].shape[1]]
        if at == "_shifted_cols":  # the unfused pair: 1d, the delta add, kernel A
            out[f"{prefix}_sharded{suffix}_unfused_pair_ms"] = cuda_ms(
                torch, unfused_pair(kernels_mod, kcalls[0], cols=True))
        if not placer._shifted:  # kernel A's counts form on the shard's sums and counts
            S, C = sh_mod.add_first_hits(*sh_mod.rowgather_sum_counts(k_args[0], k_args[1]),
                                         *k_args[3:6])
            fkw = {n: k_kw[n] for n in ("K", "k", "log_eps", "col0")}
            out[f"{prefix}_sharded{suffix}_finish_cols_partial_counts_ms"] = cuda_ms(
                torch, lambda: sh_mod.finish_cols_partial_counts(S, C, k_args[2], **fkw))
            if kernel == fused:  # the unfused pair: 1c, the first hits added, kernel A
                out[f"{prefix}_sharded{suffix}_unfused_pair_ms"] = cuda_ms(
                    torch, unfused_pair(kernels_mod, kcalls[0], cols=True))
            del S, C
        del placer, calls, kcalls, args, k_args
        torch.cuda.empty_cache()


def sharded_tile_times(torch, out: dict, db, tree, seqs) -> None:
    """Config 4's sharded tile step on a 1x1 mesh and its column finish into
    ``out``."""
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.parallel import sharding as sh_mod
    from epik_tpu_torch.parallel.mesh import make_mesh

    placer = sh_mod.ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                       config=PlacerConfig(dense_db="off"))
    _, OV, rerun = placer._prepare_tiles({s: ["x"] for s in seqs}, seqs)[1]().budget
    out["sharded_tile_step_ms"] = cuda_ms(torch, lambda: rerun(OV))
    calls = []
    with recording(sh_mod, "finish_scores_cols_shifted", calls, limit=1):
        rerun(OV)
    (Sps, m_f32), kw = calls[0]
    out["column_finish_ms"] = cuda_ms(
        torch, lambda: sh_mod.finish_scores_cols_shifted(Sps, m_f32, **kw))
    out["column_finish_shape"] = [len(Sps), *Sps[0].shape]
    if hasattr(sh_mod, "finish_cols_partial"):
        a_calls = []
        with recording(sh_mod, "finish_cols_partial", a_calls, limit=1):
            rerun(OV)
        (Sp, m_a), a_kw = a_calls[0]
        out["finish_cols_partial_ms"] = cuda_ms(
            torch, lambda: sh_mod.finish_cols_partial(Sp, m_a, **a_kw))
        out["finish_cols_partial_shape"] = list(Sp.shape)
        del a_calls, Sp, m_a
    del placer, rerun, calls, Sps, m_f32
    torch.cuda.empty_cache()


def counts_finish_times(torch, out: dict, placer, long_reads) -> None:
    """The CSR step's counts finish alone, on the sums and counts of its
    first call on ``long_reads``, into ``out``: ``finish_topk_counts`` where
    the port has it, else the torch ``finish_scores`` + ``pack_outputs``."""
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.ops import csr as csr_mod

    name = "finish_topk_counts" if hasattr(step_mod, "finish_topk_counts") else "finish_scores"
    calls = []
    with recording(step_mod, name, calls, limit=1):
        placer.place(long_reads)
    (S, C, m_f32), kw = calls[0]
    if name == "finish_topk_counts":
        def finish():
            return step_mod.finish_topk_counts(S, C, m_f32, **kw)
    else:
        def finish():
            return csr_mod.pack_outputs(csr_mod.finish_scores(S, C, m_f32, **kw), 0, 0)
    out["counts_finish_csr"] = name
    out["counts_finish_csr_ms"] = cuda_ms(torch, finish)
    out["counts_finish_csr_shape"] = list(S.shape)


#: the unpaired D652 configs: name, PlacerConfig fields, the kernels the step
#: ends in, the first of them the port has
VARIANTS = [
    ("pair_off", {"pair_plane": "off"}, ("rowgather_sum_topk",)),
    ("int16", {"precision": "int16"}, ("rowgather_sum_topk_int16",)),
    ("classic", {"plane_mode": "classic"},
     ("rowgather_sum_counts_topk", "rowgather_sum_counts")),
    ("bf16", {"precision": "bf16"},
     ("rowgather_sum_counts_topk_bf16", "rowgather_sum_counts_bf16")),
]
#: the gather apart that each variant's rows also go through: the gather with
#: counts (kernel 1c) on the classic planes, the gather alone (1d) on the
#: int16 plane
APART = {"classic": "rowgather_sum_counts", "bf16": "rowgather_sum_counts_bf16",
         "int16": "rowgather_sum"}


def last_config_times(torch, dev, out: dict, db, tree, reads, long_reads) -> None:
    """The pair-fused tile step and kernel 2 over its pair rows; the flat CSR
    step and kernel 4's row-pointer form; each skipped where the port lacks
    it."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.ops import csr as csr_mod

    seqs = list(dict.fromkeys(s for _, s in reads))
    if hasattr(step_mod, "place_batch_tiles_paired"):
        placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", pair_plane="on"),
                             device=dev)
        step, _, _ = placer._stage_tiles(seqs)
        out["tile_step_paired_ms"] = cuda_ms(torch, lambda: step(None))
        calls = []
        with recording(step_mod, "accumulate_packed_topk", calls):
            placer.place(reads)
        (p, m_f32), kw = calls[0]
        out["accumulate_packed_topk_paired_ms"] = cuda_ms(
            torch, lambda: kernels_mod.accumulate_packed_topk(p, m_f32, **kw))
        out["accumulate_packed_topk_paired_shape"] = list(p.shape)
        del placer, step, calls, p, m_f32
        torch.cuda.empty_cache()
    else:
        out["skipped"].append("pair-fused tiles: the port has no paired tile step")
    if hasattr(csr_mod, "accumulate_exact"):
        placer = TorchPlacer(db, tree, config=PlacerConfig(accumulate="scatter"), device=dev)
        long_seqs = list(dict.fromkeys(s for _, s in long_reads))
        step, P, PA, _ = placer._stage_csr(long_seqs)
        out["csr_step_flat_ms"] = cuda_ms(torch, lambda: step(P, PA))
        out["csr_flat_P"] = P
        calls = []
        with recording(csr_mod, "accumulate_sums_counts_csr", calls):
            placer.place(long_reads)
        (b, s, ptr), kw = calls[0]
        out["accumulate_sums_counts_csr_ms"] = cuda_ms(
            torch, lambda: kernels_mod.accumulate_sums_counts_csr(b, s, ptr, **kw))
        out["accumulate_sums_counts_csr_cells"] = int(ptr[-1] - ptr[0])
        del placer, step, calls, b, s, ptr
        torch.cuda.empty_cache()
    else:
        out["skipped"].append("accumulate='scatter': the port has no flat CSR step")


def unpaired_step_times(torch, dev, out: dict, placer, seqs, prefix: str,
                        kernel: str, apart: str | None = None) -> None:
    """The unpaired dense step of ``placer`` on ``seqs`` and the kernel it
    ends in (its first call recorded) into ``out``; ``apart``, a gather the
    kernel's plane and rows also go through (the classic planes' gather with
    counts, which the step runs past the fused kernel's limit)."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts

    st = placer.state
    buf, arows, Amax, Lmax, _ = placer._stage_bytes(seqs)
    buf_t, arows_t = torch.from_numpy(buf).to(dev), torch.from_numpy(arows).to(dev)
    step_kw = dict(B=placer.B, K=placer._K(), Amax=Amax, k=placer.k, Lmax=Lmax,
                   num_kmers=st.n_keys, log_eps=float(placer.log_eps), eps=float(placer.eps),
                   shifted=placer._shifted, plane_scale=st.scale)

    def step():
        return step_mod.place_batch_dense_bytes(st.plane, st.direct, buf_t, arows_t,
                                                gather=placer._gather, **step_kw)

    shifted = kernel.startswith("rowgather_sum_topk")
    calls = []
    reset_launch_counts()
    with recording(step_mod, "_shifted_finish" if shifted else kernel, calls):
        step()
    out[f"{prefix}_step_ms"] = cuda_ms(torch, step)
    fn = kernels_mod.KERNELS[kernel]
    if shifted:  # the fused kernel and its unfused pair, from the router's call
        out[f"{prefix}_route"] = sorted(n for n, c in launch_counts().items() if c)
        pair_call = fused_call(torch, calls[0])
        out[f"{prefix}_unfused_pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, pair_call,
                                                                       cols=False))
        calls = [_fused_kw(fn, pair_call)]
    args, kw = calls[0]
    out[f"{prefix}_{kernel}_ms"] = cuda_ms(torch, lambda: fn(*args, **kw))
    out[f"{prefix}_{kernel}_shape"] = list(args[1].shape)
    if apart is not None and apart != kernel:
        gather = kernels_mod.KERNELS[apart]
        scale = {"scale": kw["scale"]} if "scale" in kw else {}
        out[f"{prefix}_{apart}_ms"] = cuda_ms(torch, lambda: gather(args[0], args[1], **scale))
    if kernel.startswith("rowgather_sum_counts_topk"):
        # the unfused pair on the same rows: 1c, the first hits added, the
        # counts finish; and the finish alone on 1c's sums
        out[f"{prefix}_unfused_pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, calls[0],
                                                                       cols=False))
        B, m = kw["B"], args[2]
        S, C = gather(args[0], args[1])
        S, C = kernels_mod.rowgather.add_first_hits(S[:, :B], C[:, :B], *args[3:6])
        fkw = {n: kw[n] for n in ("K", "k", "log_eps")}
        out[f"{prefix}_finish_topk_counts_ms"] = cuda_ms(
            torch, lambda: kernels_mod.finish_topk_counts(S, C, m, **fkw))


def variant_times(torch, dev, out: dict, db, tree, seqs) -> None:
    """The D652 dense step and kernel under each of ``VARIANTS``, where the
    port has the unpaired step."""
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.kernels import KERNELS

    if not hasattr(step_mod, "place_batch_dense_bytes"):
        out["skipped"].append("dense variants: the port has no unpaired dense step")
        return
    for name, fields, names in VARIANTS:
        kernel = next(n for n in names if n in KERNELS)
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        unpaired_step_times(torch, dev, out, placer, seqs, f"d652_{name}", kernel,
                            APART.get(name))
        del placer
        torch.cuda.empty_cache()


def lookup_device_times(torch, dev, out: dict, db, tree, seqs) -> None:
    """The D652 step under ``lookup_where="device"`` (the classic plane; the
    device tokenizer where it takes the batch, else the keys looked up on the
    device, ``place_batch_device_densedb``), the fused counts kernel it ends
    in and, on the same rows, the unfused pair (1c, the first hits,
    ``finish_topk_counts``)."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine import placer as placer_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer

    kernel = "rowgather_sum_counts_topk"
    placer = TorchPlacer(db, tree, config=PlacerConfig(lookup_where="device"), device=dev)
    steps = {"place_batch_dense_bytes": [], "place_batch_device_densedb": []}
    kcalls = []
    with recording(placer_mod, "place_batch_dense_bytes", steps["place_batch_dense_bytes"],
                   limit=1), \
            recording(placer_mod, "place_batch_device_densedb",
                      steps["place_batch_device_densedb"], limit=1), \
            recording(step_mod, kernel, kcalls, limit=1):
        placer.place([(f"r{i}", s) for i, s in enumerate(seqs)])
    name, ((args, kw),) = next((n, c) for n, c in steps.items() if c)
    out["d652_lookup_device_step"] = name
    out["d652_lookup_device_step_ms"] = cuda_ms(torch, lambda: getattr(step_mod, name)(*args,
                                                                                      **kw))
    (k_args, k_kw), = kcalls
    out[f"d652_lookup_device_{kernel}_ms"] = cuda_ms(
        torch, lambda: kernels_mod.KERNELS[kernel](*k_args, **k_kw))
    out["d652_lookup_device_unfused_pair_ms"] = cuda_ms(
        torch, unfused_pair(kernels_mod, kcalls[0], cols=False))
    del placer, steps, kcalls, args, k_args
    torch.cuda.empty_cache()


def wide_classic_times(torch, dev, out: dict) -> None:
    """``chip_smoke.py``'s wide classic database (B = 22,199, past the fused
    counts kernel's limit) with 4,096 150 bp reads: the classic f32 and bf16
    steps, which run the gather with counts (kernel 1c) and
    ``finish_topk_counts`` apart, and 1c alone on their rows; 4,096 400 bp
    reads under ``accumulate="scatter"``: the flat CSR step and kernel 4's
    row-pointer form on its cells (B = 22,199), into
    ``out``."""
    import gc

    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.ops import csr as csr_mod

    db, ref = chip_smoke.wide_classic_db()
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, chip_smoke.WC_BATCH, length=150, mutation_rate=0.02,
                                 seed=14)
    seqs = list(dict.fromkeys(s for _, s in reads))
    long_reads = reads_from_reference(ref, BT_LONG, length=400, mutation_rate=0.02, seed=15)
    placer = TorchPlacer(db, tree, config=PlacerConfig(accumulate="scatter"), device=dev)
    step, P, PA, _ = placer._stage_csr(list(dict.fromkeys(s for _, s in long_reads)))
    out["wide_scatter_step_ms"] = cuda_ms(torch, lambda: step(P, PA))
    calls = []
    with recording(csr_mod, "accumulate_sums_counts_csr", calls):
        placer.place(long_reads)
    (b, s, ptr), kw = calls[0]
    out["wide_accumulate_sums_counts_csr_ms"] = cuda_ms(
        torch, lambda: kernels_mod.accumulate_sums_counts_csr(b, s, ptr, **kw))
    out["wide_accumulate_sums_counts_csr_cells"] = int(ptr[-1] - ptr[0])
    out["wide_accumulate_sums_counts_csr_B"] = kw["B"]
    out["wide_accumulate_sums_counts_csr_plain_ms"] = cuda_ms(
        torch, lambda: importlib.import_module(
            "epik_tpu_torch.kernels.accumulate_sums").accumulate_sums_counts_csr_plain(
            b, s, ptr, **kw), reps=5, warmup=1)
    R = kw["R"]
    rows_l = torch.arange(R, device=dev).repeat_interleave(ptr[1:] - ptr[:-1])
    kept = slice(int(ptr[0]), int(ptr[R]))
    cols_l, s_l = b[kept].long(), s[kept]
    out["wide_index_put_ms"] = cuda_ms(torch, lambda: torch.zeros(
        (R, kw["B"]), device=dev).index_put_((rows_l, cols_l), s_l, accumulate=True))
    del placer, step, calls, b, s, ptr, rows_l, cols_l, s_l
    torch.cuda.empty_cache()
    for name, fields, kernel in (("wide_classic", {"plane_mode": "classic"},
                                  "rowgather_sum_counts"),
                                 ("wide_bf16", {"precision": "bf16"},
                                  "rowgather_sum_counts_bf16")):
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        if placer.route != "dense":
            raise AssertionError(f"{name} took route {placer.route}")
        unpaired_step_times(torch, dev, out, placer, seqs, name, kernel)
        del placer
        gc.collect()
        torch.cuda.empty_cache()


def wide_shifted_times(torch, dev, out: dict) -> None:
    """``chip_smoke.py``'s wide shifted database (B = 39,999, bw 40,064, past
    the fused kernel's limit) with 4,096 150 bp reads: the f32 and the int16
    shifted steps, which run the gather alone (1d) and ``finish_topk``
    apart, 1d alone on their rows, and ``embedding_bag`` (f32) there, into
    ``out``."""
    import gc

    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference

    db, ref = chip_smoke.wide_shifted_db()
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, chip_smoke.WS_BATCH, length=150, mutation_rate=0.02,
                                 seed=17)
    seqs = list(dict.fromkeys(s for _, s in reads))
    for name, fields in (("wide_shifted", {}), ("wide_shifted_int16", {"precision": "int16"})):
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        if placer.route != "dense" or placer._paired:
            raise AssertionError(f"{name} took route {placer.route}, not the unpaired plane")
        unpaired_step_times(torch, dev, out, placer, seqs, name, "rowgather_sum")
        if name == "wide_shifted":
            calls = []
            with recording(step_mod, "rowgather_sum", calls, limit=1):
                placer.place(reads)
            (plane, rows), _ = calls[0]
            rows_l = rows.long()
            out["wide_shifted_embedding_bag_ms"] = cuda_ms(
                torch, lambda: torch.nn.functional.embedding_bag(rows_l, plane, mode="sum"))
            out["wide_shifted_distinct_rows"] = int(torch.unique(rows).numel())
            del calls, plane, rows, rows_l
        del placer
        gc.collect()
        torch.cuda.empty_cache()


def wide_sharded_classic_times(torch, out: dict) -> None:
    """``ShardedTorchPlacer`` on a 1x1 mesh with ``plane_mode="classic"`` on
    ``chip_smoke.py``'s wide classic database (one shard of 22,272 columns,
    past the fused counts kernel's limit) with 4,096 150 bp reads: the
    sharded step, which runs the gather with counts (1c) and kernel A's
    counts form apart, and kernel A on its recorded call, into ``out``."""
    import gc

    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.parallel import sharding as sh_mod
    from epik_tpu_torch.parallel.mesh import make_mesh

    db, ref = chip_smoke.wide_classic_db()
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, chip_smoke.WC_BATCH, length=150, mutation_rate=0.02,
                                 seed=14)
    placer = sh_mod.ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                       config=PlacerConfig(plane_mode="classic"))
    calls, a_calls = [], []
    with recording(sh_mod, "sharded_dense_bytes_step", calls, limit=1), \
            recording(sh_mod, "finish_cols_partial_counts", a_calls, limit=1):
        placer.place(reads)
    args, kw = calls[0]
    out["wide_sharded_classic_R"] = args[2].shape[0]
    out["wide_sharded_classic_step_ms"] = cuda_ms(
        torch, lambda: sh_mod.sharded_dense_bytes_step(*args, **kw))
    (S, C, m), a_kw = a_calls[0]
    out["wide_sharded_classic_finish_cols_partial_counts_ms"] = cuda_ms(
        torch, lambda: sh_mod.finish_cols_partial_counts(S, C, m, **a_kw))
    out["wide_sharded_classic_finish_cols_partial_counts_shape"] = list(S.shape)
    out["wide_sharded_classic_touched_mean"] = float((C > 0).sum(dim=1).float().mean())
    del placer, calls, a_calls, args, S, C, m
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=None, help="checkout whose port is timed")
    ap.add_argument("--profile", action="store_true",
                    help="print the dense, the codes and the CSR step's time by operator")
    ap.add_argument("--only", choices=("d652",), default=None,
                    help="time D652's steps and kernels only")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo or chip_smoke.REPO))
    import torch

    if not torch.cuda.is_available():
        print("step_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import epik_tpu_torch
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.ops import csr as csr_mod

    dev = torch.device("cuda")
    out = {"port": os.path.dirname(os.path.abspath(epik_tpu_torch.__file__)),
           "device": torch.cuda.get_device_name(0), "skipped": []}
    dense_times(torch, dev, out, args.profile)
    torch.cuda.empty_cache()
    if args.only == "d652":
        print(card_line())
        print(json.dumps(out))
        return 0
    db, ref = bigtree_db()
    tree = parse_newick(db.tree())
    out["B"] = tree.get_node_count()
    reads = reads_from_reference(ref, BT_BATCH, length=150, mutation_rate=0.02, seed=11)
    long_reads = reads_from_reference(ref, BT_LONG, length=400, mutation_rate=0.02, seed=12)
    seqs = list(dict.fromkeys(s for _, s in reads))
    long_seqs = list(dict.fromkeys(s for _, s in long_reads))
    codes_times(torch, dev, out, args.profile)

    placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device=dev)
    step, OV, _ = placer._stage_tiles(seqs)
    out["tile_step_ms"] = cuda_ms(torch, lambda: step(OV))
    calls = []
    with recording(step_mod, "accumulate_packed_topk", calls):
        placer.place(reads)
    (p, m_f32), kw = calls[0]
    out["accumulate_packed_topk_ms"] = cuda_ms(
        torch, lambda: kernels_mod.accumulate_packed_topk(p, m_f32, **kw))
    out["accumulate_packed_topk_shape"] = list(p.shape)
    del p, m_f32
    csr_step, P, PA, _ = placer._stage_csr(long_seqs)
    out["csr_step_ms"] = cuda_ms(torch, lambda: csr_step(P, PA))
    if args.profile:
        print_profile(torch, lambda: csr_step(P, PA),
                      f"CSR step, R={len(long_seqs)} x 400 bp, P={P}")
    calls = []
    with recording(csr_mod, "accumulate_sums_counts", calls):
        placer.place(long_reads)
    (b, s), kw = calls[0]
    out["accumulate_sums_counts_ms"] = cuda_ms(
        torch, lambda: kernels_mod.accumulate_sums_counts(b, s, **kw))
    out["accumulate_sums_counts_shape"] = list(b.shape)
    del calls, b, s
    counts_finish_times(torch, out, placer, long_reads)
    del placer, step, csr_step
    torch.cuda.empty_cache()

    placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", tile_payload="f32"),
                         device=dev)
    step, OV, _ = placer._stage_tiles(seqs)
    out["tile_step_f32_ms"] = cuda_ms(torch, lambda: step(OV))
    calls, finish_calls = [], []
    with recording(step_mod, "accumulate_sums", calls), \
            recording(step_mod, "finish_topk", finish_calls):
        placer.place(reads)
    (b, s), kw = calls[0]
    out["accumulate_sums_ms"] = cuda_ms(
        torch, lambda: kernels_mod.accumulate_sums(b, s, **kw))
    out["accumulate_sums_shape"] = list(b.shape)
    (Sp, m_f32), kw = finish_calls[0]
    out["finish_topk_f32_ms"] = cuda_ms(
        torch, lambda: kernels_mod.finish_topk(Sp, m_f32, **kw))
    out["finish_topk_f32_shape"] = list(Sp.shape)
    del placer, step, calls, finish_calls, b, s, Sp, m_f32
    torch.cuda.empty_cache()
    sharded_tile_times(torch, out, db, tree, seqs)
    last_config_times(torch, dev, out, db, tree, reads, long_reads)

    if hasattr(step_mod, "place_batch_dense_bytes"):
        placer = TorchPlacer(db, tree, device=dev)
        if placer.route != "dense" or placer._paired:
            raise AssertionError(f"config 4 took route {placer.route}, not the unpaired plane")
        unpaired_step_times(torch, dev, out, placer, seqs, "config4_dense",
                            "rowgather_sum_topk")
        del placer
        torch.cuda.empty_cache()
    else:
        out["skipped"].append("config 4 dense: the port has no unpaired dense step")
    sharded_dense_times(torch, out, db, tree, seqs, prefix="config4", configs=(("", {}),))
    del db, tree
    torch.cuda.empty_cache()
    wide_classic_times(torch, dev, out)
    wide_sharded_classic_times(torch, out)
    wide_shifted_times(torch, dev, out)
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
