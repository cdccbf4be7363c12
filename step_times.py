#!/usr/bin/env python3
"""CUDA-event times of the port's device steps and kernels, for this checkout
of the port or another one, on one card.

    python3 step_times.py [--repo PATH] [--profile]

On ``chip_smoke.py``'s D652 database (652 leaves, 1,303 branches, k = 10) with
its first batch of 16,384 reads (IUPAC reads among them), and
``TorchPlacer`` on the dense route, it times:

* the dense device step;
* the gather alone (``rowgather_sum``) and the finish alone (``finish_topk``)
  on its sums, and their sum: what the dense step ran before the fusion;
* the fused kernel (``rowgather_sum_topk``);
* under ``pair_plane="off"``, ``precision="int16"``, ``plane_mode="classic"``
  and ``precision="bf16"`` (each its own plane), the unpaired dense step
  (``place_batch_dense_bytes``) and the kernel it ends in
  (``rowgather_sum_topk``, ``rowgather_sum_topk_int16``,
  ``rowgather_sum_counts``, ``rowgather_sum_counts_bf16``).

On ``chip_smoke.py``'s config-4 database (10,000 leaves, 19,999 branches,
k = 10) with 4,096 clean 150 bp reads and 4,096 400 bp reads, and
``TorchPlacer(dense_db="off")`` with packed tiles, then f32 tiles:

* the packed and the f32 tile steps on the 150 bp batch;
* the CSR step on the 400 bp batch;
* kernel 2 (``accumulate_packed_topk``) on the packed tile step's cells;
* kernel 4 with counts (``accumulate_sums_counts``) on the CSR step's cells,
  and without (``accumulate_sums``) on the f32 tile step's cells;
* the finish (``finish_topk``) on the f32 tile step's (4,096 x 19,999) sums;
* on the dense route (the unpaired 51.8 GB plane, the CLI's default route on
  an 80 GB card), the dense step on the 150 bp batch and its fused kernel.

``--repo`` times the ``epik_tpu_torch`` of another checkout of this
repository (the fixture and the timing helpers stay this checkout's
``chip_smoke.py``); an entry point that port lacks is skipped and named under
``"skipped"``. To compare two commits on one card, unpack the other one under
``build/`` and run this script for it and for ``.`` in turns, in one call.
``--profile`` also prints the dense and the CSR step's time by operator
(``torch.profiler`` over 20 steps). Prints the card line of ``nvidia-smi``
and one JSON object. Needs a CUDA device; imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke
from chip_smoke import (
    BATCH,
    BT_BATCH,
    BT_LONG,
    TIMING_REPS,
    bigtree_db,
    card_line,
    cuda_ms,
    d652_fixture,
    recording,
)


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
    from epik_tpu_torch.engine.step import place_batch_dense_paired
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
    out["dense_R"] = len(seqs)
    out["dense_step_ms"] = cuda_ms(torch, lambda: place_batch_dense_paired(
        st.plane, st.combo, buf_t, arows_t, **step_kw))
    if profile:
        print_profile(torch, lambda: place_batch_dense_paired(
            st.plane, st.combo, buf_t, arows_t, **step_kw),
            f"dense step, R={len(seqs)}, Amax={Amax}")
    rows, lens = tokenize_combo(buf_t, st.combo, k=k, Lmax=Lmax)
    m_signed = (lens - (k - 1)).float()
    m_f32 = torch.where(m_signed >= 0, m_signed, m_signed + float(2**64))
    Sp = kernels_mod.rowgather_sum(st.plane, rows)[:, :B]
    out["rowgather_sum_ms"] = cuda_ms(torch, lambda: kernels_mod.rowgather_sum(st.plane, rows))
    out["finish_topk_d652_ms"] = cuda_ms(torch, lambda: kernels_mod.finish_topk(Sp, m_f32,
                                                                                **kw))
    out["rowgather_sum_plus_finish_topk_ms"] = (out["rowgather_sum_ms"]
                                                + out["finish_topk_d652_ms"])
    if hasattr(kernels_mod, "rowgather_sum_topk"):
        fused = kernels_mod.rowgather_sum_topk
        amb_read, delta = dense_mod.amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=B,
                                               k=k, eps=float(placer.eps),
                                               log_eps=float(placer.log_eps))
        out["rowgather_sum_topk_ms"] = cuda_ms(
            torch, lambda: fused(st.plane, rows, m_f32, amb_read, delta, B=B, **kw))
    else:
        out["skipped"].append("rowgather_sum_topk: the port has no fused kernel 1")
    del placer, st
    torch.cuda.empty_cache()
    variant_times(torch, dev, out, db, tree, seqs)


#: the unpaired D652 configs: name, PlacerConfig fields, the kernel the step ends in
VARIANTS = [
    ("pair_off", {"pair_plane": "off"}, "rowgather_sum_topk"),
    ("int16", {"precision": "int16"}, "rowgather_sum_topk_int16"),
    ("classic", {"plane_mode": "classic"}, "rowgather_sum_counts"),
    ("bf16", {"precision": "bf16"}, "rowgather_sum_counts_bf16"),
]


def unpaired_step_times(torch, dev, out: dict, placer, seqs, prefix: str,
                        kernel: str) -> None:
    """The unpaired dense step of ``placer`` on ``seqs`` and the kernel it
    ends in (its first call recorded) into ``out``."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.engine import step as step_mod

    st = placer.state
    buf, arows, Amax, Lmax, _ = placer._stage_bytes(seqs)
    buf_t, arows_t = torch.from_numpy(buf).to(dev), torch.from_numpy(arows).to(dev)
    step_kw = dict(B=placer.B, K=placer._K(), Amax=Amax, k=placer.k, Lmax=Lmax,
                   num_kmers=st.n_keys, log_eps=float(placer.log_eps), eps=float(placer.eps),
                   shifted=placer._shifted, plane_scale=st.scale)

    def step():
        return step_mod.place_batch_dense_bytes(st.plane, st.direct, buf_t, arows_t,
                                                **step_kw)

    calls = []
    with recording(step_mod, kernel, calls):
        step()
    out[f"{prefix}_step_ms"] = cuda_ms(torch, step)
    fn = kernels_mod.KERNELS[kernel]
    args, kw = calls[0]
    out[f"{prefix}_{kernel}_ms"] = cuda_ms(torch, lambda: fn(*args, **kw))
    out[f"{prefix}_{kernel}_shape"] = list(args[1].shape)


def variant_times(torch, dev, out: dict, db, tree, seqs) -> None:
    """The D652 dense step and kernel under each of ``VARIANTS``, where the
    port has the unpaired step."""
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer

    if not hasattr(step_mod, "place_batch_dense_bytes"):
        out["skipped"].append("dense variants: the port has no unpaired dense step")
        return
    for name, fields, kernel in VARIANTS:
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        unpaired_step_times(torch, dev, out, placer, seqs, f"d652_{name}", kernel)
        del placer
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=None, help="checkout whose port is timed")
    ap.add_argument("--profile", action="store_true",
                    help="print the dense and the CSR step's time by operator")
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
    db, ref = bigtree_db()
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, BT_BATCH, length=150, mutation_rate=0.02, seed=11)
    long_reads = reads_from_reference(ref, BT_LONG, length=400, mutation_rate=0.02, seed=12)
    seqs = list(dict.fromkeys(s for _, s in reads))
    long_seqs = list(dict.fromkeys(s for _, s in long_reads))
    out = {"port": os.path.dirname(os.path.abspath(epik_tpu_torch.__file__)),
           "device": torch.cuda.get_device_name(0), "B": tree.get_node_count(),
           "skipped": []}
    dense_times(torch, dev, out, args.profile)
    torch.cuda.empty_cache()

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
    del placer, step, csr_step, calls, b, s
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

    if hasattr(step_mod, "place_batch_dense_bytes"):
        placer = TorchPlacer(db, tree, device=dev)
        if placer.route != "dense" or placer._paired:
            raise AssertionError(f"config 4 took route {placer.route}, not the unpaired plane")
        unpaired_step_times(torch, dev, out, placer, seqs, "config4_dense",
                            "rowgather_sum_topk")
        del placer
    else:
        out["skipped"].append("config 4 dense: the port has no unpaired dense step")
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
