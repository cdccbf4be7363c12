#!/usr/bin/env python3
"""CUDA-event times of the big tree's device steps and of kernel 4, for this
checkout of the port or another one, on one card.

    python3 step_times.py [--repo PATH] [--profile]

On ``chip_smoke.py``'s config-4 database (10,000 leaves, 19,999 branches,
k = 10) with 4,096 clean 150 bp reads and 4,096 400 bp reads, and
``TorchPlacer(dense_db="off")`` with packed tiles, then f32 tiles, it times:

* the packed and the f32 tile steps on the 150 bp batch;
* the CSR step on the 400 bp batch;
* kernel 4 with counts (``accumulate_sums_counts``) on the CSR step's cells,
  and without (``accumulate_sums``) on the f32 tile step's cells.

``--repo`` times the ``epik_tpu_torch`` of another checkout of this
repository (the fixture and the timing helpers stay this checkout's
``chip_smoke.py``). To compare two commits on one card, unpack the other one
under ``build/`` and run this script for it and for ``.`` in turns, in one
call. ``--profile`` also prints the CSR step's device time by kernel
(``torch.profiler`` over 20 steps). Prints the card line of
``nvidia-smi`` and one JSON object. Needs a CUDA device; imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke
from chip_smoke import (
    BT_BATCH,
    BT_LONG,
    TIMING_REPS,
    bigtree_db,
    card_line,
    cuda_ms,
    recording,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=None, help="checkout whose port is timed")
    ap.add_argument("--profile", action="store_true",
                    help="print the CSR step's device time by kernel")
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
           "device": torch.cuda.get_device_name(0), "B": tree.get_node_count()}

    placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device=dev)
    step, OV, _ = placer._stage_tiles(seqs)
    out["tile_step_ms"] = cuda_ms(torch, lambda: step(OV))
    csr_step, P, PA, _ = placer._stage_csr(long_seqs)
    out["csr_step_ms"] = cuda_ms(torch, lambda: csr_step(P, PA))
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TIMING_REPS):
                csr_step(P, PA)
            torch.cuda.synchronize()
        print(f"CSR step, {TIMING_REPS} steps, R={len(long_seqs)} x 400 bp, P={P}:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15,
                                        max_name_column_width=60))
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
    calls = []
    with recording(step_mod, "accumulate_sums", calls):
        placer.place(reads)
    (b, s), kw = calls[0]
    out["accumulate_sums_ms"] = cuda_ms(
        torch, lambda: kernels_mod.accumulate_sums(b, s, **kw))
    out["accumulate_sums_shape"] = list(b.shape)
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
