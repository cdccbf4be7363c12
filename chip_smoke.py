#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``epik_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result line):

1. device   -- the card's name and power limit (nvidia-smi); no CUDA -> exit 1;
2. build    -- nvcc builds every CUDA kernel from ``epik_tpu_torch/kernels/csrc``
               (one nvcc per source, all at once);
3. fixture  -- the D652 database (652 leaves, k=10, ~410k k-mers) and a FASTA of
               65,536 150 bp reads plus a few IUPAC and shorter-than-k reads;
4. kernels  -- the slot tokenizer's kernel against the torch ops it replaces
               (its plain version) at the path's batch and at the benchmark
               cell's 2,000 reads, bit for bit, two launches alike, and
               CUDA-event times of both; the dense path's kernel, the row
               gather with the ambiguous delta rows and the finish fused in
               (``rowgather_sum_topk``),
               against its plain PyTorch version at the path's shapes (R =
               16,384) on a batch with IUPAC reads and on a clean one, and on
               the finish's engineered rows, two launches alike; the gather
               alone (``rowgather_sum``) and the finish alone (``finish_topk``)
               against theirs at the same shapes; CUDA-event times of all; the
               device step time; place() reads/s;
5. main     -- ``python -m epik_tpu_torch place`` (in process) over the FASTA,
               with every kernel's launch count zeroed just before and read
               just after: the fused kernel must have launched, the tokenizer
               kernel as often (once a batch), the gather and the finish
               apart never;
6. parity   -- the scalar oracle (``ReferencePlacer``) on the first 256 reads
               against the jplace, score sets within 1e-4;
7. big tree -- BASELINE.md config 4 (10,000 leaves, 19,999 branches, k=10,
               ~644k k-mers) with 32,768 150 bp reads (a few IUPAC reads, so
               batches split, and short reads) and one batch of 4,096 400 bp
               reads, which takes the CSR step whole; batches of 4,096:
               * the tile and CSR kernels against their plain versions on the
                 inputs the path gives them (recorded from a placement) and on
                 engineered rows (kernel 2: n = 0, n < K, distinct branches,
                 ties at the K cut, Q1, Q3; kernel 4, with counts and without),
                 bit for bit, and two launches alike; CUDA-event times; kernel 4's
                 tiles and threads per block; the share of valid cells in the
                 400 bp CSR batch; the counts finish (``finish_topk_counts``)
                 on that batch's (4,096 x 19,999) sums and counts and on
                 engineered rows (C > m, m = 2**64, n = 0, n < K, ties, Q3),
                 both forms, against its plain version (the torch finish);
                 the device step times (packed tiles, f32 tiles, CSR);
               * ``TorchPlacer(dense_db="off")`` through ``run_pipeline`` with
                 the CLI's FASTA reader and the jplace writer, the counts zeroed
                 before and read after: the packed tile kernel, the CSR
                 kernel and the counts finish must have launched; then one pass with
                 ``tile_payload="f32"``: the sums kernel and the finish must
                 have launched; the finish against its plain version on that
                 pass's (4,096 x 19,999) sums, and its time there;
               * both passes against the scalar oracle on 256 reads (IUPAC,
                 short and 400 bp reads among them), score sets within 1e-4;
8. sharded  -- the column-sharded big-tree path on phase 7's database and reads:
               * ``ShardedTorchPlacer`` on a 1x1 mesh (one shard of 20,096
                 columns): kernel 3's sums (``accumulate_packed_sums``) against
                 their plain version, bit-equal, on the inputs the path gives
                 them and on engineered rows; CUDA-event times of the kernel,
                 its plain version, a library scatter-add, the column finish
                 and the device step;
               * the placer through ``run_pipeline`` with the port's FASTA reader
                 and jplace writer, the counts zeroed before and read after:
                 kernel 3's sums, the CSR kernel and the counts finish must have launched; 256
                 reads against the scalar oracle, score sets within 1e-4;
               * a 1x4 mesh laid on the one card (4 shards of 5,120 columns) on
                 8,192 clean reads and the IUPAC and short ones, score sets
                 within 1e-4 of the 1x1 jplace;
               * both meshes finish through the column finish, one launch of
                 kernel A (``finish_cols_partial``) per shard and tile step:
                 checked against its plain version at (4,096 x 20,096) (the
                 pack bit-equal but its exp-sum e_s, rtol 1e-6), and timed
                 beside the same finish in torch ops and the tile step.
9. dense    -- the rest of the single-device dense engine:
               * config 4 through ``python -m epik_tpu_torch place`` with no
                 flags (phase 7's database saved and loaded, its FASTA): the
                 51.8 GB base plane fits the card and the pair plane does not,
                 so the CLI takes the unpaired dense route, and there the
                 route the width rule (``kernels/rowgather.py::shifted_fused``)
                 gives at 20,096 columns: the gather, the delta add and
                 ``finish_topk``; the launches counted, the pair's kernels
                 launched and the fused kernel never; the fused kernel at
                 (4,096 x 143) rows and bw 20,096 against its plain version on
                 the first batch whichever route the step took, its time
                 beside its unfused pair's on the same rows, the device
                 step's; 256 reads against the oracle, within 1e-4;
               * D652 under ``--pair-plane off``, ``--plane-mode classic``,
                 ``--precision int16``, ``--precision bf16`` (the CLI) and
                 ``lookup_where="device"``, ``tokenize_where="host"`` (the
                 library, through run_pipeline): each config's kernel (the
                 fused kernel over the unpaired f32 or the int16 plane, the
                 fused counts kernel ``rowgather_sum_counts_topk[_bf16]``
                 over the classic f32 or bf16 plane) against its plain
                 version on the first batch, bit for bit (wr within rtol
                 1e-4), beside its time the unfused pair's and its group
                 layout (G, blocks an SM), no gather or finish apart
                 launched, and the sums with
                 counts alone (``rowgather_sum_counts[_bf16]``, past the
                 limit) on the same rows; the fused counts kernel on the same
                 rows without their first hits, and beside its time the
                 unfused pair's (the sums with counts, the first hits added,
                 ``finish_topk_counts``); 256 reads against the oracle
                 (int16 by the jplace_diff rule, bf16 by the best edge, as
                 the JAX tests hold them);
               * a batch of reads shorter than k and a batch with a 65,536 bp
                 read (the host tokenizer) against the oracle;
               * the fused kernel at B = 30,000, and past its shared-memory
                 limit at B = 40,000 (the gather and the finish apart), and
                 ``finish_topk`` at B = 70,000 (ids in the global workspace),
                 against their plain versions; the fused counts kernel (f32,
                 bf16) at the widest B its shared memory takes and one branch
                 past it (the classic step then runs the sums with counts and
                 ``finish_topk_counts`` apart, the same bits), and
                 ``finish_topk_counts`` at B = 65,537 in both forms.
10. sharded dense -- the column-sharded dense engine, one kernel per shard
               where the width rule takes it: kernel 1 with the shard's
               column finish in its epilogue (``rowgather_sum_cols`` up to
               1,024 columns; classic ``rowgather_sum_counts_cols``), else
               the gather, the delta add and kernel A:
               * D652 through ``python -m epik_tpu_torch place --engine sharded``
                 on a 1x1 mesh (the pair plane in one shard of 1,408 columns,
                 where the rule gives the unfused pair), the counts zeroed
                 before and read after: the route's kernels must have
                 launched, no other dense kernel; 256 reads against the
                 oracle; the fused kernel against its plain version on the
                 recorded call (the pack bit-equal but e_s, rtol 1e-6; two
                 launches alike), its CUDA-event time beside its unfused
                 pair's, its group layout, bound and ``embedding_bag``'s (S
                 alone), the sharded step's time; the CLI's reads/s;
               * D652 on a 1x4 mesh laid on the card (4 shards of 384 columns,
                 the fused column kernel's main path) through run_pipeline,
                 within 1e-4 of the 1x1 jplace, the fused kernel launched on
                 every shard and checked on each;
               * D652 ``plane_mode="classic"`` on 1x1 through the library: the
                 fused counts kernel (its candidates' counts bit-equal too)
                 against its plain version and the oracle, and beside its
                 time the unfused pair's (the sums with counts, the first
                 hits added, kernel A's counts form); kernel A's counts form
                 on the same shard's sums and counts;
               * config 4 through ``--engine sharded`` with no other flag: the
                 51.8 GB unpaired column plane (the pair plane is over the
                 budget), 12,288 clean reads, the IUPAC and short reads, the
                 reads the oracle checks and the 4,096 400 bp reads; the
                 route of the width rule (the gather, the delta add and
                 kernel A; the fused kernel never); 256 reads against the
                 oracle; the fused kernel checked at (4,096 x 143) rows, bwl
                 20,096, whichever route the shard took, and timed beside its
                 unfused pair;
               * both fused kernels at the widest shard their shared memory
                 takes and one group of four columns past it: at the limit
                 the fused kernel against its plain version, and the route
                 the shard takes (past the limit, and for the shifted form
                 past the width rule, the gather, the adds and kernel A
                 apart: the same pack but e_s), and kernel A in both forms at
                 bwl = 70,016 (ids in the global workspace), against their
                 plain versions.

11. amino   -- BASELINE.md config 2 at full size (652 leaves, 1,303 branches,
               amino k = 8, ~400k k-mers, the 2.25 GB shifted plane, the radix
               index's low-pair-overlap form) with 20,000 144 aa reads plus a
               few X/B/Z, shorter-than-k and no-hit reads, batches of 4,096:
               * ``python -m epik_tpu_torch place -s amino``, the counts zeroed
                 before and read after: the codes tokenizer and the radix
                 lookup, then the fused kernel, which must have launched (the
                 gather and the finish apart never); 256 reads against the
                 oracle; the fused kernel against its plain version on the
                 batch with delta rows and on one without, bit for bit,
                 its time, bound and ``embedding_bag``'s time at that shape;
                 the window rows against the host's binary search; the codes
                 step's time, the tokenizer's and the lookup's apart;
                 ``place()`` reads/s;
               * ``--pair-plane on`` (the pair radix), ``--precision int16``
                 and ``--engine sharded`` (1x1, the host-tokenized rows step,
                 on the width rule's route for a shard of 1,408 columns),
                 then DNA k = 14 at D652's leaves and reference (the codes
                 tokenizer over 28-bit keys) with 8,192 of D652's reads, each
                 against the oracle with its kernel launched.
12. last configs -- the two ``PlacerConfig`` paths that came last, on phase 7's
               config-4 database and its 36,864 reads (IUPAC, short and the
               400 bp batch among them):
               * ``PlacerConfig(dense_db="off", pair_plane="on")``: route
                 tiles, the pair-fused plane (its bytes printed); kernel 2
                 over the recorded pair-row cells (ceil(W/2) * 2 * PT a read)
                 against its plain version, bit-equal but log_sum, its time
                 and bound; the pair-fused tile step against the unpaired
                 one, in turns; through ``run_pipeline``, the counts zeroed
                 before and read after: kernel 2 launched once per tile step;
                 256 reads against the oracle;
               * ``PlacerConfig(accumulate="scatter")``: route csr for every
                 batch; kernel 4's row-pointer form
                 (``accumulate_sums_counts_csr``) on the 400 bp batch's flat
                 cells and on engineered ones against its plain version, bit
                 for bit, its time, bound and ``index_put_``'s (the sums
                 into (R+1, B), timed only); the step's peak memory; the flat
                 CSR step against the per-read one, in turns; through
                 ``run_pipeline``: the row-pointer kernel and the counts
                 finish launched, kernel 4's (R, PP) form never;
                 ``overflow_retries``; 256 reads against the oracle;
               * ``ShardedTorchPlacer(make_mesh(1, 1), accumulate="scatter")``
                 on 8,192 reads, the reads the oracle checks and the 400 bp
                 batch, against the oracle.

13. surface -- the rest of the port's surface, each in processes of its own:
               * ``python -m epik_tpu_torch.tools.verify_cuda`` on the card: the
                 ppdiff cases and the mixed reads through every engine against
                 the oracle; its JSON line printed, ``"ok": false`` fails;
               * D652 through ``place --engine sharded --num-processes 2``,
                 ranks 0 and 1 on the one card (gloo, a 2x1 mesh): each rank's
                 jplace equal to phase 10's 1x1 run read by read;
                 the same kernels launched as in that run, the all-gather's ms per
                 batch and the reads/s of each rank;
               * ``tools/multihost_worker.py`` in its ``csr`` mode on two ranks
                 of the card: ``PARITY OK`` on both;
               * two D652 batches through ``place --profile-dir``: the Chrome
                 trace names the fused shifted kernel (the group layout's
                 ``rowgather_group_kernel<float, 4, false, false>``) and no
                 other instance of the template;
               * ``stats``, ``convert`` (.eptk -> .ipk -> .eptk, byte-equal) and
                 ``diff`` (phase 5's jplace against rank 0's) on D652;
               * 13f, a model group over two processes: D652 through ``place
                 --engine sharded --n-model 2 --num-processes 2``, ranks 0 and
                 1 on the card, one 768-column shard of the pair plane each (a
                 1x2 mesh whose row spans both ranks; the shards' partial
                 packs cross between them, ``parallel/exchange.py``): each
                 rank's jplace equal read by read to the single-process 1x2
                 run laid on the card (``ShardedTorchPlacer(make_mesh(1, 2,
                 devices=[cuda] * 2))`` through the port's writer);
                 ``rowgather_sum_cols`` launched on each rank (its counts on
                 the kernels line's entry, ``model_group_launches``); each
                 rank's reads/s, all-gather and model-exchange ms a batch;
                 ``tools/multihost_worker.py --slots 1 --n-model 2`` in its
                 dense, csr, tiles and scatter modes: ``PARITY OK`` on both
                 ranks, with their launches; the worker's file mode on two
                 D652 batches in csr mode (the IUPAC batch through the
                 host-staged CSR step, a clean one through the bytes step):
                 the (R, B) sums and counts the CSR merges exchange, their ms
                 and MB a batch, every read equal to the single-process 1x2
                 run. The card is freed between the runs.

14. wide classic -- the classic dense route past the fused counts kernel's
               limit, where the gather with counts (kernel 1c,
               ``rowgather_sum_counts[_bf16]``, in locality order and column
               slices) and ``finish_topk_counts`` run apart: BASELINE.md
               config 4's recipe at 11,100 leaves (B = 22,199, bw 22,272,
               ~644k k-mers), 8,192 150 bp reads in batches of 4,096:
               * ``python -m epik_tpu_torch place --plane-mode classic`` (the
                 ~57 GB f32 plane), then the same with ``--precision bf16``
                 (~29 GB), the counts zeroed before and read after: the dense
                 route, 1c and the counts finish once per batch and nothing
                 else; 128 reads against the oracle, score sets within 1e-4
                 (bf16: the oracle on bf16-rounded scores, and the best edge
                 of the exact oracle by the bf16 rule); 1c against its plain
                 version on the path's first batch, bit for bit, two launches
                 alike, its time, bound and ``embedding_bag``'s;
               * ``place --engine sharded --plane-mode classic`` on a 1x1 mesh
                 (one shard of 22,272 columns, past the fused counts column
                 kernel's limit, bwl ~22,064), the counts zeroed before and
                 read after: 1c and kernel A's counts form
                 (``finish_cols_partial_counts``) once per batch and nothing
                 else; 128 reads against the oracle and every read against
                 the f32 single-device run, score sets within 1e-4; kernel A
                 against its plain version on the first batch's sums and
                 counts (bit-equal but e_s, rtol 1e-6), its time and bound.

15. wide shifted -- the shifted dense route past the fused kernel's limit,
               where the gather alone (kernel 1d, ``rowgather_sum``, in
               locality order and column slices) and
               ``finish_topk`` run apart: BASELINE.md config 4's recipe at
               20,000 leaves on D652's 520,000 bp reference (B = 39,999, bw
               40,064, ~410k k-mers; the reference is cut only where the 65.7
               GB f32 plane would be over the card's budget), 8,192 150 bp
               reads, the first 6 with IUPAC codes, in batches of 4,096:
               * ``python -m epik_tpu_torch place`` with no flags (the f32
                 plane), then with ``--precision int16`` (~33 GB), the counts
                 zeroed before and read after: the dense route, 1d and
                 ``finish_topk`` once per batch and nothing else (the fused
                 kernel's ``topk_fits`` refuses B = 39,999); 128 reads against
                 the oracle (f32: score sets within 1e-4; int16: the
                 jplace_diff rule); 1d against its plain version on the
                 path's first batch, bit for bit, two launches alike, its
                 time, bound and ``embedding_bag``'s (f32).

Every kernel's entry carries its bound: the larger of the bytes it must move
(each input read once, each output written once) over the card's HBM rate and
its operations over the card's f32 rate (NVIDIA's H100 SXM data sheet), and
the time of one PyTorch library call that computes the same function, where
there is one.

Output: progress lines, then the card line, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Neither JAX nor the JAX package
``epik_tpu`` is imported.
"""

from __future__ import annotations

import ast
import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384
#: the benchmark cell's batch (``placebench``'s d652.illumina150, the CLI's default)
CELL_BATCH = 2000
N_READS = 65536
PARITY_READS = 256
TIMING_REPS = 20
#: the fused shifted kernel's name in a profiler trace: the group template's
#: f32 shifted slim-pack instance (csrc/rowgather_sum.cu)
SHIFTED_KERNEL = "rowgather_group_kernel<float, 4, false, false>"

#: the big-tree phase (BASELINE.md config 4, tools/bench_bigtree.py:30,47-55)
BT_BATCH = 4096
BT_READS = 32768
BT_LONG = 4096  # one batch of 400 bp reads: past the packed gate, all on CSR
BT_IUPAC = 6  # spread over the first batches, so they split tiles + CSR
#: the sharded phase's 1x4 mesh places this many clean big-tree reads
SH_READS = 8192
#: clean 150 bp reads of config 4 on the sharded dense route (phase 10)
C4_SHARDED_READS = 12288
#: the amino phase (BASELINE.md config 2, epik_tpu/tools/bench_configs.py:38-45)
AA_BATCH = 4096
AA_READS = 20000
#: D652's reads placed on the DNA k = 14 database (phase 11)
K14_READS = 8192
#: the wide classic phase (phase 14): config 4's recipe at 11,100 leaves, past
#: the fused counts kernel's limit; reads of 150 bp, batches, oracle reads
WC_READS = 8192
WC_BATCH = 4096
WC_PARITY = 128
#: the wide shifted phase (phase 15): config 4's recipe at 20,000 leaves on
#: D652's reference length, past the fused kernel's limit; reads of 150 bp
#: (the first 6 with IUPAC codes), batches, oracle reads
WS_READS = 8192
WS_BATCH = 4096
WS_PARITY = 128

#: the device the subprocesses of phase 13 place on (their --platform)
PLATFORM = "cuda"

#: the card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): HBM bytes/s
#: and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: f32 operations of the finish per (read, branch): the correction (add,
#: multiply, divide) and the LWR term (subtract, multiply, exp, add), less the
#: top-K's comparisons
FINISH_OPS = 7

KERNEL_META = {
    "rowgather_sum": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                      "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_topk": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                           "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "finish_topk": ("epik_tpu_torch/kernels/csrc/finish_topk.cu",
                    "epik_tpu/ops/pallas/accumulate.py:214"),
    "accumulate_packed_topk": ("epik_tpu_torch/kernels/csrc/accumulate_packed_topk.cu",
                               "epik_tpu/ops/pallas/accumulate.py:320"),
    "accumulate_sums": ("epik_tpu_torch/kernels/csrc/accumulate_sums.cu",
                        "epik_tpu/ops/pallas/accumulate.py:403"),
    "accumulate_sums_counts": ("epik_tpu_torch/kernels/csrc/accumulate_sums.cu",
                               "epik_tpu/ops/pallas/accumulate.py:436"),
    "accumulate_packed_sums": ("epik_tpu_torch/kernels/csrc/accumulate_packed_topk.cu",
                               "epik_tpu/ops/pallas/accumulate.py:369"),
    "rowgather_sum_topk_int16": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                 "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_counts": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                             "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_counts_bf16": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                  "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # the classic steps' #1 with the counts finish fused in
    "rowgather_sum_counts_topk": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                  "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_counts_topk_bf16": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                       "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # #2's finish with the count term (the CSR steps', after #5)
    "finish_topk_counts": ("epik_tpu_torch/kernels/csrc/finish_topk.cu",
                           "epik_tpu/ops/pallas/accumulate.py:214"),
    # the column finish is an XLA function in the JAX package, no Pallas kernel
    "finish_cols_partial": ("epik_tpu_torch/kernels/csrc/finish_cols.cu",
                            "epik_tpu/parallel/sharding.py:345"),
    "finish_cols_partial_counts": ("epik_tpu_torch/kernels/csrc/finish_cols.cu",
                                   "epik_tpu/parallel/sharding.py:321"),
    # kernel 1 with one shard's column finish fused in (the sharded dense steps)
    "rowgather_sum_cols": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                           "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # config 4's width (bw 20,096; phases 9 and 10), which the width rule
    # routes to the unfused pair: its gather, #1's / 1e's time beside it
    "rowgather_sum_config4": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                              "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_sharded_config4": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                      "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_counts_cols": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                  "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # the fused kernel 1 on the amino main path (phase 11)
    "rowgather_sum_topk_config2": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                   "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # kernel 2 over the pair-fused tiles' 2 * PT pair rows (phase 12)
    "accumulate_packed_topk_paired": ("epik_tpu_torch/kernels/csrc/accumulate_packed_topk.cu",
                                      "epik_tpu/ops/pallas/accumulate.py:320"),
    # kernel 4's row-pointer form over the scatter engine's flat cells, where
    # JAX scatter-adds (epik_tpu/engine/placer.py:378-379)
    "accumulate_sums_counts_csr": ("epik_tpu_torch/kernels/csrc/accumulate_sums.cu",
                                   "epik_tpu/ops/pallas/accumulate.py:436"),
    # the gather with counts on the wide classic path (phase 14), past the
    # fused counts kernel's limit
    "rowgather_sum_counts_wide_classic": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                          "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_counts_bf16_wide_classic": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                               "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # kernel A's counts form on the wide classic shard (phase 14's sharded run)
    "finish_cols_partial_counts_wide_classic": ("epik_tpu_torch/kernels/csrc/finish_cols.cu",
                                                "epik_tpu/parallel/sharding.py:321"),
    # the gather alone on the wide shifted path (phase 15), past the fused
    # kernel's limit
    "rowgather_sum_wide_shifted": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                   "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    "rowgather_sum_int16_wide_shifted": ("epik_tpu_torch/kernels/csrc/rowgather_sum.cu",
                                         "epik_tpu/ops/pallas/rowgather_mq.py:117"),
    # the pair-plane slot tokenizer: XLA ops in the JAX package, no Pallas kernel
    "tokenize_combo_fused": ("epik_tpu_torch/kernels/csrc/tokenize.cu",
                             "epik_tpu/engine/placer.py:1038"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    larger of ``nbytes`` over the HBM rate and ``ops`` over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name: str, launches: int, err: float, ms: float, plain_ms: float,
          nbytes: float, ops: float, library_ms: float | None, **extra) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line; ``extra``: the
    fused kernels' ``pair_ms`` (their unfused pair on the same rows), ``G``
    and ``blocks_per_sm`` (their group layout's launch)."""
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
            "replaces": KERNEL_META[name][1], "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def group_launch(torch, plane, B: int, K: int, counts: bool, cols: bool) -> dict:
    """The group layout's launch at the plane's width: G (the wrapper's
    choice) and the blocks of it an SM holds (the card's occupancy
    calculator for the compiled kernel)."""
    from epik_tpu_torch.kernels import rowgather as rg
    from epik_tpu_torch.kernels._build import library

    lib = library()
    limit = lib.epik_rowgather_group_smem_limit()
    bw = plane.shape[1]
    G = (rg.counts_group if counts else rg.shifted_group)(bw, B, K, limit)
    cell = {torch.float32: 0, torch.int16: 1, torch.bfloat16: 2}[plane.dtype]
    per_sm = (lib.epik_rowgather_counts_group_blocks_per_sm if counts
              else lib.epik_rowgather_shifted_group_blocks_per_sm)
    return {"G": G, "blocks_per_sm": per_sm(G, bw, B, K, cell, int(cols))}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_finish(np, got, want, K: int, B: int, what: str) -> float:
    """The finish criteria: scores, every index (the -inf slots hold the
    lowest untouched branches in both), n and zero_sum bit-equal, log_sum
    within rtol 1e-6 (its sum of exponentials runs in another order). Returns
    the largest absolute difference over the finite entries."""
    if not np.array_equal(got[:, :K], want[:, :K]):
        raise AssertionError(f"{what}: scores differ from the plain version")
    if not np.array_equal(got[:, K:2 * K], want[:, K:2 * K]):
        raise AssertionError(f"{what}: top-K indices differ")
    idx = got[:, K:2 * K]
    if not ((idx >= 0) & (idx < B)).all():
        raise AssertionError(f"{what}: an index lies outside [0, {B})")
    if not np.array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:]):
        raise AssertionError(f"{what}: n or zero_sum differ")
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6,
                               err_msg=f"{what}: log_sum")
    fin = np.isfinite(got) & np.isfinite(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        raise AssertionError(f"{what}: finite entries differ")
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def check_full_pack(np, got, want, K: int, B: int, what: str) -> float:
    """The full pack's body [scores | wr | idx | counts | n | zero_sum]:
    scores, every index, the counts, n and zero_sum bit-equal, wr within rtol
    1e-4 (10**(score - log_sum), log_sum summed in another order). Returns
    the largest absolute difference over the finite entries."""
    if not np.array_equal(got[:, :K], want[:, :K]):
        raise AssertionError(f"{what}: scores differ from the plain version")
    if not np.array_equal(got[:, 2 * K:], want[:, 2 * K:]):
        raise AssertionError(f"{what}: indices, counts, n or zero_sum differ")
    idx = got[:, 2 * K:3 * K]
    if not ((idx >= 0) & (idx < B)).all():
        raise AssertionError(f"{what}: an index lies outside [0, {B})")
    np.testing.assert_allclose(got[:, K:2 * K], want[:, K:2 * K], rtol=1e-4, atol=1e-30,
                               err_msg=f"{what}: wr")
    fin = np.isfinite(got) & np.isfinite(want)
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        raise AssertionError(f"{what}: finite entries differ")
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def check_counts_finish(torch, np, S, C, m, kw: dict, B: int, what: str) -> float:
    """``finish_topk_counts`` against its plain version (the torch finish of
    the CSR steps), the full body by check_full_pack and the slim pack by
    check_finish, two launches alike. Returns the largest difference."""
    from epik_tpu_torch.kernels.finish import finish_topk_counts, finish_topk_counts_plain

    got, again = finish_topk_counts(S, C, m, **kw), finish_topk_counts(S, C, m, **kw)
    want = finish_topk_counts_plain(S, C, m, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"finish_topk_counts ({what}): two launches differ")
    check = check_full_pack if kw.get("full", True) else check_finish
    return check(np, got.cpu().numpy(), want.cpu().numpy(), kw["K"], B,
                 f"finish_topk_counts ({what})")


def fused_rows_case(torch, np, dev, Sp_e, m_e):
    """The engineered finish rows ``Sp_e`` (R, B) as a fused-kernel input: a
    plane holding them (padded to a multiple of 128 columns) and an all-zero
    last row, and slot rows naming each read's own row, then the zero row, so
    that the window-order sums are exactly ``Sp_e``."""
    R, B = Sp_e.shape
    bw = -(-B // 128) * 128
    plane = np.zeros((R + 1, bw), np.float32)
    plane[:R, :B] = Sp_e
    rows = np.full((R, 3), R, np.int32)
    rows[:, 0] = np.arange(R)
    return (torch.from_numpy(plane).to(dev), torch.from_numpy(rows).to(dev),
            torch.from_numpy(m_e).to(dev))


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq.decode()}\n")


def check_parity(ref_out, rows_by_name, what: str, rule: str = "sets") -> float:
    """The scalar oracle's placements ``ref_out`` against jplace rows (name
    -> [(edge, likelihood)]), by ``rule``:

    * "sets": score sets within 1e-4 for every read;
    * "jplace_diff": the rule of ``tools/jplace_diff.py``: a read whose sets
      differ matches when every edge of either lies within 1e-4 in
      probability space (a 65,536 bp read's scores near -27,000 keep f32's
      relative 1e-7; the int16 plane's quantization, docs/QUIRKS.md);
    * "top_edge": the bf16 plane's rule (``tests/test_jax_engine.py``): the
      best edge the same for at least 28 of 30 reads, its score within 2e-2.

    Returns the largest difference of the score sets that matched
    ("top_edge": the share of reads whose best edge agrees)."""
    worst, agree, n = 0.0, 0, 0
    for q in ref_out.placed_seqs:
        want = {p.branch_id: p.score for p in q.placements}
        for name in ref_out.sequence_map[q.sequence]:
            got = dict(rows_by_name[name])
            if rule == "top_edge":
                if want and got:
                    n += 1
                    best_w, best_g = max(want, key=want.get), max(got, key=got.get)
                    agree += best_w == best_g
                    if abs(want[best_w] - got[best_g]) > max(2e-2, 2e-2 * abs(want[best_w])):
                        raise AssertionError(f"{what} {name}: best scores {want[best_w]} "
                                             f"vs {got[best_g]}")
                continue
            sa, sb = sorted(want.values()), sorted(got.values())
            d = max((abs(a - b) for a, b in zip(sa, sb)), default=0.0)
            if len(sa) == len(sb) and d <= 1e-4:
                worst = max(worst, d)
                continue
            if rule == "sets" or set(want) != set(got) or any(
                    abs(10.0 ** want[e] - 10.0 ** got[e]) > 1e-4 for e in want):
                raise AssertionError(f"{what} {name}: {len(sb)} placements, oracle "
                                     f"{len(sa)}; score sets differ by {d} > 1e-4")
    if rule == "top_edge":
        if agree * 30 < 28 * n:
            raise AssertionError(f"{what}: the best edge agrees on {agree} of {n} reads")
        return agree / max(n, 1)
    return worst


def placed_rows(out) -> dict:
    """A placed collection as jplace rows: name -> [(edge, likelihood)]."""
    return {name: [(p.branch_id, p.score) for p in q.placements]
            for q in out.placed_seqs for name in out.sequence_map[q.sequence]}


@contextlib.contextmanager
def recording(module, name: str, calls: list, limit: int | None = None):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as a step module imported it), or of the first ``limit`` calls,
    while passing each call through."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        if limit is None or len(calls) < limit:
            calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)


def scatter_sums(torch, b, s, B: int):
    """The library yardstick of the segment sums: the (R, tile_width(B))
    zeros that one ``torch.scatter_add`` call fills from pre-split cells
    (branch ids ``b`` as int64, values ``s``), and that call."""
    from epik_tpu_torch.kernels.accumulate_packed import tile_width

    zeros = torch.zeros((b.shape[0], tile_width(B)), dtype=s.dtype, device=s.device)
    b = b.long()
    return lambda: torch.scatter_add(zeros, 1, b, s)


def check_sums(torch, fn, b, s, B: int, counts: bool, what: str) -> float:
    """Kernel 4's wrapper ``fn`` against its plain version on (b, s): the
    sums' bits (-0.0 included) and the counts equal, and a second launch
    gives the same bytes. Returns the largest absolute difference."""
    from epik_tpu_torch.kernels.accumulate_sums import accumulate_sums_plain

    def run():
        out = fn(b, s, B=B)
        return out if counts else (out, None)

    (S1, C1), (S2, C2) = run(), run()
    want = accumulate_sums_plain(b, s, B=B, counts=counts)
    S_p, C_p = want if counts else (want, None)
    torch.cuda.synchronize()
    if not torch.equal(S1.view(torch.int32), S_p.view(torch.int32)) or (
            counts and not torch.equal(C1, C_p)):
        raise AssertionError(f"{what}: not bit-equal to the plain version")
    if not torch.equal(S1.view(torch.int32), S2.view(torch.int32)) or (
            counts and not torch.equal(C1, C2)):
        raise AssertionError(f"{what}: two launches differ")
    return float((S1 - S_p).abs().max())


def score_cells_on(torch, dev, rng, PP: int, B: int, tile_w: int):
    """The engineered (branch, score) rows of the kernel tests, 256 reads of
    ``PP`` cells, on the card."""
    from torch_fixtures import score_rows

    b, s = score_rows(rng, 256, PP, B, edges=(tile_w,))
    return torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev)


def plain_cols_finish(Sps, m_f32, *, B: int, K: int, k: int, log_eps: float, exchange=None):
    """The column finish in torch ops alone: kernel A's plain version on each
    shard around the same merge (``exchange``: the recorded call's, None in
    one process, where every shard is at hand)."""
    from epik_tpu_torch.kernels.finish_cols import finish_cols_partial_plain
    from epik_tpu_torch.parallel.sharding import _merge_cols

    if exchange is not None:
        raise ValueError("plain_cols_finish: the shards of one process only")

    bwl = Sps[0].shape[1]
    parts = [finish_cols_partial_plain(S, m_f32, K=K, k=k, log_eps=log_eps, col0=s * bwl)
             for s, S in enumerate(Sps)]
    return _merge_cols(parts, m_f32, B=B, K=K, k=k, log_eps=log_eps)


def check_partial(np, got, want, what: str) -> float:
    """Partial packs [values | ids | n_s | max_s | e_s] (and, as a tuple with
    them, the counts form's candidate counts): all but e_s bit-equal, e_s
    within rtol 1e-6. Returns the largest absolute difference of e_s."""
    got_c = want_c = None
    if isinstance(got, tuple):
        (got, got_c), (want, want_c) = got, want
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(got[:, :-1], want[:, :-1]):
        raise AssertionError(f"{what}: the partial pack differs from the plain version")
    if got_c is not None and not np.array_equal(got_c.cpu().numpy(), want_c.cpu().numpy()):
        raise AssertionError(f"{what}: the candidates' counts differ")
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-6, atol=0.0,
                               err_msg=f"{what}: e_s")
    return float(np.abs(got[:, -1] - want[:, -1]).max(initial=0.0))


def check_cols_finish(torch, np, Sps, m_f32, kw: dict, what: str) -> dict:
    """Kernel A on a recorded column finish (the shards' sums on the one
    card): per shard, the partial pack bit-equal to its plain version but
    e_s (rtol 1e-6) and two launches alike; the whole finish against the
    plain one by check_finish. CUDA-event times of the kernel and its plain
    version on shard 0, of the whole finish and of the plain one. Returns the
    numbers, the bound's (bytes, operations) and the largest difference."""
    from epik_tpu_torch.kernels.finish_cols import finish_cols_partial, finish_cols_partial_plain
    from epik_tpu_torch.parallel.sharding import _pack_slim, finish_scores_cols_shifted

    B, K, k, log_eps = kw["B"], kw["K"], kw["k"], kw["log_eps"]
    fkw = dict(k=k, log_eps=log_eps)
    bwl = Sps[0].shape[1]
    m = m_f32.to(Sps[0].device).contiguous()
    err = 0.0
    for s, S in enumerate(Sps):
        got = finish_cols_partial(S, m, K=K, col0=s * bwl, **fkw)
        again = finish_cols_partial(S, m, K=K, col0=s * bwl, **fkw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"finish_cols_partial ({what}): two launches differ")
        err = max(err, check_partial(np, got, finish_cols_partial_plain(
            S, m, K=K, col0=s * bwl, **fkw), f"finish_cols_partial ({what}), shard {s}"))
    want_pack = _pack_slim(plain_cols_finish(Sps, m, **kw)).cpu().numpy()
    got_pack = _pack_slim(finish_scores_cols_shifted(Sps, m, **kw)).cpu().numpy()
    err_f = check_finish(np, got_pack, want_pack, K, B, f"column finish ({what})")
    S0 = Sps[0]
    R = S0.shape[0]
    Kl = min(K, bwl)
    touched = int((S0 > 0).sum())
    out = {"shape": (R, bwl), "n_shards": len(Sps), "touched_per_read": touched / R,
           "partial_err": err, "finish_err": err_f}
    out["partial_ms"] = cuda_ms(torch, lambda: finish_cols_partial(S0, m, K=K, col0=0, **fkw))
    out["partial_plain_ms"] = cuda_ms(torch, lambda: finish_cols_partial_plain(
        S0, m, K=K, col0=0, **fkw), reps=5, warmup=1)
    out["finish_ms"] = cuda_ms(torch, lambda: finish_scores_cols_shifted(Sps, m, **kw))
    out["finish_plain_ms"] = cuda_ms(torch, lambda: plain_cols_finish(Sps, m, **kw), reps=5,
                                     warmup=1)
    # the sums and m read once, the partial pack written once; a compare per
    # column and the correction and the exp-sum term per touched column
    out["io_partial"] = (R * bwl * 4 + R * 4 + R * (2 * Kl + 3) * 4,
                         R * bwl + FINISH_OPS * touched)
    log(f"column finish ({what}), {len(Sps)} shard(s) of {tuple(S0.shape)}, "
        f"{touched / R:.1f} columns touched per read on shard 0: kernel A bit-equal but e_s "
        f"(rtol 1e-6), two launches alike, the finish bit-equal but log_sum; "
        f"finish_cols_partial {out['partial_ms']:.4f} ms (plain {out['partial_plain_ms']:.4f}, "
        f"bound {bound(*out['io_partial'])[0]:.4f}); the whole finish {out['finish_ms']:.4f} "
        f"ms against {out['finish_plain_ms']:.4f} ms in torch ops")
    return out


def check_cols_kernel(torch, np, name: str, call, what: str, time_it: bool = True) -> dict:
    """A fused column kernel (``rowgather_sum_cols`` or
    ``rowgather_sum_counts_cols``) against its plain version on a recorded
    call: check_partial, two launches alike. With ``time_it``, CUDA-event
    times of the kernel, its plain version, its unfused pair and one
    ``embedding_bag`` (the sums alone), the bound's (bytes, operations) and
    the group layout's launch."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.kernels import KERNELS
    from epik_tpu_torch.kernels import rowgather as rowgather_mod

    fn, plain = KERNELS[name], getattr(rowgather_mod, name + "_plain")
    args, kw = call
    pkw = {n: v for n, v in kw.items() if n != "pair_rows"}  # the plain version's keywords
    got, again, want = fn(*args, **kw), fn(*args, **kw), plain(*args, **pkw)
    torch.cuda.synchronize()
    counts = name == "rowgather_sum_counts_cols"
    same = (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]) if counts
            else torch.equal(got, again))
    if not same:
        raise AssertionError(f"{name} ({what}): two launches differ")
    out = {"err": check_partial(np, got, want, f"{name} ({what})"),
           "shape": tuple(args[1].shape), "bw": args[0].shape[1]}
    if not time_it:
        return out
    plane, rows, m = args[:3]
    out["ms"] = cuda_ms(torch, lambda: fn(*args, **kw))
    out["plain_ms"] = cuda_ms(torch, lambda: plain(*args, **pkw), reps=3, warmup=1)
    out["pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, call, cols=True))
    rows_long = rows.long()
    out["library_ms"] = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
        rows_long, plane, mode="sum"))
    del rows_long
    # the distinct plane rows, the row ids, m and the ambiguous rows read
    # once, the partial pack (and the candidates' counts) written once; an add
    # (and a compare) per gathered cell and the finish's operations per (read,
    # column)
    R, bw = rows.shape[0], plane.shape[1]
    Kl = min(kw["K"], bw)
    written = R * (2 * Kl + 3) * 4 + (R * Kl * 4 if counts else 0)
    out["io"] = (int(torch.unique(rows).numel()) * bw * 4 + nbytes(rows, m)
                 + nbytes(*(t for t in args[3:] if t is not None)) + written,
                 (2 if counts else 1) * rows.numel() * bw + FINISH_OPS * R * bw)
    out["layout"] = group_launch(torch, plane, bw, Kl, counts, cols=True)
    log(f"{name} {out['shape']} bwl={out['bw']} ({what}): bit-equal to its plain version but "
        f"e_s (largest difference {out['err']:.3g}), two launches alike; kernel "
        f"{out['ms']:.4f} ms ({out['layout']}), the unfused pair {out['pair_ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, embedding_bag (S alone) {out['library_ms']:.4f} ms, bound "
        f"{bound(*out['io'])[0]:.4f} ms ({out['io'][0]} bytes)")
    return out


def run_placer(torch, placer, fasta: str, out: str, newick: str, batch: int):
    """``placer`` through run_pipeline with the port's FASTA reader and jplace
    writer (inflight 3), the launch counts zeroed just before and read just
    after. Returns (stats, counts, jplace rows)."""
    from epik_tpu_torch.cli.main import _open_reader
    from epik_tpu_torch.engine.pipeline import run_pipeline
    from epik_tpu_torch.io.jplace import jplace_writer
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    writer = jplace_writer(out, "chip_smoke.py", newick, resume=False)
    writer.start()
    reader = _open_reader(fasta, batch)
    reset_launch_counts()
    stats = run_pipeline(placer, reader, writer, inflight=3)
    torch.cuda.synchronize()
    counts = launch_counts()
    writer.end()
    return stats, counts, parse_jplace(out)


def d652_fixture():
    """The D652 database (BASELINE.md config 1, bench.py:56-98) and the FASTA
    records: a few IUPAC, shorter-than-k and no-hit reads, then 65,536
    150 bp reads."""
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=652, kmer_size=10, ref_length=520_000,
                                mean_posting_len=12.0, seed=652)
    reads = reads_from_reference(ref, N_READS, length=150, mutation_rate=0.02, seed=7)
    extras = [
        ("iupac_n", reads[0][1][:60] + b"N" + reads[0][1][61:]),
        ("iupac_ry", reads[1][1][:30] + b"R" + reads[1][1][31:90] + b"Y" + reads[1][1][91:]),
        ("iupac_w", b"W" + reads[2][1][1:]),
        ("short_9", reads[3][1][:9]),
        ("short_2", b"AC"),
        ("nohit", b"T" * 150),
    ]
    return db, extras + reads


def bigtree_db():
    """Config 4's database and its reference sequence (BASELINE.md config 4,
    tools/bench_bigtree.py:30,47-55)."""
    from epik_tpu_torch.io.build import reference_like_db

    return reference_like_db(num_leaves=10000, kmer_size=10, ref_length=1_000_000,
                             mean_posting_len=12.0, seed=10)


def wide_classic_db():
    """The wide classic database and its reference: BASELINE.md config 4's
    recipe (tools/bench_bigtree.py:47-55) at 11,100 leaves, B = 22,199 past
    the fused counts kernel's limit (B ~ 22,016), bw 22,272."""
    from epik_tpu_torch.io.build import reference_like_db

    return reference_like_db(num_leaves=11100, kmer_size=10, ref_length=1_000_000,
                             mean_posting_len=12.0, seed=13)


def wide_shifted_db(ref_length: int = 520_000):
    """The wide shifted database and its reference: BASELINE.md config 4's
    recipe (tools/bench_bigtree.py:47-55) at 20,000 leaves on D652's
    520,000 bp reference, seed 16: B = 39,999 (bw 40,064), past the fused
    kernel's limit (B ~ 37,000), ~410k k-mers, a 65.7 GB f32 plane."""
    from epik_tpu_torch.io.build import reference_like_db

    return reference_like_db(num_leaves=20000, kmer_size=10, ref_length=ref_length,
                             mean_posting_len=12.0, seed=16)


def bf16_scores_db(db):
    """``db`` with every score rounded to bf16 (the values the bf16 classic
    plane holds), for the oracle the bf16 path is held to."""
    import dataclasses

    import torch

    rounded = torch.from_numpy(db.scores).to(torch.bfloat16).to(torch.float32).numpy()
    return dataclasses.replace(db, scores=rounded)


def wide_classic_phase(torch, np, card: str, dev) -> tuple[list, dict]:
    """Phase 14 (see the module docstring). Returns the kernel entries of the
    gather with counts at this width and the phase's summary numbers."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.io.db import load, save
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.rowgather import counts_topk_fits
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary = {}
    # ---- 14a. fixture -----------------------------------------------------------------
    t0 = time.monotonic()
    work = os.path.join(REPO, "build", "chip_smoke_wide")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    db, ref = wide_classic_db()
    path = os.path.join(work, "wide.eptk")
    save(db, path)
    db = load(path, mu=1.0, user_omega=1.5)
    tree = parse_newick(db.tree())
    B = tree.get_node_count()
    records = reads_from_reference(ref, WC_READS, length=150, mutation_rate=0.02, seed=14)
    fasta = os.path.join(work, "q.fasta")
    write_fasta(fasta, records)
    summary["wide_fixture_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    oracles = {"f32": ReferencePlacer(db, tree).place(records[:WC_PARITY]),
               "bf16": ReferencePlacer(bf16_scores_db(db), tree).place(records[:WC_PARITY])}
    summary["wide_oracle_s"] = time.monotonic() - t0
    if counts_topk_fits(torch.empty((2, -(-B // 128) * 128), device=dev), B, 7):
        raise AssertionError(f"B = {B}: the fused counts kernel would take it")
    log(f"wide classic fixture: {db.num_kmers} k-mers, {db.num_entries} postings, {B} "
        f"branches, {WC_READS} reads of 150 bp ({summary['wide_fixture_s']:.1f} s; the "
        f"oracle on {WC_PARITY} reads, exact and bf16 scores, "
        f"{summary['wide_oracle_s']:.1f} s)")

    # ---- 14b. the classic CLI, f32 then bf16: 1c and the counts finish per batch ---------
    kernels = []
    n_batches = -(-WC_READS // WC_BATCH)
    for cell, flags in (("f32", []), ("bf16", ["--precision", "bf16"])):
        sums = "rowgather_sum_counts" + ("_bf16" if cell == "bf16" else "")
        out_dir = os.path.join(work, f"out_{cell}")
        os.makedirs(out_dir)
        argv = ["place", "-i", path, "-o", out_dir, "--batch-size", str(WC_BATCH),
                "--plane-mode", "classic", *flags, fasta]
        calls = []
        reset_launch_counts()
        with recording(step_mod, sums, calls, limit=1):
            rc, cli_out, wall = run_cli(torch, argv)
        counts = {n: c for n, c in launch_counts().items() if c}
        log("cli: python -m epik_tpu_torch " + " ".join(argv))
        for line in cli_out.splitlines():
            log("  | " + line)
        if rc != 0 or "(1 device(s), dense)" not in cli_out:
            raise AssertionError(f"wide classic {cell}: rc {rc}, not on the dense route")
        if counts != {sums: n_batches, "finish_topk_counts": n_batches}:
            raise AssertionError(f"wide classic {cell}: launches {counts}, expected {sums} "
                                 f"and finish_topk_counts once per batch ({n_batches})")
        plane = calls[0][0][0]
        rows_by_name = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
        if set(rows_by_name) != {n for n, _ in records}:
            raise AssertionError(f"wide classic {cell}: jplace names differ")
        worst = check_parity(oracles[cell], rows_by_name, f"wide classic {cell}")
        best = check_parity(oracles["f32"], rows_by_name, f"wide classic {cell}",
                            "top_edge") if cell == "bf16" else None
        rate = WC_READS / placement_ms(cli_out) * 1e3
        err, ms, plain_ms, io_k, lib_ms, shape = check_dense_kernel(
            torch, np, sums, calls[0], f"wide classic {cell}, first batch")
        summary.update({f"wide_{cell}_plane_bytes": nbytes(plane),
                        f"wide_{cell}_reads_per_s": rate, f"wide_{cell}_cli_s": wall,
                        f"wide_{cell}_{sums}_ms": ms})
        log(f"wide classic {cell}: plane {tuple(plane.shape)} {plane.dtype} = {nbytes(plane)} "
            f"bytes; {WC_READS} reads, pipeline {rate:.0f} reads/s, whole CLI {wall:.1f} s "
            f"[{card}]; launches {counts}; parity on {WC_PARITY} reads against the oracle on "
            f"{'bf16-rounded' if cell == 'bf16' else 'exact'} scores: largest score "
            f"difference {worst:.3g}"
            f"{'' if best is None else f'; the best edge of the exact oracle on {best:.3f}'}; "
            f"{sums} {shape} bw={plane.shape[1]}: bit-equal, two launches alike; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag (sums only) {lib_ms:.4f} ms, "
            f"bound {bound(*io_k)[0]:.4f} ms ({io_k[0]} bytes)")
        kernels.append(entry(f"{sums}_wide_classic", counts[sums], err, ms, plain_ms, *io_k,
                             lib_ms))
        if cell == "f32":
            single_rows = rows_by_name
        del calls, plane
        gc.collect()  # the CLI's placer, before the next plane is built
        torch.cuda.empty_cache()

    # ---- 14c. the sharded classic CLI on a 1x1 mesh: 1c and kernel A's counts form -------
    kernels.append(wide_sharded_classic(torch, np, card, path, fasta, records, oracles["f32"],
                                        single_rows, work, summary))
    shutil.rmtree(work, ignore_errors=True)
    return kernels, summary


def wide_sharded_classic(torch, np, card: str, path: str, fasta: str, records, oracle,
                         single_rows: dict, work: str, summary: dict) -> dict:
    """Phase 14's sharded run: ``place --engine sharded --plane-mode classic``
    on a 1x1 mesh over the wide classic database (one shard of 22,272
    columns, past the fused counts kernel's limit, bwl 22,064): the gather
    with counts and kernel A's counts form once per batch and nothing else;
    128 reads against the oracle, every read against the single-device
    classic run (score sets within 1e-4); kernel A against its plain version
    on the first batch's sums and counts, its time and bound. Returns kernel
    A's entry."""
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.finish_cols import (
        finish_cols_layout,
        finish_cols_partial_counts,
        finish_cols_partial_counts_plain,
    )
    from epik_tpu_torch.parallel import sharding as sh_mod
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    name = "finish_cols_partial_counts"
    n_batches = -(-WC_READS // WC_BATCH)
    out_dir = os.path.join(work, "out_sharded")
    os.makedirs(out_dir)
    argv = ["place", "-i", path, "-o", out_dir, "--batch-size", str(WC_BATCH), "--engine",
            "sharded", "--plane-mode", "classic", fasta]
    calls = []
    reset_launch_counts()
    with recording(sh_mod, name, calls, limit=1):
        rc, cli_out, wall = run_cli(torch, argv)
    counts = {n: c for n, c in launch_counts().items() if c}
    log("cli: python -m epik_tpu_torch " + " ".join(argv))
    for line in cli_out.splitlines():
        log("  | " + line)
    if rc != 0 or "sharded mesh 1x1 (dense)" not in cli_out:
        raise AssertionError(f"wide sharded classic: rc {rc}, not the sharded dense route")
    if counts != {"rowgather_sum_counts": n_batches, name: n_batches}:
        raise AssertionError(f"wide sharded classic: launches {counts}, expected "
                             f"rowgather_sum_counts and {name} once per batch ({n_batches})")
    rows_by_name = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
    names = {n for n, _ in records}
    if set(rows_by_name) != names:
        raise AssertionError("wide sharded classic: jplace names differ")
    worst = check_parity(oracle, rows_by_name, "wide sharded classic")
    worst_single = compare_rows(rows_by_name, single_rows, sorted(names),
                                "wide sharded classic against the single-device run")
    rate = WC_READS / placement_ms(cli_out) * 1e3
    (S, C, m), akw = calls[0]
    got = finish_cols_partial_counts(S, C, m, **akw)
    again = finish_cols_partial_counts(S, C, m, **akw)
    want = finish_cols_partial_counts_plain(S, C, m, **akw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError(f"{name} (wide classic shard): two launches differ")
    err = check_partial(np, got, want, f"{name} (wide classic shard)")
    R, bwl = S.shape
    Kl = min(akw["K"], bwl)
    touched = int((C > 0).sum())
    ms = cuda_ms(torch, lambda: finish_cols_partial_counts(S, C, m, **akw))
    plain_ms = cuda_ms(torch, lambda: finish_cols_partial_counts_plain(S, C, m, **akw), reps=3,
                       warmup=1)
    # S, C and m read once, the pack and the counts written once; a compare
    # per column and the finish's operations per touched column
    io = (nbytes(S, C, m) + R * (3 * Kl + 3) * 4, R * bwl + FINISH_OPS * touched)
    lay = finish_cols_layout(S, akw["K"], counts=True)
    summary.update({"wide_sharded_reads_per_s": rate, "wide_sharded_cli_s": wall,
                    f"wide_sharded_{name}_ms": ms, f"wide_sharded_{name}_plain_ms": plain_ms})
    log(f"wide sharded classic 1x1: {WC_READS} reads, pipeline {rate:.0f} reads/s, whole CLI "
        f"{wall:.1f} s [{card}]; launches {counts}; parity on {WC_PARITY} reads against the "
        f"oracle: largest score difference {worst:.3g}; every read against the single-device "
        f"classic run: {worst_single:.3g}; {name} ({R}, {bwl}), {touched / R:.1f} touched a "
        f"read, {lay['threads']} threads and a cache of {lay['cache']} scores a block: "
        f"bit-equal but e_s, two launches alike; kernel {ms:.4f} ms, plain (stable sort) "
        f"{plain_ms:.4f} ms, bound {bound(*io)[0]:.4f} ms")
    del calls, S, C, m, got, again, want
    return entry(f"{name}_wide_classic", counts[name], err, ms, plain_ms, *io, None)


def wide_shifted_phase(torch, np, card: str, dev) -> tuple[list, dict]:
    """Phase 15 (see the module docstring): the wide shifted tree, B =
    39,999 (bw 40,064), on D652's 520,000 bp reference; the reference is cut
    (480, 440, 400 kb) only where the 65.7 GB f32 plane would be over the
    card's ``device_budget`` (the summary's ``wide_shifted_ref_length``).
    8,192 150 bp reads (seed 17), the first 6 with IUPAC codes, batches of
    4,096. Returns the kernel entries of the gather alone (f32 and int16) at
    this width and the phase's summary numbers."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import device_budget
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.io.db import load, save
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.rowgather import topk_fits
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary = {}
    # ---- 15a. fixture ---------------------------------------------------------------------
    t0 = time.monotonic()
    work = os.path.join(REPO, "build", "chip_smoke_wide_shifted")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    budget = device_budget(dev)
    for ref_length in (520_000, 480_000, 440_000, 400_000):
        db, ref = wide_shifted_db(ref_length)
        B = parse_newick(db.tree()).get_node_count()
        plane_bytes = (db.num_kmers + 1) * (-(-B // 128) * 128) * 4
        if plane_bytes <= budget:
            break
    else:
        raise AssertionError(f"the wide shifted plane ({plane_bytes} bytes) is over the "
                             f"budget of {budget} bytes at every reference length")
    path = os.path.join(work, "wide_shifted.eptk")
    save(db, path)
    db = load(path, mu=1.0, user_omega=1.5)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, WS_READS, length=150, mutation_rate=0.02, seed=17)
    codes = b"NRYWSK"
    records = [(f"iupac_{chr(c)}_{i}", reads[i][1][:20 * i + 10] + bytes([c])
                + reads[i][1][20 * i + 11:]) for i, c in enumerate(codes)] + reads[len(codes):]
    fasta = os.path.join(work, "q.fasta")
    write_fasta(fasta, records)
    summary.update(wide_shifted_ref_length=ref_length, wide_shifted_plane_bytes=plane_bytes,
                   wide_shifted_budget=budget, wide_shifted_fixture_s=time.monotonic() - t0)
    t0 = time.monotonic()
    oracle = ReferencePlacer(db, tree).place(records[:WS_PARITY])
    summary["wide_shifted_oracle_s"] = time.monotonic() - t0
    if topk_fits(torch.empty((2, -(-B // 128) * 128), device=dev), B, 7):
        raise AssertionError(f"B = {B}: the fused kernel would take it")
    log(f"wide shifted fixture: {db.num_kmers} k-mers on a {ref_length} bp reference, "
        f"{db.num_entries} postings, {B} branches, f32 plane {plane_bytes} bytes of a budget "
        f"of {budget}; {WS_READS} reads of 150 bp, 6 with IUPAC codes "
        f"({summary['wide_shifted_fixture_s']:.1f} s; the oracle on {WS_PARITY} reads "
        f"{summary['wide_shifted_oracle_s']:.1f} s); topk_fits refuses B = {B}")

    # ---- 15b. the CLI with no flags, then --precision int16: 1d and finish_topk -----------
    kernels = []
    n_batches = -(-WS_READS // WS_BATCH)
    for cell, flags, rule in (("f32", [], "sets"), ("int16", ["--precision", "int16"],
                                                     "jplace_diff")):
        out_dir = os.path.join(work, f"out_{cell}")
        os.makedirs(out_dir)
        argv = ["place", "-i", path, "-o", out_dir, "--batch-size", str(WS_BATCH), *flags, fasta]
        calls = []
        reset_launch_counts()
        with recording(step_mod, "rowgather_sum", calls, limit=1):
            rc, cli_out, wall = run_cli(torch, argv)
        counts = {n: c for n, c in launch_counts().items() if c}
        log("cli: python -m epik_tpu_torch " + " ".join(argv))
        for line in cli_out.splitlines():
            log("  | " + line)
        if rc != 0 or "(1 device(s), dense)" not in cli_out:
            raise AssertionError(f"wide shifted {cell}: rc {rc}, not on the dense route")
        if counts != {"rowgather_sum": n_batches, "finish_topk": n_batches}:
            raise AssertionError(f"wide shifted {cell}: launches {counts}, expected "
                                 f"rowgather_sum and finish_topk once per batch ({n_batches})")
        plane = calls[0][0][0]
        if plane.dtype != (torch.int16 if cell == "int16" else torch.float32):
            raise AssertionError(f"wide shifted {cell}: a {plane.dtype} plane")
        rows_by_name = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
        if set(rows_by_name) != {n for n, _ in records}:
            raise AssertionError(f"wide shifted {cell}: jplace names differ")
        worst = check_parity(oracle, rows_by_name, f"wide shifted {cell}", rule)
        rate = WS_READS / placement_ms(cli_out) * 1e3
        err, ms, plain_ms, io_k, lib_ms, shape = check_dense_kernel(
            torch, np, "rowgather_sum", calls[0], f"wide shifted {cell}, first batch")
        summary.update({f"wide_shifted_{cell}_plane_bytes": nbytes(plane),
                        f"wide_shifted_{cell}_reads_per_s": rate,
                        f"wide_shifted_{cell}_cli_s": wall,
                        f"wide_shifted_{cell}_rowgather_sum_ms": ms})
        log(f"wide shifted {cell}: plane {tuple(plane.shape)} {plane.dtype} = {nbytes(plane)} "
            f"bytes; {WS_READS} reads, pipeline {rate:.0f} reads/s, whole CLI {wall:.1f} s "
            f"[{card}]; launches {counts}; parity on {WS_PARITY} reads against the oracle "
            f"({'the jplace_diff rule' if rule == 'jplace_diff' else 'score sets'}): largest "
            f"score difference {worst:.3g}; rowgather_sum {shape} bw={plane.shape[1]}: "
            f"bit-equal, two launches alike; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"embedding_bag {'none (no int16 weight)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f", bound {bound(*io_k)[0]:.4f} ms ({io_k[0]} bytes)")
        tag = "rowgather_sum" + ("_int16" if cell == "int16" else "")
        kernels.append(entry(f"{tag}_wide_shifted", counts["rowgather_sum"], err, ms, plain_ms,
                             *io_k, lib_ms))
        del calls, plane
        gc.collect()  # the CLI's placer, before the next plane is built
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return kernels, summary


def bigtree_phase(torch, np, card: str, dev, finish_err: float = 0.0) -> tuple[list, dict, dict]:
    """Phase 7 (see the module docstring). Returns the kernel entries of the
    tile and CSR kernels and of the finish (``finish_err``: its largest
    difference on earlier inputs), the phase's summary numbers and its fixture
    (the database, the reads and their FASTA, the oracle's placements), which
    phase 8 reuses."""
    from epik_tpu_torch.cli.main import _open_reader
    from epik_tpu_torch.core.tree import parse_newick, to_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.pipeline import run_pipeline
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.io.jplace import jplace_writer
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.accumulate_packed import (
        accumulate_packed_topk,
        accumulate_packed_topk_plain,
        packed_sums_plain,
    )
    from epik_tpu_torch.kernels.accumulate_sums import (
        accumulate_sums,
        accumulate_sums_counts,
        accumulate_sums_plain,
        plan,
    )
    from epik_tpu_torch.kernels.finish import (
        finish_topk,
        finish_topk_counts,
        finish_topk_counts_plain,
        finish_topk_plain,
    )
    from epik_tpu_torch.ops import csr as csr_mod
    from epik_tpu_torch.tools.jplace_diff import parse_jplace
    from torch_fixtures import counts_rows, packed_rows

    summary = {}
    # ---- 7a. fixture ------------------------------------------------------------
    t0 = time.monotonic()
    db, ref = bigtree_db()
    tree = parse_newick(db.tree())
    B = tree.get_node_count()
    summary["db_build_s"] = time.monotonic() - t0
    reads = reads_from_reference(ref, BT_READS, length=150, mutation_rate=0.02, seed=11)
    long_reads = reads_from_reference(ref, BT_LONG, length=400, mutation_rate=0.02,
                                      seed=12)
    long_reads = [(f"long_{i}", s) for i, (_, s) in enumerate(long_reads)]
    for i in range(BT_IUPAC):  # one IUPAC read in each of the first batches
        j = i * BT_BATCH + 7
        name, seq = reads[j]
        reads[j] = (f"iupac_{i}", seq[:50 + i] + b"NRYWSK"[i:i + 1] + seq[51 + i:])
    reads[BT_BATCH + 9] = ("short_9", reads[BT_BATCH + 9][1][:9])
    reads[BT_BATCH + 10] = ("short_2", b"AC")
    records = reads + long_reads
    work = os.path.join(REPO, "build", "chip_smoke_bigtree")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fasta = os.path.join(work, "q.fasta")
    write_fasta(fasta, records)
    # the IUPAC and short reads, reads of the first batch (which splits, or
    # goes to CSR whole on the sharded path), reads of the last, clean batch
    # (tiles on every path) and 400 bp reads (CSR): 256 in all
    parity_records = ([r for r in reads if not r[0].startswith("read_")]
                      + reads[:100] + reads[BT_READS - 100:]
                      + long_reads[:256 - 200 - BT_IUPAC - 2])
    log(f"big tree: {db.num_kmers} k-mers, {db.num_entries} postings, {B} branches "
        f"(db built in {summary['db_build_s']:.1f} s); {len(records)} reads "
        f"({BT_READS} x 150 bp with {BT_IUPAC} IUPAC and 2 short, {BT_LONG} x 400 bp)")

    # ---- 7b. placer: the tile and cuckoo builds -----------------------------------
    t0 = time.monotonic()
    placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device=dev)
    torch.cuda.synchronize()
    summary["tile_build_s"] = time.monotonic() - t0
    ts = placer.tiles
    if placer.route != "tiles" or not ts.packed:
        raise AssertionError(f"config 4 took route {placer.route}, packed={ts.packed}")
    t0 = time.monotonic()
    cs = placer.csr
    torch.cuda.synchronize()
    summary["cuckoo_build_s"] = time.monotonic() - t0
    log(f"tiles: main ({ts.tiles.shape[0]} x {ts.pt}) + overflow "
        f"({ts.n_ov + 1} x {ts.pt_ov}) int32, {ts.frac_over:.4f} of keys overflow, "
        f"{ts.nbytes} bytes on the card (built in {summary['tile_build_s']:.1f} s); "
        f"cuckoo table {tuple(cs.table.shape)} (built in "
        f"{summary['cuckoo_build_s']:.1f} s)")

    # ---- 7c. kernels on the inputs the path gives them ------------------------------
    clean = reads[BT_READS - BT_BATCH:]  # the last batch: no IUPAC or short reads
    packed_calls, counts_calls, sums_calls, finish_calls = [], [], [], []
    cfinish_calls = []
    with recording(step_mod, "accumulate_packed_topk", packed_calls):
        placer.place(clean)
    with recording(csr_mod, "accumulate_sums_counts", counts_calls), \
            recording(step_mod, "finish_topk_counts", cfinish_calls):
        placer.place(long_reads)
    (p, m_f32), kw = packed_calls[0]
    K = kw["K"]

    def check_packed(p, m, what: str) -> tuple[float, int]:
        """Kernel 2 against its plain version: the integer sums bit-equal and
        the pack by check_finish, two launches alike. Returns the largest
        difference, the pack and the number of touched (read, branch) sums."""
        got, sq = accumulate_packed_topk(p, m, **kw, return_sums=True)
        again, sq2 = accumulate_packed_topk(p, m, **kw, return_sums=True)
        want = accumulate_packed_topk_plain(p, m, **kw)
        torch.cuda.synchronize()
        if not torch.equal(sq.long(), packed_sums_plain(p, B)):
            raise AssertionError(f"accumulate_packed_topk ({what}): integer sums differ")
        if not (torch.equal(got, again) and torch.equal(sq, sq2)):
            raise AssertionError(f"accumulate_packed_topk ({what}): two launches differ")
        got = got.cpu().numpy()
        err = check_finish(np, got, want.cpu().numpy(), K, B, f"accumulate_packed_topk ({what})")
        return err, got, int((sq > 0).sum())

    err3, _, touched3 = check_packed(p, m_f32, "path")
    p_e, m_e = packed_rows(np.random.default_rng(4), 512, p.shape[1], B)
    p_e, m_e = torch.from_numpy(p_e).to(dev), torch.from_numpy(m_e).to(dev)
    e, got_e, _ = check_packed(p_e, m_e, "engineered")
    err3 = max(err3, e)
    n_e = got_e[:, 2 * K + 1]
    if not (n_e[0] == 0 and n_e[1] == 2 and n_e[5] == min(p.shape[1], B)
            and got_e[6, 2 * K + 2] == 1 and got_e[4, 2 * K + 2] == 1
            and np.array_equal(got_e[2, K:2 * K], np.arange(10, 10 + K))):
        raise AssertionError("accumulate_packed_topk: engineered rows (n, ties, Q1, Q3) wrong")
    del p_e, m_e
    ms3 = cuda_ms(torch, lambda: accumulate_packed_topk(p, m_f32, **kw))
    plain_ms3 = cuda_ms(torch, lambda: accumulate_packed_topk_plain(p, m_f32, **kw))
    # the cells read once, the pack written once; an add per cell and the
    # finish's operations per touched (read, branch); no one library call
    # finishes
    io3 = (nbytes(p, m_f32) + p.shape[0] * (2 * K + 3) * 4,
           p.numel() + FINISH_OPS * touched3)
    summary["packed_touched_per_read"] = touched3 / p.shape[0]
    log(f"accumulate_packed_topk {tuple(p.shape)} B={B} K={K} ({touched3 / p.shape[0]:.1f} "
        f"branches touched per read): sums and pack bit-equal but log_sum, engineered rows "
        f"(n = 0, n < K, distinct branches, ties, Q1, Q3) pass, two launches alike; kernel "
        f"{ms3:.4f} ms, plain {plain_ms3:.4f} ms, bound {bound(*io3)[0]:.4f} ms [{card}]")

    (b_c, s_c), kw_c = counts_calls[0]
    err5 = check_sums(torch, accumulate_sums_counts, b_c, s_c, B, True,
                      "accumulate_sums_counts (the 400 bp CSR batch)")
    rng = np.random.default_rng(5)
    how5 = plan(B, True)
    err5 = max(err5, check_sums(torch, accumulate_sums_counts, *score_cells_on(
        torch, dev, rng, b_c.shape[1], B, how5.tile_w), B, True,
        "accumulate_sums_counts (engineered)"))
    ms5 = cuda_ms(torch, lambda: accumulate_sums_counts(b_c, s_c, **kw_c))
    plain_ms5 = cuda_ms(torch, lambda: accumulate_sums_plain(b_c, s_c, counts=True,
                                                             **kw_c), reps=5, warmup=1)
    # the library call computes the sums only, not the counts
    lib_ms5 = cuda_ms(torch, scatter_sums(torch, b_c, s_c, B))
    S_k, C_k = accumulate_sums_counts(b_c, s_c, **kw_c)
    # only the valid cells' scores need reading: a trash cell is dropped on its branch id
    n_valid = int((b_c < B).sum())
    summary["csr_valid_cell_share"] = n_valid / b_c.numel()
    io5 = (b_c.numel() * 4 + n_valid * 4 + nbytes(S_k, C_k), 2 * n_valid)
    del S_k, C_k
    log(f"accumulate_sums_counts {tuple(b_c.shape)} B={B} (the 400 bp CSR batch, "
        f"{summary['csr_valid_cell_share']:.4f} of its cells valid): bit-equal on the "
        f"path's and engineered cells, two launches alike; {how5.n_tiles} tile(s) of "
        f"{how5.tile_w} branches, {how5.threads} threads, {how5.smem} B of shared memory "
        f"per block; kernel {ms5:.4f} ms, plain {plain_ms5:.4f} ms, scatter_add (sums "
        f"only) {lib_ms5:.4f} ms, bound {bound(*io5)[0]:.4f} ms [{card}]")

    # the counts finish on the 400 bp CSR batch's sums and counts (4,096 x 19,999)
    (S_f, C_f, m_cf), kw_cf = cfinish_calls[0]
    err2c = check_counts_finish(torch, np, S_f, C_f, m_cf, kw_cf, B, "the 400 bp CSR batch")
    S_e, C_e, m_e = (torch.from_numpy(x).to(dev) for x in counts_rows(
        np.random.default_rng(6), 512, B))
    err2c = max(err2c, check_counts_finish(torch, np, S_e, C_e, m_e, kw_cf, B, "engineered"),
                check_counts_finish(torch, np, S_e, C_e, m_e, {**kw_cf, "full": False}, B,
                                    "engineered, slim"))
    del S_e, C_e, m_e
    ms2c = cuda_ms(torch, lambda: finish_topk_counts(S_f, C_f, m_cf, **kw_cf))
    plain_ms2c = cuda_ms(torch, lambda: finish_topk_counts_plain(S_f, C_f, m_cf, **kw_cf),
                         reps=5, warmup=1)
    touched2c = int((C_f > 0).sum())
    K_c = kw_cf["K"]
    # S, C and m read once, the full body written once; a compare per branch
    # and the finish's operations per touched branch
    io2c = (nbytes(S_f, C_f, m_cf) + S_f.shape[0] * (4 * K_c + 2) * 4,
            S_f.numel() + FINISH_OPS * touched2c)
    summary["csr_touched_per_read"] = touched2c / S_f.shape[0]
    summary["finish_topk_counts_ms"] = ms2c
    summary["finish_topk_counts_plain_ms"] = plain_ms2c
    log(f"finish_topk_counts {tuple(S_f.shape)} K={K_c} (the 400 bp CSR batch, "
        f"{touched2c / S_f.shape[0]:.1f} branches touched per read): scores, ids, counts, n "
        f"and zero_sum bit-equal, wr within rtol 1e-4, engineered rows (both forms) pass, two "
        f"launches alike; kernel {ms2c:.4f} ms, plain (the torch finish_scores) "
        f"{plain_ms2c:.4f} ms, bound {bound(*io2c)[0]:.4f} ms [{card}]")
    del cfinish_calls

    # the device steps, on the clean batch and on the 400 bp batch
    seqs = list(dict.fromkeys(s for _, s in clean))
    step, OV, _ = placer._stage_tiles(seqs)
    summary["tile_step_ms"] = cuda_ms(torch, lambda: step(OV))
    csr_seqs = list(dict.fromkeys(s for _, s in long_reads))
    csr_step, P, PA, _ = placer._stage_csr(csr_seqs)
    summary["csr_step_ms"] = cuda_ms(torch, lambda: csr_step(P, PA), reps=5)
    log(f"device step, tiles (tokenize + gathers + kernel 3) at R={len(seqs)}, OV={OV}: "
        f"{summary['tile_step_ms']:.4f} ms; CSR (lookup + cells + kernel 4 with counts "
        f"+ amb + finish) at R={len(csr_seqs)} x 400 bp, P={P}: "
        f"{summary['csr_step_ms']:.4f} ms [{card}]")

    # place(): synchronous batches of the 150 bp reads (IUPAC batches split)
    batches = [reads[i:i + BT_BATCH] for i in range(0, BT_READS, BT_BATCH)]
    placer.place(batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for b in batches:
        placer.place(b)
    summary["place_reads_per_s"] = BT_READS / (time.monotonic() - t0)
    log(f"place(): {BT_READS} reads in synchronous batches of {BT_BATCH}: "
        f"{summary['place_reads_per_s']:.0f} reads/s [{card}]")

    # ---- 7d. the big-tree path through the pipeline, packed then f32 -------------------
    t0 = time.monotonic()
    oracle_out = ReferencePlacer(db, tree).place(parity_records)
    summary["oracle_s"] = time.monotonic() - t0
    newick = to_newick(tree, jplace_edges=True)
    counts = {}
    for payload in ("packed", "f32"):
        if payload == "f32":
            del placer
            torch.cuda.empty_cache()
            t0 = time.monotonic()
            placer = TorchPlacer(db, tree, config=PlacerConfig(
                dense_db="off", tile_payload="f32"), device=dev)
            torch.cuda.synchronize()
            summary["tile_build_f32_s"] = time.monotonic() - t0
            if placer.tiles.packed:
                raise AssertionError("tile_payload='f32' built packed tiles")
            placer.csr  # built before the timed pass, as for the packed one
            torch.cuda.synchronize()
            with recording(step_mod, "accumulate_sums", sums_calls), \
                    recording(step_mod, "finish_topk", finish_calls):
                placer.place(clean)
            step, OV, _ = placer._stage_tiles(seqs)
            summary["tile_step_f32_ms"] = cuda_ms(torch, lambda: step(OV))
            log(f"device step, f32 tiles (tokenize + gathers + kernel 4 + finish) at "
                f"R={len(seqs)}, OV={OV}: {summary['tile_step_f32_ms']:.4f} ms (packed "
                f"{summary['tile_step_ms']:.4f} ms) [{card}]")
            del step
        csr_steps = [0]
        stage_csr = placer._stage_csr

        def counting_stage_csr(seqs, _f=stage_csr, _n=csr_steps):
            _n[0] += 1
            return _f(seqs)

        placer._stage_csr = counting_stage_csr
        placer.overflow_retries = 0
        out = os.path.join(work, f"placements_{payload}.jplace")
        writer = jplace_writer(out, "chip_smoke.py", newick, resume=False)
        writer.start()
        reader = _open_reader(fasta, BT_BATCH)
        reset_launch_counts()
        stats = run_pipeline(placer, reader, writer, inflight=3)
        torch.cuda.synchronize()
        counts[payload] = launch_counts()
        writer.end()
        del placer._stage_csr
        need = (["accumulate_packed_topk", "accumulate_sums_counts", "finish_topk_counts"]
                if payload == "packed" else
                ["accumulate_sums", "finish_topk", "accumulate_sums_counts",
                 "finish_topk_counts"])
        missing = [name for name in need if counts[payload][name] <= 0]
        if missing:
            raise AssertionError(f"{payload} pass: kernels never launched: {missing}")
        rows_by_name = parse_jplace(out)
        if set(rows_by_name) != {name for name, _ in records}:
            raise AssertionError(f"{payload} pass: jplace names differ")
        lls = [ll for rws in rows_by_name.values() for _, ll in rws]
        if not lls or not all(math.isfinite(x) for x in lls):
            raise AssertionError(f"{payload} pass: no likelihoods or non-finite ones")
        worst = check_parity(oracle_out, rows_by_name, f"big tree {payload}")
        rate = stats.num_seq_placed / stats.wall_seconds
        summary[f"pipeline_{payload}_reads_per_s"] = rate
        summary[f"overflow_retries_{payload}"] = placer.overflow_retries
        summary[f"csr_steps_{payload}"] = csr_steps[0]
        log(f"big tree {payload}: {stats.summary()} = {rate:.0f} reads/s through the "
            f"pipeline [{card}]; launches {counts[payload]}; overflow_retries "
            f"{placer.overflow_retries}; CSR steps {csr_steps[0]} of "
            f"{stats.num_iterations} batches; parity on {len(parity_records)} reads: "
            f"largest score difference {worst:.3g} (oracle {summary['oracle_s']:.1f} s)")

    (b_s, s_s), kw_s = sums_calls[0]
    err4 = check_sums(torch, accumulate_sums, b_s, s_s, B, False,
                      "accumulate_sums (f32 payload)")
    how4 = plan(B, False)
    err4 = max(err4, check_sums(torch, accumulate_sums, *score_cells_on(
        torch, dev, rng, b_s.shape[1], B, how4.tile_w), B, False,
        "accumulate_sums (engineered)"))
    ms4 = cuda_ms(torch, lambda: accumulate_sums(b_s, s_s, **kw_s))
    plain_ms4 = cuda_ms(torch, lambda: accumulate_sums_plain(b_s, s_s, **kw_s),
                        reps=5, warmup=1)
    lib_ms4 = cuda_ms(torch, scatter_sums(torch, b_s, s_s, B))
    n_valid = int((b_s < B).sum())
    io4 = (b_s.numel() * 4 + n_valid * 4 + b_s.shape[0] * B * 4, n_valid)
    log(f"accumulate_sums {tuple(b_s.shape)} B={B} (f32 payload, {n_valid / b_s.numel():.4f} "
        f"of its cells valid): bit-equal on the path's and engineered cells, two launches "
        f"alike; {how4.n_tiles} tile(s) of {how4.tile_w} branches, {how4.threads} threads, "
        f"{how4.smem} B of shared memory per block; kernel {ms4:.4f} ms, plain "
        f"{plain_ms4:.4f} ms, scatter_add {lib_ms4:.4f} ms, bound {bound(*io4)[0]:.4f} ms "
        f"[{card}]")
    # the finish on the f32 pass's sums (4,096 x 19,999, few branches touched)
    (Sp_f, m_ff), kw_f = finish_calls[0]
    got = finish_topk(Sp_f, m_ff, **kw_f)
    again = finish_topk(Sp_f, m_ff, **kw_f)
    want = finish_topk_plain(Sp_f, m_ff, **kw_f)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("finish_topk (f32 pass): two launches differ")
    err2 = max(finish_err, check_finish(np, got.cpu().numpy(), want.cpu().numpy(),
                                        kw_f["K"], B, "finish_topk (f32 pass)"))
    ms2 = cuda_ms(torch, lambda: finish_topk(Sp_f, m_ff, **kw_f))
    plain_ms2 = cuda_ms(torch, lambda: finish_topk_plain(Sp_f, m_ff, **kw_f), reps=5,
                        warmup=1)
    touched2 = int((Sp_f > 0).sum())
    # the sums and m read once, the pack written once; a compare per branch
    # and the finish's operations per touched branch
    io2 = (nbytes(Sp_f, m_ff) + Sp_f.shape[0] * (2 * kw_f["K"] + 3) * 4,
           Sp_f.numel() + FINISH_OPS * touched2)
    summary["f32_touched_per_read"] = touched2 / Sp_f.shape[0]
    log(f"finish_topk {tuple(Sp_f.shape)} K={kw_f['K']} (the f32 pass's sums, "
        f"{touched2 / Sp_f.shape[0]:.1f} branches touched per read): bit-equal but log_sum, "
        f"two launches alike; kernel {ms2:.4f} ms, plain {plain_ms2:.4f} ms, bound "
        f"{bound(*io2)[0]:.4f} ms [{card}]")
    del placer, Sp_f, m_ff, finish_calls, got, again, want
    torch.cuda.empty_cache()

    kernels = [
        # no one library call computes the finish (correction, LWR, top-K)
        entry("finish_topk", counts["f32"]["finish_topk"], err2, ms2, plain_ms2, *io2, None),
        entry("accumulate_packed_topk", counts["packed"]["accumulate_packed_topk"],
              err3, ms3, plain_ms3, *io3, None),
        entry("accumulate_sums", counts["f32"]["accumulate_sums"], err4, ms4, plain_ms4,
              *io4, lib_ms4),
        entry("accumulate_sums_counts", counts["packed"]["accumulate_sums_counts"],
              err5, ms5, plain_ms5, *io5, lib_ms5),
        # no one library call computes the counts finish either
        entry("finish_topk_counts", counts["packed"]["finish_topk_counts"], err2c, ms2c,
              plain_ms2c, *io2c, None),
    ]
    fx = {"db": db, "tree": tree, "reads": reads, "records": records, "fasta": fasta,
          "work": work, "newick": newick, "parity_records": parity_records,
          "oracle_out": oracle_out}
    return kernels, summary, fx


def compare_rows(rows, want_rows, names, what: str) -> float:
    """Two jplace files' rows for ``names``: score sets within 1e-4. Returns
    the largest score difference."""
    worst = 0.0
    for name in names:
        got = sorted(ll for _, ll in rows[name])
        want = sorted(ll for _, ll in want_rows[name])
        if len(got) != len(want):
            raise AssertionError(f"{what} {name}: {len(got)} placements, want {len(want)}")
        d = max((abs(a - b) for a, b in zip(got, want)), default=0.0)
        if d > 1e-4:
            raise AssertionError(f"{what} {name}: score sets differ by {d} > 1e-4")
        worst = max(worst, d)
    return worst


def sharded_phase(torch, np, card: str, dev, fx: dict) -> tuple[list, dict]:
    """Phase 8 (see the module docstring), on phase 7's fixture. Returns the
    kernel entry of kernel 3's sums and the phase's summary numbers."""
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.kernels.accumulate_packed import accumulate_packed_sums, packed_sums_plain
    from epik_tpu_torch.parallel import sharding as sharding_mod
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
    from torch_fixtures import packed_cells

    db, tree, reads, records = fx["db"], fx["tree"], fx["reads"], fx["records"]
    B = tree.get_node_count()
    summary = {}

    def run(placer, fasta: str, name: str):
        return run_placer(torch, placer, fasta, os.path.join(fx["work"], name), fx["newick"],
                          BT_BATCH)

    # ---- 8a. the placer on a 1x1 mesh: column tiles and hash-sharded tables -------
    t0 = time.monotonic()
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                config=PlacerConfig(dense_db="off"))
    torch.cuda.synchronize()
    summary["sharded_build_s"] = time.monotonic() - t0
    if placer.route != "tiles" or placer._tile_scale <= 0.0:
        raise AssertionError(f"sharded config 4 took route {placer.route}, "
                             f"scale {placer._tile_scale}")
    log(f"sharded 1x1: shard width {placer._bwl}, tiles PT {placer._tile_pt} + overflow "
        f"PT {placer._tile_pt_ov} over {placer._tile_n_ov} keys (built in "
        f"{summary['sharded_build_s']:.1f} s)")

    # ---- 8b. kernel 3's sums on the inputs the path gives them --------------------------
    clean = reads[BT_READS - BT_BATCH:]  # the last batch: no IUPAC or short reads
    sums_calls, finish_calls = [], []
    with recording(sharding_mod, "accumulate_packed_sums", sums_calls), \
            recording(sharding_mod, "finish_scores_cols_shifted", finish_calls):
        placer.place(clean)
    (p,), kw = sums_calls[0]
    bwl = kw["B"]
    got = accumulate_packed_sums(p, B=bwl)
    want = packed_sums_plain(p, bwl).to(torch.float32)
    scatter = scatter_sums(torch, p >> 16, (p & 0xFFFF).to(torch.float32), bwl)
    lib = scatter()[:, :bwl]
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("accumulate_packed_sums: not bit-equal to the plain version")
    if not torch.equal(lib, want):
        raise AssertionError("accumulate_packed_sums: the library scatter-add disagrees")
    err = float((got - want).abs().max())
    p_e, _ = packed_cells(np.random.default_rng(8), 512, p.shape[1], bwl)
    p_e = torch.from_numpy(p_e).to(dev)
    got_e = accumulate_packed_sums(p_e, B=bwl)
    want_e = packed_sums_plain(p_e, bwl).to(torch.float32)
    torch.cuda.synchronize()
    if not torch.equal(got_e, want_e) or int(got_e[3, 5]) < 64 * 64000:
        raise AssertionError("accumulate_packed_sums: engineered rows differ")
    err = max(err, float((got_e - want_e).abs().max()))
    ms = cuda_ms(torch, lambda: accumulate_packed_sums(p, B=bwl))
    plain_ms = cuda_ms(torch, lambda: packed_sums_plain(p, bwl).to(torch.float32))
    lib_ms = cuda_ms(torch, scatter)
    io = (nbytes(p, got), p.numel())  # the cells in, the sums out; an add per cell
    del got, want, lib, scatter, p_e, got_e, want_e
    (Sps, m_f32), kw_f = finish_calls[0]
    fin = check_cols_finish(torch, np, Sps, m_f32, kw_f, "sharded tiles 1x1")
    summary.update(column_finish_ms=fin["finish_ms"], column_finish_plain_ms=fin["finish_plain_ms"],
                   finish_cols_partial_ms=fin["partial_ms"])
    seqs = list(dict.fromkeys(s for _, s in clean))
    _, OV, rerun = placer._place_async_tiles({s: ["x"] for s in seqs}, seqs).budget
    summary["sharded_tile_step_ms"] = cuda_ms(torch, lambda: rerun(OV))
    log(f"accumulate_packed_sums {tuple(p.shape)} B={bwl}: bit-equal on the path's and "
        f"engineered cells; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_add "
        f"{lib_ms:.4f} ms, bound {bound(*io)[0]:.4f} ms; column finish over {bwl} columns: "
        f"kernels {summary['column_finish_ms']:.4f} ms, torch ops (stable sort) "
        f"{summary['column_finish_plain_ms']:.4f} ms; sharded device step (tokenize + "
        f"gathers + kernel 3 + column finish) at R={len(seqs)}, OV={OV}: "
        f"{summary['sharded_tile_step_ms']:.4f} ms [{card}]")
    del Sps, m_f32, finish_calls, sums_calls

    # ---- 8c. the sharded path through the pipeline ----------------------------------------
    csr_steps = [0]
    place_csr = placer._place_async_csr

    def counting_csr(*args, _f=place_csr):
        csr_steps[0] += 1
        return _f(*args)

    placer._place_async_csr = counting_csr
    placer.overflow_retries = 0
    tile_steps = []
    with recording(sharding_mod, "sharded_tiles_bytes_step", tile_steps):
        stats, counts, rows = run(placer, fx["fasta"], "placements_sharded.jplace")
    missing = [n for n in ("accumulate_packed_sums", "accumulate_sums_counts",
                           "finish_topk_counts", "finish_cols_partial") if counts[n] <= 0]
    if missing:
        raise AssertionError(f"sharded pass: kernels never launched: {missing}")
    # kernel A once per shard and tile step (overflow retries rerun a step)
    if counts["finish_cols_partial"] < len(tile_steps):
        raise AssertionError(f"sharded pass: {counts['finish_cols_partial']} launches of "
                             f"kernel A for {len(tile_steps)} tile steps")
    if set(rows) != {name for name, _ in records}:
        raise AssertionError("sharded pass: jplace names differ")
    lls = [ll for rws in rows.values() for _, ll in rws]
    if not lls or not all(math.isfinite(x) for x in lls):
        raise AssertionError("sharded pass: no likelihoods or non-finite ones")
    worst = check_parity(fx["oracle_out"], rows, "sharded 1x1")
    rate = stats.num_seq_placed / stats.wall_seconds
    summary.update(sharded_pipeline_reads_per_s=rate,
                   sharded_overflow_retries=placer.overflow_retries,
                   sharded_csr_steps=csr_steps[0])
    log(f"sharded 1x1: {stats.summary()} = {rate:.0f} reads/s through the pipeline "
        f"[{card}]; launches {counts}; overflow_retries {placer.overflow_retries}; CSR "
        f"steps {csr_steps[0]} of {stats.num_iterations} batches; parity on "
        f"{len(fx['parity_records'])} reads: largest score difference {worst:.3g}")
    del placer
    torch.cuda.empty_cache()

    # ---- 8d. a 1x4 mesh on the one card against the 1x1 mesh -------------------------------
    # the last clean 150 bp reads (tile batches), then the IUPAC and short
    # reads (a batch on the hash-sharded CSR)
    sub = reads[BT_READS - SH_READS:] + [r for r in reads if not r[0].startswith("read_")]
    sub_fasta = os.path.join(fx["work"], "sub.fasta")
    write_fasta(sub_fasta, sub)
    t0 = time.monotonic()
    placer4 = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=4,
                                                     devices=[dev] * 4),
                                 config=PlacerConfig(dense_db="off"))
    torch.cuda.synchronize()
    build4_s = time.monotonic() - t0
    if placer4.route != "tiles" or placer4._bwl != -(-B // 512) * 128:
        raise AssertionError(f"1x4: route {placer4.route}, shard width {placer4._bwl}")
    stats4, counts4, rows4 = run(placer4, sub_fasta, "placements_sharded_1x4.jplace")
    if (counts4["accumulate_packed_sums"] <= 0 or counts4["finish_cols_partial"] <= 0
            or counts4["finish_cols_partial"] % 4):
        raise AssertionError(f"1x4: launches {counts4}")
    worst4 = compare_rows(rows4, rows, [name for name, _ in sub], "1x4 vs 1x1")
    summary["sharded_1x4_reads_per_s"] = stats4.num_seq_placed / stats4.wall_seconds
    log(f"sharded 1x4 on one card (shard width {placer4._bwl}, built in {build4_s:.1f} s): "
        f"{stats4.summary()}; launches {counts4}; {len(sub)} reads within "
        f"{worst4:.3g} of the 1x1 jplace [{card}]")
    del placer4
    torch.cuda.empty_cache()
    kernels = [entry("accumulate_packed_sums", counts["accumulate_packed_sums"], err, ms,
                     plain_ms, *io, lib_ms),
               # kernel A's main path: one launch per shard of every tile step;
               # no one library call computes the column finish
               entry("finish_cols_partial", counts["finish_cols_partial"], fin["partial_err"],
                     fin["partial_ms"], fin["partial_plain_ms"], *fin["io_partial"], None)]
    summary.update(finish_cols_partial_err=fin["partial_err"],
                   column_finish_err=fin["finish_err"], sharded_tile_steps=len(tile_steps))
    return kernels, summary


#: phase 9's D652 configs: name, CLI flags (None: the library, with these
#: PlacerConfig fields), and the kernel its dense step ends in
DENSE_CONFIGS = [
    ("pair_off", ["--pair-plane", "off"], None, "rowgather_sum_topk"),
    ("classic", ["--plane-mode", "classic"], None, "rowgather_sum_counts_topk"),
    ("int16", ["--precision", "int16"], None, "rowgather_sum_topk_int16"),
    ("bf16", ["--precision", "bf16"], None, "rowgather_sum_counts_topk_bf16"),
    ("lookup_device", None, {"lookup_where": "device"}, "rowgather_sum_counts_topk"),
    ("tokenize_host", None, {"tokenize_where": "host"}, "rowgather_sum_topk"),
]
#: the kernels a single-device dense step runs only past its fused kernel's limit
APART = ("rowgather_sum", "finish_topk", "rowgather_sum_counts", "rowgather_sum_counts_bf16",
         "finish_topk_counts")


def check_dense_kernel(torch, np, name: str, call, what: str):
    """The dense kernel ``name`` against its plain version on a recorded call
    of a path: bit-equal (the fused finish: check_finish; the fused counts
    finish: check_full_pack), two launches alike; CUDA-event times of both
    and, for the sums with counts (fused or not), of one ``embedding_bag``
    (the sums alone). Returns (err, ms, plain_ms, io, library_ms, shape)."""
    from epik_tpu_torch.kernels import KERNELS
    from epik_tpu_torch.kernels.rowgather import (
        rowgather_sum_counts_plain,
        rowgather_sum_counts_topk_plain,
        rowgather_sum_plain,
        rowgather_sum_topk_plain,
    )

    fn = KERNELS[name]
    args, kw = call
    pkw = {n: v for n, v in kw.items() if n != "pair_rows"}  # the plain versions' keywords
    plane, rows = args[0], args[1]
    bw = plane.shape[1]
    cell = plane.element_size()
    n_distinct = int(torch.unique(rows).numel())
    lib_ms = None  # embedding_bag takes no int16 weight
    if plane.dtype != torch.int16:
        rows_long = rows.long()
        lib_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(rows_long, plane,
                                                                          mode="sum"))
        del rows_long
    if name.startswith("rowgather_sum_topk"):
        m, amb_read, delta = args[2:5]
        K, B = kw["K"], kw["B"]
        got, again = fn(*args, **kw), fn(*args, **kw)
        want = rowgather_sum_topk_plain(*args, **pkw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({what}): two launches differ")
        err = check_finish(np, got.cpu().numpy(), want.cpu().numpy(), K, B, f"{name} ({what})")
        ms = cuda_ms(torch, lambda: fn(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: rowgather_sum_topk_plain(*args, **pkw), reps=3,
                           warmup=1)
        amb = nbytes(amb_read, delta) if amb_read is not None else 0
        io = (n_distinct * bw * cell + nbytes(rows, m) + amb + rows.shape[0] * (2 * K + 3) * 4,
              rows.numel() * bw + FINISH_OPS * rows.shape[0] * B)
        return err, ms, plain_ms, io, lib_ms, tuple(rows.shape)
    if name.startswith("rowgather_sum_counts_topk"):
        m, amb_read, dS, hit = args[2:6]
        K, B = kw["K"], kw["B"]
        got, again = fn(*args, **kw), fn(*args, **kw)
        want = rowgather_sum_counts_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({what}): two launches differ")
        err = check_full_pack(np, got.cpu().numpy(), want.cpu().numpy(), K, B,
                              f"{name} ({what})")
        ms = cuda_ms(torch, lambda: fn(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: rowgather_sum_counts_topk_plain(*args, **kw), reps=3,
                           warmup=1)
        amb = nbytes(amb_read, dS, hit) if amb_read is not None else 0
        # the distinct rows, the row ids, m and the first hits read once, the
        # full body written once (S and C stay on chip); an add and a compare
        # per gathered cell and the finish's operations per (read, branch)
        io = (n_distinct * bw * cell + nbytes(rows, m) + amb + rows.shape[0] * (4 * K + 2) * 4,
              2 * rows.numel() * bw + FINISH_OPS * rows.shape[0] * B)
        return err, ms, plain_ms, io, lib_ms, tuple(rows.shape)
    if name == "rowgather_sum":  # the gather alone, f32 or int16 with its scale
        scale = kw.get("scale")
        S, S2 = fn(plane, rows, scale=scale), fn(plane, rows, scale=scale)
        S_p = rowgather_sum_plain(plane, rows, scale)
        torch.cuda.synchronize()
        if not torch.equal(S.view(torch.int32), S_p.view(torch.int32)):
            raise AssertionError(f"{name} ({what}): not bit-equal to the plain version")
        if not torch.equal(S.view(torch.int32), S2.view(torch.int32)):
            raise AssertionError(f"{name} ({what}): two launches differ")
        err = float((S - S_p).abs().max())
        ms = cuda_ms(torch, lambda: fn(plane, rows, scale=scale))
        plain_ms = cuda_ms(torch, lambda: rowgather_sum_plain(plane, rows, scale), reps=3,
                           warmup=1)
        # the distinct rows read once, the row ids read and the sums written
        # once; an add per gathered cell
        io = (n_distinct * bw * cell + nbytes(rows, S), rows.numel() * bw)
        return err, ms, plain_ms, io, lib_ms, tuple(rows.shape)
    (S, C), (S2, C2) = fn(plane, rows), fn(plane, rows)
    S_p, C_p = rowgather_sum_counts_plain(plane, rows)
    torch.cuda.synchronize()
    if not (torch.equal(S.view(torch.int32), S_p.view(torch.int32)) and torch.equal(C, C_p)):
        raise AssertionError(f"{name} ({what}): not bit-equal to the plain version")
    if not (torch.equal(S.view(torch.int32), S2.view(torch.int32)) and torch.equal(C, C2)):
        raise AssertionError(f"{name} ({what}): two launches differ")
    err = float((S - S_p).abs().max())
    ms = cuda_ms(torch, lambda: fn(plane, rows))
    plain_ms = cuda_ms(torch, lambda: rowgather_sum_counts_plain(plane, rows), reps=3,
                       warmup=1)
    # the distinct rows read once, the row ids, S and C written once; an add
    # and a compare per gathered cell
    io = (n_distinct * bw * cell + nbytes(rows, S, C), 2 * rows.numel() * bw)
    return err, ms, plain_ms, io, lib_ms, tuple(rows.shape)


def tokenizer_check(torch, card: str, placer, seqs, dev) -> dict:
    """The slot tokenizer's kernel (``tokenize_combo_fused``) against the torch
    ops it replaces (``tokenize_combo`` + ``_m_f32``, its plain version) on
    ``seqs`` and on their first ``CELL_BATCH``: rows, lengths and the bits of
    m_f32 equal, two launches alike; CUDA-event times of both (the torch ops'
    include the card's waits between their ~60 launches). Returns, per batch
    (suffix "" and "_cell"), ms, plain_ms and the bytes the kernel must move:
    the packed rows read once, one combo cell a distinct slot row (a lower
    bound of the distinct cells read) and the outputs written once."""
    from epik_tpu_torch.engine.step import _m_f32
    from epik_tpu_torch.kernels.tokenize import tokenize_combo_fused
    from epik_tpu_torch.ops.tokenize import tokenize_combo

    st, k = placer.state, placer.k
    out = {}
    for tag, batch in (("", seqs), ("_cell", seqs[:CELL_BATCH])):
        buf, _, _, Lmax, _ = placer._stage_bytes(batch)
        buf_t = torch.from_numpy(buf).to(dev)
        got = tokenize_combo_fused(buf_t, st.combo, k=k, Lmax=Lmax)
        again = tokenize_combo_fused(buf_t, st.combo, k=k, Lmax=Lmax)
        rows, lens = tokenize_combo(buf_t, st.combo, k=k, Lmax=Lmax)
        want = (rows, lens, _m_f32(lens, k))
        torch.cuda.synchronize()
        for name, a, b, c in zip(("rows", "lens", "m_f32"), got, again, want):
            if a.dtype == torch.float32:
                a, b, c = (x.view(torch.int32) for x in (a, b, c))
            if not torch.equal(a, c):
                raise AssertionError(f"tokenize_combo_fused ({len(batch)} reads): {name} "
                                     f"differ from the plain version")
            if not torch.equal(a, b):
                raise AssertionError(f"tokenize_combo_fused ({len(batch)} reads): two "
                                     f"launches differ")
        ms = cuda_ms(torch, lambda: tokenize_combo_fused(buf_t, st.combo, k=k, Lmax=Lmax))
        plain_ms = cuda_ms(torch, lambda: _m_f32(
            tokenize_combo(buf_t, st.combo, k=k, Lmax=Lmax)[1], k))
        io = (nbytes(buf_t, *got) + 4 * int(torch.unique(rows).numel()), 0)
        out.update({f"ms{tag}": ms, f"plain_ms{tag}": plain_ms, f"io{tag}": io})
        log(f"tokenize_combo_fused {tuple(buf.shape)} -> rows {tuple(rows.shape)}, Lmax "
            f"{Lmax}: bit-equal to the torch ops (rows, lens, the bits of m_f32), two "
            f"launches alike; kernel {ms:.4f} ms, torch ops {plain_ms:.4f} ms, bound "
            f"{bound(*io)[0]:.5f} ms ({io[0]} bytes) [{card}]")
    return out


def unfused_pair(kernels_mod, call, cols: bool):
    """What a recorded call of a fused kernel computes, by the kernels apart
    (a function of no arguments). The counts form (the call's arguments
    (plane, rows, m, amb_read, dS, hit)): the sums with counts (1c), the
    first hits added, then ``finish_topk_counts`` into the full body
    (``cols``: kernel A's counts form). The shifted form ((plane, rows, m,
    amb_read, delta), as :func:`fused_call` gives it): the gather alone (1d,
    in the call's read order), the delta rows added, then ``finish_topk``
    (``cols``: kernel A)."""
    from epik_tpu_torch.kernels.rowgather import add_first_hits

    args, kw = call
    fkw = {n: kw[n] for n in ("K", "k", "log_eps", "col0") if n in kw}
    if len(args) == 5:
        plane, rows, m, amb_read, delta = args
        gkw = {n: kw[n] for n in ("scale", "pair_rows") if n in kw}
        B = kw.get("B", plane.shape[1])

        def shifted():
            Sp = kernels_mod.rowgather_sum(plane, rows, **gkw)
            if amb_read is not None and amb_read.numel() > 0:
                Sp[amb_read, :B] = Sp[amb_read, :B] + delta
            if cols:
                return kernels_mod.finish_cols_partial(Sp, m, **fkw)
            return kernels_mod.finish_topk(Sp[:, :B], m, **fkw)
        return shifted
    plane, rows, m, amb_read, dS, hit = args
    sums = (kernels_mod.rowgather_sum_counts_bf16 if plane.element_size() == 2
            else kernels_mod.rowgather_sum_counts)
    if cols:
        return lambda: kernels_mod.finish_cols_partial_counts(
            *add_first_hits(*sums(plane, rows), amb_read, dS, hit), m, **fkw)
    B = kw["B"]

    def run():
        S, C = sums(plane, rows)
        return kernels_mod.finish_topk_counts(
            *add_first_hits(S[:, :B], C[:, :B], amb_read, dS, hit), m, **fkw)
    return run


def fused_call(torch, call):
    """A recorded call of ``engine.step._shifted_finish`` (plane, rows, m,
    arows, step keywords) as a call of the fused kernel it routes between:
    ((plane, rows, m, amb_read, delta), keywords of ``rowgather_sum_topk``,
    or over an int16 plane of ``rowgather_sum_topk_int16`` with its scale,
    with the step's read order)."""
    from epik_tpu_torch.ops.dense import amb_deltas

    (plane, rows, m, arows), kw = call
    scale = kw.get("plane_scale", 1.0)
    amb_read = delta = None
    if kw["Amax"] > 0:
        amb_read, delta = amb_deltas(plane, arows, zero_row=kw["zero_row"], B=kw["B"],
                                     k=kw["k"], eps=kw["eps"], log_eps=kw["log_eps"],
                                     plane_scale=scale)
    fkw = {n: kw[n] for n in ("B", "K", "k", "log_eps")}
    fkw["pair_rows"] = kw.get("pair_rows", False)
    if plane.dtype == torch.int16:
        fkw["scale"] = scale
    return (plane, rows, m, amb_read, delta), fkw


def run_cli(torch, argv):
    """``python -m epik_tpu_torch`` in process: (rc, its output, seconds)."""
    from epik_tpu_torch.cli.main import main as cli_main

    stdout = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(stdout):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, stdout.getvalue(), time.monotonic() - t0


def placement_ms(cli_out: str) -> int:
    return int(cli_out.split("Placement time:")[1].split("(")[1].split(" ms")[0])


def wide_tree_checks(torch, np, card: str, dev) -> tuple[dict, dict]:
    """The kernels at the widths of the big trees, against their plain
    versions: the fused kernel at B = 30,000 (inside its limit); at B =
    40,000, past it, the wrapper refusing and the dense step running
    rowgather_sum + finish_topk (the launches counted); finish_topk at B =
    70,000, its ids in the global workspace; the fused counts kernel (f32
    and bf16) at the widest B its shared memory takes and one branch past
    it, where the classic step runs the sums with counts + finish_topk_counts
    (the launches counted); finish_topk_counts at B = 65,537 in both forms.
    Returns each kernel's largest difference and the launches of the
    steps past the limits."""
    from epik_tpu_torch.engine.step import _classic_finish, _shifted_finish
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_counts, finish_topk_plain
    from epik_tpu_torch.kernels.rowgather import (
        counts_topk_fits,
        counts_topk_smem,
        rowgather_sum_counts_topk,
        rowgather_sum_counts_topk_plain,
        rowgather_sum_topk,
        rowgather_sum_topk_plain,
        topk_fits,
        topk_smem,
    )
    from epik_tpu_torch.ops.dense import amb_classic_deltas, amb_deltas
    from torch_fixtures import counts_rows, finish_rows

    rng = np.random.default_rng(30)
    kw = dict(K=7, k=10, log_eps=-4.2597)
    errs, launches = {}, {}
    for B, n_rows, R, W in ((30000, 300, 256, 72), (40000, 200, 128, 72)):
        bw = -(-B // 128) * 128
        plane = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
        plane[rng.random(plane.shape) > 0.3] = 0.0
        plane[:, B:] = 0.0
        plane[-1] = 0.0
        rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
        rows[0] = n_rows - 1
        arows = np.full((R, 2), n_rows - 1, np.int32)
        arows[1::5, 0] = rng.integers(0, n_rows - 1, len(range(1, R, 5)))
        m = rng.integers(W, W + 40, R).astype(np.float32)
        plane, rows, arows, m = (torch.from_numpy(x).to(dev) for x in (plane, rows, arows, m))
        amb_read, delta = amb_deltas(plane, arows, zero_row=n_rows - 1, B=B, k=10, eps=5.5e-5,
                                     log_eps=-4.2597)
        want = rowgather_sum_topk_plain(plane, rows, m, amb_read, delta, B=B, **kw)
        need, limit = topk_smem(plane, B, 7)
        reset_launch_counts()
        if topk_fits(plane, B, 7):
            got = rowgather_sum_topk(plane, rows, m, amb_read, delta, B=B, **kw)
            name = "rowgather_sum_topk"
        else:
            try:
                rowgather_sum_topk(plane, rows, m, amb_read, delta, B=B, **kw)
            except ValueError:
                pass
            else:
                raise AssertionError(f"rowgather_sum_topk launched at B={B}, past its limit")
            got = _shifted_finish(plane, rows, m, arows, B=B, Amax=2, zero_row=n_rows - 1,
                                  eps=5.5e-5, **kw)
            name = "rowgather_sum"
        counts = launch_counts()
        torch.cuda.synchronize()
        expect = ({"rowgather_sum_topk": 1} if name == "rowgather_sum_topk"
                  else {"rowgather_sum": 1, "finish_topk": 1})
        if {n: c for n, c in counts.items() if c} != expect:
            raise AssertionError(f"B={B}: launches {counts}, expected {expect}")
        if name == "rowgather_sum":
            for n, c in expect.items():
                launches[n] = launches.get(n, 0) + c
        e = check_finish(np, got.cpu().numpy(), want.cpu().numpy(), 7, B,
                         f"B={B} ({'fused' if name == 'rowgather_sum_topk' else 'apart'})")
        errs[name] = max(errs.get(name, 0.0), e)
        log(f"wide tree B={B}, bw={bw}: the fused kernel asks {need} B of shared memory of "
            f"{limit} [{card}]; {'fused' if need <= limit else 'rowgather_sum + finish_topk'} "
            f"bit-equal to the fused plain version but log_sum; launches "
            f"{ {n: c for n, c in counts.items() if c} }")
    Sp, m = finish_rows(rng, 300, 70000, density=0.05)
    Sp, m = torch.from_numpy(Sp).to(dev), torch.from_numpy(m).to(dev)
    got, again = finish_topk(Sp, m, **kw), finish_topk(Sp, m, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("finish_topk at B=70,000: two launches differ")
    got = got.cpu().numpy()
    errs["finish_topk"] = check_finish(np, got, finish_topk_plain(Sp, m, **kw).cpu().numpy(),
                                       7, 70000, "finish_topk at B=70,000")
    if not np.array_equal(got[2, 7:14], np.arange(10, 17)):
        raise AssertionError("finish_topk at B=70,000: ties did not go to the lowest index")
    ms = cuda_ms(torch, lambda: finish_topk(Sp, m, **kw), reps=5)
    log(f"finish_topk (300, 70000) K=7, ids in the global workspace: bit-equal but log_sum, "
        f"two launches alike, ties to the lowest index; {ms:.4f} ms [{card}]")
    del Sp, m

    # the fused counts kernel at its limit and one branch past it
    def need_limit(B):
        return counts_topk_smem(torch.empty((2, -(-B // 128) * 128), device=dev), B, 7)

    lo, hi = 1024, 1 << 16  # the widest B whose need is within the limit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        need, limit = need_limit(mid)
        lo, hi = (mid, hi) if need <= limit else (lo, mid - 1)
    for cell in ("f32", "bf16"):
        for B in (lo, lo + 1):
            bw = -(-B // 128) * 128
            plane = rng.uniform(-7.0, -0.01, (120, bw)).astype(np.float32)
            plane[rng.random(plane.shape) > 0.3] = 0.0
            plane[:, B:] = 0.0
            plane[-1] = 0.0
            rows = rng.integers(0, 120, (64, 72)).astype(np.int32)
            rows[0] = 119
            arows = np.full((64, 2), 119, np.int32)
            arows[1::5, 0] = rng.integers(0, 119, len(range(1, 64, 5)))
            m = rng.integers(72, 112, 64).astype(np.float32)
            m[2] = 1.0  # counts above m wrap (quirk Q1)
            plane, rows, arows, m = (torch.from_numpy(x).to(dev)
                                     for x in (plane, rows, arows, m))
            if cell == "bf16":
                plane = plane.to(torch.bfloat16)
            read, dS, hit = amb_classic_deltas(plane, arows, zero_row=119, B=B, k=10,
                                               eps=5.5e-5)
            want = rowgather_sum_counts_topk_plain(plane, rows, m, read, dS, hit, B=B, **kw)
            fits = counts_topk_fits(plane, B, 7)
            if fits != (B == lo):
                raise AssertionError(f"counts_topk_fits at B={B}: {fits}")
            fused = "rowgather_sum_counts_topk" + ("_bf16" if cell == "bf16" else "")
            sums = "rowgather_sum_counts" + ("_bf16" if cell == "bf16" else "")
            if not fits and cell == "f32":
                try:
                    rowgather_sum_counts_topk(plane, rows, m, read, dS, hit, B=B, **kw)
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"{fused} launched at B={B}, past its limit")
            reset_launch_counts()
            got = _classic_finish(plane, rows, m, arows, B=B, Amax=2, zero_row=119,
                                  eps=5.5e-5, **kw)
            counts = {n: c for n, c in launch_counts().items() if c}
            torch.cuda.synchronize()
            expect = {fused: 1} if fits else {sums: 1, "finish_topk_counts": 1}
            if counts != expect:
                raise AssertionError(f"classic {cell} B={B}: launches {counts}, expected "
                                     f"{expect}")
            for n, c in counts.items():
                launches[n] = launches.get(n, 0) + c
            if got[-1].any():
                raise AssertionError(f"classic {cell} B={B}: the totals row is not zero")
            e = check_full_pack(np, got[:-1].cpu().numpy(), want.cpu().numpy(), 7, B,
                                f"classic {cell} B={B} ({'fused' if fits else 'apart'})")
            for n in counts:
                errs[n] = max(errs.get(n, 0.0), e)
            need, limit = need_limit(B)
            log(f"wide tree classic {cell} B={B}, bw={bw}: the fused counts kernel asks "
                f"{need} B of shared memory of {limit} [{card}]; "
                f"{'fused' if fits else sums + ' + finish_topk_counts'} bit-equal to the fused "
                f"plain version but wr; launches {counts}")
    S, C, m = (torch.from_numpy(x).to(dev) for x in counts_rows(rng, 300, 65537, density=0.05))
    for full in (True, False):
        e = check_counts_finish(torch, np, S, C, m, {**kw, "full": full}, 65537,
                                f"B = 65,537, {'full' if full else 'slim'}")
        errs["finish_topk_counts"] = max(errs.get("finish_topk_counts", 0.0), e)
    ms = cuda_ms(torch, lambda: finish_topk_counts(S, C, m, **kw), reps=5)
    log(f"finish_topk_counts (300, 65537) K=7, ids in the global workspace, full and slim: "
        f"bit-equal but wr / log_sum, two launches alike; {ms:.4f} ms [{card}]")
    return errs, launches


def dense_phase(torch, np, card: str, dev, fx: dict, d652: dict) -> tuple[list, dict, dict]:
    """Phase 9 (see the module docstring). Returns the kernel entries of the
    new variants, the phase's summary numbers and each older kernel's largest
    difference at the wide-tree widths."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.cli.main import _open_reader
    from epik_tpu_torch.core.tree import parse_newick, to_newick
    from epik_tpu_torch.engine import placer as placer_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.pipeline import run_pipeline
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.db import load, save
    from epik_tpu_torch.io.jplace import jplace_writer
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.rowgather import shifted_fused
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary = {}
    # ---- 9a. config 4 through the CLI, no flags: the unpaired dense route -------------
    c4_path = os.path.join(fx["work"], "config4.eptk")
    t0 = time.monotonic()
    save(fx["db"], c4_path)
    c4 = load(c4_path, mu=1.0, user_omega=1.5)
    summary["config4_save_load_s"] = time.monotonic() - t0
    same_db = all(np.array_equal(getattr(c4, a), getattr(fx["db"], a))
                  for a in ("keys", "row_off", "branches", "scores")) and c4.omega == fx["db"].omega
    oracle_c4 = fx["oracle_out"] if same_db else ReferencePlacer(
        c4, parse_newick(c4.tree())).place(fx["parity_records"])
    fx.update(c4_path=c4_path, oracle_c4=oracle_c4)  # phase 10 places the same file
    out_dir = os.path.join(fx["work"], "dense_cli")
    os.makedirs(out_dir)
    argv = ["place", "-i", c4_path, "-o", out_dir, "--batch-size", str(BT_BATCH), fx["fasta"]]
    step_calls, route_calls = [], []
    reset_launch_counts()
    with recording(placer_mod, "place_batch_dense_bytes", step_calls), \
            recording(step_mod, "_shifted_finish", route_calls, limit=1):
        rc, cli_out, cli_s = run_cli(torch, argv)
    counts = launch_counts()
    log("cli: python -m epik_tpu_torch " + " ".join(argv))
    for line in cli_out.splitlines():
        log("  | " + line)
    if rc != 0 or "(1 device(s), dense)" not in cli_out:
        raise AssertionError(f"config 4 CLI: rc {rc}, not on the dense route")
    # the width rule sends config 4's width to the unfused pair, up front
    c4_call = fused_call(torch, route_calls[0])
    c4_plane, c4_B = c4_call[0][0], c4_call[1]["B"]
    if shifted_fused(c4_plane.shape[1]):
        raise AssertionError(f"config 4: the width rule takes bw {c4_plane.shape[1]} to the "
                             f"fused kernel; this phase holds the unfused pair's route")
    route = ("rowgather_sum", "finish_topk")
    if any(counts[n] <= 0 for n in route) or counts["rowgather_sum_topk"]:
        raise AssertionError(f"config 4 CLI: launches {counts}, the route {route}")
    rows_by_name = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
    if set(rows_by_name) != {name for name, _ in fx["records"]}:
        raise AssertionError("config 4 CLI: jplace names differ")
    worst = check_parity(oracle_c4, rows_by_name, "config 4 dense")
    pl_ms = placement_ms(cli_out)
    n_reads = len(fx["records"])
    summary.update(config4_cli_s=cli_s, config4_dense_pipeline_reads_per_s=n_reads / pl_ms * 1e3,
                   config4_fused_launches=counts["rowgather_sum_topk"], config4_route=route,
                   config4_route_launches=[counts[n] for n in route])
    (plane, direct, buf, arows), kw_s = step_calls[0][0][:4], step_calls[0][1]
    log(f"config 4 dense (unpaired shifted plane {tuple(plane.shape)} f32 = "
        f"{plane.numel() * 4} bytes, {len(step_calls)} steps): {n_reads} reads, pipeline "
        f"{pl_ms} ms = {n_reads / pl_ms * 1e3:.0f} reads/s, whole CLI {cli_s:.1f} s [{card}]; "
        f"launches {counts}; parity on {len(fx['parity_records'])} reads (IUPAC, short, "
        f"400 bp): largest score difference {worst:.3g}")
    # the fused kernel on the first batch's rows whichever route the step took,
    # and its unfused pair on the same rows
    err_c4, ms_c4, plain_c4, io_c4, lib_c4, shape_c4 = check_dense_kernel(
        torch, np, "rowgather_sum_topk", c4_call, "config 4, first batch")
    pair_c4 = cuda_ms(torch, unfused_pair(kernels_mod, c4_call, cols=False))
    layout_c4 = group_launch(torch, c4_plane, c4_B, c4_call[1]["K"], counts=False, cols=False)
    summary.update(config4_fused_ms=ms_c4, config4_fused_plain_ms=plain_c4,
                   config4_fused_bound_ms=bound(*io_c4)[0], config4_embedding_bag_ms=lib_c4,
                   config4_unfused_pair_ms=pair_c4)
    step_ms = cuda_ms(torch, lambda: step_mod.place_batch_dense_bytes(
        plane, direct, buf, arows, **kw_s), reps=5)
    summary["config4_dense_step_ms"] = step_ms
    log(f"rowgather_sum_topk {shape_c4} bw={plane.shape[1]} B={kw_s['B']} (config 4, unpaired): "
        f"bit-equal but log_sum, two launches alike; kernel {ms_c4:.4f} ms ({layout_c4}), the "
        f"unfused pair on the same rows (rowgather_sum in locality order, the delta add, "
        f"finish_topk) {pair_c4:.4f} ms, plain {plain_c4:.4f} ms, embedding_bag (sums only) "
        f"{lib_c4:.4f} ms, bound {bound(*io_c4)[0]:.4f} ms ({io_c4[0]} bytes); the route "
        f"{route}; device step (tokenize + amb delta rows + the route) at R={buf.shape[0]}: "
        f"{step_ms:.4f} ms [{card}]")
    # the route's gather, on the same rows, with #1's time beside it
    g_err, g_ms, g_plain, g_io, g_lib, _ = check_dense_kernel(
        torch, np, "rowgather_sum", ((c4_plane, c4_call[0][1]), {}),
        "config 4, first batch, the unfused pair's gather")
    c4_entry = entry("rowgather_sum_config4", counts["rowgather_sum"], g_err, g_ms, g_plain,
                     *g_io, g_lib, fused="rowgather_sum_topk", fused_ms=ms_c4,
                     fused_max_abs_err=err_c4, fused_bound_ms=bound(*io_c4)[0],
                     pair_ms=pair_c4, route=list(route), **layout_c4)
    log(f"rowgather_sum {shape_c4} (config 4, the route's gather): {g_ms:.4f} ms, bound "
        f"{bound(*g_io)[0]:.4f} ms [{card}]")
    del plane, direct, buf, arows, step_calls, route_calls, c4_call, c4_plane
    torch.cuda.empty_cache()

    # ---- 9b. D652 under the six configs ---------------------------------------------------
    db = d652["db"]
    tree = parse_newick(db.tree())
    newick = to_newick(tree, jplace_edges=True)
    oracle_out = d652["oracle_out"]
    kernels, seen, apart = [], set(), {}
    for name, flags, fields, kernel in DENSE_CONFIGS:
        calls = []
        out_dir = os.path.join(d652["work"], f"out_{name}")
        os.makedirs(out_dir)
        jplace = os.path.join(out_dir, "placements_q.fasta.jplace")
        reset_launch_counts()
        with recording(step_mod, kernel, calls):
            if flags is not None:
                argv = ["place", "-i", d652["db_path"], "-o", out_dir, "--batch-size",
                        str(BATCH), *flags, d652["fasta"]]
                rc, cli_out, wall = run_cli(torch, argv)
                if rc != 0 or "(1 device(s), dense)" not in cli_out:
                    raise AssertionError(f"D652 {name}: rc {rc}\n{cli_out}")
                rate = len(d652["records"]) / placement_ms(cli_out) * 1e3
                how = "CLI " + " ".join(flags)
            else:
                placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
                writer = jplace_writer(jplace, "chip_smoke.py", newick, resume=False)
                writer.start()
                stats = run_pipeline(placer, _open_reader(d652["fasta"], BATCH), writer,
                                     inflight=3)
                torch.cuda.synchronize()
                writer.end()
                rate = stats.num_seq_placed / stats.wall_seconds
                how = f"run_pipeline, PlacerConfig({fields})"
                del placer
        counts = launch_counts()
        if counts[kernel] <= 0 or any(counts[n] for n in APART):
            raise AssertionError(f"D652 {name}: launches {counts}")
        rows_by_name = parse_jplace(jplace)
        if set(rows_by_name) != {n for n, _ in d652["records"]}:
            raise AssertionError(f"D652 {name}: jplace names differ")
        rule = {"int16": "jplace_diff", "bf16": "top_edge"}.get(name, "sets")
        worst = check_parity(oracle_out, rows_by_name, f"D652 {name}", rule)
        err, ms, plain_ms, io_k, lib_ms, shape = check_dense_kernel(
            torch, np, kernel, calls[0], f"D652 {name}")
        (pargs, pkw) = calls[0]
        extra = group_launch(torch, pargs[0], pkw["B"], pkw["K"], counts="counts" in kernel,
                             cols=False)
        if kernel.startswith("rowgather_sum_topk"):  # the unfused pair on the same rows
            extra["pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, calls[0], cols=False))
            summary[f"d652_{name}_unfused_pair_ms"] = extra["pair_ms"]
            log(f"{kernel} (D652 {name}): {ms:.4f} ms ({extra}); the unfused pair on the same "
                f"rows (rowgather_sum, the delta add, finish_topk) {extra['pair_ms']:.4f} ms "
                f"[{card}]")
        if kernel.startswith("rowgather_sum_counts_topk") and name != "lookup_device":
            # the sums with counts alone run past the fused kernel's limit:
            # held against their plain version on the rows the path gave
            sums = kernel.replace("_topk", "")
            apart[sums] = check_dense_kernel(torch, np, sums, (calls[0][0][:2], {}),
                                             f"D652 {name}, the recorded rows")
            summary[f"d652_{name}_{sums}_ms"] = apart[sums][1]
            log(f"{sums} {apart[sums][5]} (D652 {name}'s rows): bit-equal, two launches "
                f"alike; kernel {apart[sums][1]:.4f} ms, plain {apart[sums][2]:.4f} ms, "
                f"embedding_bag (sums only) {apart[sums][4]:.4f} ms, bound "
                f"{bound(*apart[sums][3])[0]:.4f} ms [{card}]")
            # the same rows without their first hits, and the unfused pair
            # (1c, the first hits added, finish_topk_counts) beside the kernel
            no_amb = check_dense_kernel(torch, np, kernel, ((*pargs[:3], None, None, None), pkw),
                                        f"D652 {name}, no first hits")
            err = max(err, no_amb[0])
            pair_ms = extra["pair_ms"] = cuda_ms(torch, unfused_pair(kernels_mod, calls[0],
                                                                      cols=False))
            summary[f"d652_{name}_unfused_pair_ms"] = pair_ms
            log(f"{kernel} (D652 {name}): {ms:.4f} ms with the first hits, {no_amb[1]:.4f} ms "
                f"without (bit-equal to its plain version but wr); the unfused pair on the "
                f"same rows ({sums} + add_first_hits + finish_topk_counts) {pair_ms:.4f} ms "
                f"[{card}]")
        del calls
        torch.cuda.empty_cache()
        summary[f"d652_{name}_reads_per_s"] = rate
        summary[f"d652_{name}_kernel_ms"] = ms
        log(f"D652 {name} ({how}): {rate:.0f} reads/s through the pipeline [{card}]; "
            f"launches { {n: c for n, c in counts.items() if c} }; parity on "
            f"{PARITY_READS} reads by {rule}: "
            f"{'best edge agrees on a share of ' if rule == 'top_edge' else 'largest score difference '}"
            f"{worst:.4g}; {kernel} {shape}: bit-equal to its plain version"
            f"{' but log_sum' if 'topk' in kernel and 'counts' not in kernel else ''}"
            f"{' but wr (rtol 1e-4)' if 'counts_topk' in kernel else ''}, two launches "
            f"alike; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{'embedding_bag (sums only) ' + format(lib_ms, '.4f') + ' ms, ' if lib_ms else ''}"
            f"bound {bound(*io_k)[0]:.4f} ms")
        if kernel not in seen and kernel != "rowgather_sum_topk":
            seen.add(kernel)
            kernels.append(entry(kernel, counts[kernel], err, ms, plain_ms, *io_k, lib_ms,
                                 **extra))

    # ---- 9c. a batch of short reads and a read of 65,536 bp (the host tokenizer) ----------
    placer = TorchPlacer(db, tree, device=dev)
    seq0 = d652["records"][10][1]
    short = [("short_3", b"ACG"), ("empty", b""), ("short_9", seq0[:9])]
    long = [("long_65536", (seq0 * 500)[:65536]), ("r1", d652["records"][11][1])]
    t0 = time.monotonic()
    oracle = ReferencePlacer(db, tree).place(short + long)
    summary["oracle_long_s"] = time.monotonic() - t0
    reset_launch_counts()
    got_s, got_l = placer.place(short), placer.place(long)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["rowgather_sum_topk"] != 2:
        raise AssertionError(f"short/long batches: launches {counts}")

    worst = check_parity(oracle, {**placed_rows(got_s), **placed_rows(got_l)},
                         "short reads and a 65,536 bp read", "jplace_diff")
    log(f"a batch of 3 reads shorter than k and a batch with a 65,536 bp read: the host "
        f"tokenizer and the fused kernel (launches {counts['rowgather_sum_topk']}); jplace_diff "
        f"rule against the oracle, largest matched score difference {worst:.3g} (oracle "
        f"{summary['oracle_long_s']:.1f} s)")
    del placer
    torch.cuda.empty_cache()

    # ---- 9d. the kernels at the widths of bigger trees -----------------------------------------
    errs, wide_launches = wide_tree_checks(torch, np, card, dev)
    summary["wide_rowgather_sum_launches"] = wide_launches.get("rowgather_sum", 0)
    # the sums with counts apart: their launches on the classic step past the
    # fused kernel's limit (9d; the f32 one also on a sharded classic shard
    # past rowgather_sum_counts_cols's limit, phase 10), their times on D652's
    # rows
    for sums, (err, ms, plain_ms, io_k, lib_ms, _) in apart.items():
        kernels.append(entry(sums, wide_launches[sums], err, ms, plain_ms, *io_k, lib_ms))
    kernels.append(c4_entry)
    return kernels, summary, errs


def cols_limit_checks(torch, np, card: str, dev) -> tuple[dict, dict]:
    """Both fused column kernels at the widest shard their shared memory
    takes (a multiple of 4 columns) and one group of four past it, through
    the sharded step's routing (``_shifted_cols`` / ``_classic_cols``): at the
    limit the fused kernel, past it the wrapper refusing and the gather, the
    adds and kernel A apart, each against the fused plain version; kernel A
    in both forms at bwl = 70,016 (ids in the global workspace). Returns each
    kernel's largest difference and the launches of the routes past the
    limits."""
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.finish_cols import (
        finish_cols_partial,
        finish_cols_partial_counts,
        finish_cols_partial_counts_plain,
        finish_cols_partial_plain,
    )
    from epik_tpu_torch.kernels.rowgather import (
        cols_fits,
        cols_smem,
        counts_cols_fits,
        rowgather_sum_cols,
        rowgather_sum_cols_plain,
        rowgather_sum_counts_cols_plain,
        shifted_fused,
    )
    from epik_tpu_torch.parallel.sharding import _classic_cols, _shifted_cols
    from torch_fixtures import counts_rows, finish_rows

    rng = np.random.default_rng(31)
    kw = dict(K=7, k=10, log_eps=-4.2597)
    errs, launches = {}, {}
    for counts in (False, True):
        lo, hi = 256, 1 << 16
        while lo < hi:
            mid = (lo + hi + 4) // 8 * 4
            need, limit = cols_smem(torch.empty((2, mid), device=dev), 7, counts)
            lo, hi = (mid, hi) if need <= limit else (lo, mid - 4)
        for bw in (lo, lo + 4):
            cells = (rng.uniform(-7.0, -0.01, (120, bw)) if counts
                     else rng.uniform(0.0, 8.0, (120, bw))).astype(np.float32)
            cells[rng.random(cells.shape) > 0.3] = 0.0
            cells[:, bw - 5:] = 0.0
            cells[-1] = 0.0
            rows = rng.integers(0, 120, (64, 72)).astype(np.int32)
            rows[0] = 119
            m = rng.integers(72, 112, 64).astype(np.float32)
            m[2] = 1.0  # classic: counts above m wrap (quirk Q1)
            reads = np.arange(1, 64, 5)
            hit = rng.random((reads.size, bw)) < 0.2
            hit[:, bw - 5:] = False
            delta = np.where(hit, rng.uniform(-2.0, 6.0, hit.shape), 0.0).astype(np.float32)
            plane, rows, m, reads, delta, hit = (torch.from_numpy(x).to(dev) for x in (
                cells, rows, m, reads, delta, hit))
            fits = (counts_cols_fits if counts else cols_fits)(plane, 7)
            if fits != (bw == lo):
                raise AssertionError(f"cols fits at bwl={bw} (counts {counts}): {fits}")
            ckw = dict(kw, col0=bw)
            if not counts and fits:  # the fused kernel at its limit, whatever the route
                want = rowgather_sum_cols_plain(plane, rows, m, reads, delta, **ckw)
                e = check_partial(np, rowgather_sum_cols(plane, rows, m, reads, delta, **ckw),
                                  want, f"rowgather_sum_cols at bwl={bw}")
                errs["rowgather_sum_cols"] = max(errs.get("rowgather_sum_cols", 0.0), e)
            reset_launch_counts()
            if counts:
                got = _classic_cols(plane, rows, m, reads, delta, hit, **ckw)
                want = rowgather_sum_counts_cols_plain(plane, rows, m, reads, delta, hit, **ckw)
                expect = ({"rowgather_sum_counts_cols": 1} if fits else
                          {"rowgather_sum_counts": 1, "finish_cols_partial_counts": 1})
            else:
                got = _shifted_cols(plane, rows, m, reads, delta, **ckw)
                want = rowgather_sum_cols_plain(plane, rows, m, reads, delta, **ckw)
                fits = fits and shifted_fused(bw, cols=True)  # the route the rule gives
                expect = ({"rowgather_sum_cols": 1} if fits else
                          {"rowgather_sum": 1, "finish_cols_partial": 1})
            got_counts = {n: c for n, c in launch_counts().items() if c}
            torch.cuda.synchronize()
            if got_counts != expect:
                raise AssertionError(f"bwl={bw} (counts {counts}): launches {got_counts}, "
                                     f"expected {expect}")
            e = check_partial(np, got, want, f"bwl={bw}, counts {counts}")
            for n, c in got_counts.items():
                errs[n] = max(errs.get(n, 0.0), e)
                if not fits:
                    launches[n] = launches.get(n, 0) + c
            need, limit = cols_smem(plane, 7, counts)
            log(f"sharded shard bwl={bw} ({'classic' if counts else 'shifted'}): the fused "
                f"column kernel asks {need} B of shared memory of {limit} [{card}]; "
                f"launches {got_counts}: bit-equal to the fused plain version but e_s")
    for counts in (False, True):
        if counts:
            S, C, m = (torch.from_numpy(x).to(dev) for x in counts_rows(rng, 300, 70016,
                                                                        density=0.05))
            got = finish_cols_partial_counts(S, C, m, col0=0, **kw)
            want = finish_cols_partial_counts_plain(S, C, m, col0=0, **kw)
            name = "finish_cols_partial_counts"
        else:
            S, m = (torch.from_numpy(x).to(dev) for x in finish_rows(rng, 300, 70016,
                                                                     density=0.05))
            got = finish_cols_partial(S, m, col0=0, **kw)
            want = finish_cols_partial_plain(S, m, col0=0, **kw)
            name = "finish_cols_partial"
        errs[name] = max(errs.get(name, 0.0), check_partial(np, got, want,
                                                            f"{name} at bwl = 70,016"))
    log(f"kernel A at bwl = 70,016 (ids in the global workspace), both forms: bit-equal "
        f"but e_s [{card}]")
    return errs, launches


def sharded_dense_phase(torch, np, card: str, dev, fx: dict, d652: dict) -> tuple[list, dict]:
    """Phase 10 (see the module docstring). Returns the kernel entries of the
    fused column kernels and of kernel A's counts form (the D652 CLI runs'
    launches and shapes; the largest difference over every check of the
    phase), the phase's summary and the launches of the gathers apart past
    the fused kernels' limits."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick, to_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.finish_cols import (
        finish_cols_partial_counts,
        finish_cols_partial_counts_plain,
    )
    from epik_tpu_torch.kernels.rowgather import (
        add_first_hits,
        cols_fits,
        rowgather_sum_counts,
        shifted_fused,
    )
    from epik_tpu_torch.parallel import sharding as sharding_mod
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary, checks = {}, {}
    db = d652["db"]
    tree = parse_newick(db.tree())
    newick = to_newick(tree, jplace_edges=True)
    names = [n for n, _ in d652["records"]]
    kinds = ("rowgather_sum", "rowgather_sum_counts", "finish_cols_partial",
             "finish_cols_partial_counts", "rowgather_sum_topk", "rowgather_sum_counts_topk",
             "rowgather_sum_cols", "rowgather_sum_counts_cols")

    def check_counts(counts, what, route=("rowgather_sum_cols",)):
        """The route's kernels launched (the fused column kernel, or where
        the width rule routes the shard past it the gather and kernel A),
        nothing else of the dense kernels."""
        if any(counts[n] <= 0 for n in route) or any(counts[n] for n in kinds if n not in route):
            raise AssertionError(f"{what}: launches {counts}, the route {route}")

    def sharded_cli(db_path, fasta, out_dir, batch, what, step_name):
        """``--engine sharded`` in process: (rows, counts, reads/s, the first
        recorded step call and the first shard's call at its router, as
        ((plane, rows, m, amb_read, delta), keywords) of the fused column
        kernel, the route)."""
        os.makedirs(out_dir)
        argv = ["place", "-i", db_path, "-o", out_dir, "--batch-size", str(batch), "--engine",
                "sharded", fasta]
        steps, fused = [], []
        reset_launch_counts()
        with recording(sharding_mod, step_name, steps, limit=1), \
                recording(sharding_mod, "_shifted_cols", fused, limit=1):
            rc, cli_out, _ = run_cli(torch, argv)
        counts = launch_counts()
        log("cli: python -m epik_tpu_torch " + " ".join(argv))
        for line in cli_out.splitlines():
            log("  | " + line)
        if rc != 0 or "sharded mesh 1x1 (dense)" not in cli_out or not steps:
            raise AssertionError(f"{what}: rc {rc}, not the sharded dense route through "
                                 f"{step_name}")
        plane = fused[0][0][0]
        route = (("rowgather_sum_cols",)
                 if shifted_fused(plane.shape[1], cols=True) and cols_fits(plane, 7)
                 else ("rowgather_sum", "finish_cols_partial"))
        check_counts(counts, what, route)
        rows = parse_jplace(os.path.join(out_dir, "placements_" + os.path.basename(fasta)
                                         + ".jplace"))
        return rows, counts, placement_ms(cli_out), steps[0], fused[0], route

    # ---- 10a. D652 through the CLI, --engine sharded: a 1x1 mesh, the pair plane ------
    rows1, counts1, pl_ms, (s_args, s_kw), f_call, route1 = sharded_cli(
        d652["db_path"], d652["fasta"], os.path.join(d652["work"], "out_sharded_1x1"), BATCH,
        "D652 sharded 1x1", "sharded_dense_paired_step")
    if set(rows1) != set(names):
        raise AssertionError("D652 sharded 1x1: jplace names differ")
    # phase 13's two ranks (1x1 shards each) must equal it, on the same route
    d652.update(sharded_rows=rows1, sharded_route=route1)
    worst = check_parity(d652["oracle_out"], rows1, "D652 sharded 1x1")
    summary["d652_sharded_cli_reads_per_s"] = len(names) / pl_ms * 1e3
    planes = s_args[0]
    summary["d652_sharded_step_ms"] = cuda_ms(
        torch, lambda: sharding_mod.sharded_dense_paired_step(*s_args, **s_kw), reps=5)
    log(f"D652 sharded 1x1 (pair plane {tuple(planes[0].shape)} f32 in one shard): "
        f"{len(names)} reads, pipeline {pl_ms} ms = "
        f"{summary['d652_sharded_cli_reads_per_s']:.0f} reads/s [{card}]; launches "
        f"{ {n: c for n, c in counts1.items() if c} }; parity on {PARITY_READS} reads: largest "
        f"score difference {worst:.3g}; sharded dense step (tokenize + amb delta rows + "
        f"{' + '.join(route1)} + merge) at R={s_args[2].shape[0]}: "
        f"{summary['d652_sharded_step_ms']:.4f} ms")
    summary["d652_sharded_route"] = route1
    # the fused column kernel on the shard's rows whichever route it took
    checks["d652_1x1"] = check_cols_kernel(torch, np, "rowgather_sum_cols", f_call,
                                           "D652 sharded 1x1")
    del planes, s_args, f_call
    torch.cuda.empty_cache()

    # ---- 10b. D652 on a 1x4 mesh laid on the card ----------------------------------------
    t0 = time.monotonic()
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=4, devices=[dev] * 4))
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    if (placer.route != "dense" or not placer._paired
            or placer._bwl != -(-tree.get_node_count() // 512) * 128):
        raise AssertionError(f"D652 1x4: route {placer.route}, paired {placer._paired}, "
                             f"shard width {placer._bwl}")
    if not shifted_fused(placer._bwl, cols=True):  # 1e's main path
        raise AssertionError(f"D652 1x4: the width rule sends shards of {placer._bwl} columns "
                             f"to the unfused pair; no path here launches rowgather_sum_cols")
    calls4 = []
    with recording(sharding_mod, "_shifted_cols", calls4, limit=4):
        stats4, counts4, rows4 = run_placer(
            torch, placer, d652["fasta"], os.path.join(d652["work"], "sharded_1x4.jplace"),
            newick, BATCH)
    check_counts(counts4, "D652 sharded 1x4")
    if counts4["rowgather_sum_cols"] % 4:
        raise AssertionError(f"D652 sharded 1x4: launches {counts4}")
    worst4 = compare_rows(rows4, rows1, names, "D652 1x4 vs 1x1")
    summary["d652_sharded_1x4_reads_per_s"] = stats4.num_seq_placed / stats4.wall_seconds
    log(f"D652 sharded 1x4 on one card (4 shards of {placer._bwl} columns, "
        f"{sum(p.numel() * 4 for p in placer._planes[0])} bytes of planes, built in "
        f"{build_s:.1f} s): {stats4.summary()}; launches "
        f"{ {n: c for n, c in counts4.items() if c} }; {len(names)} reads within "
        f"{worst4:.3g} of the 1x1 jplace [{card}]")
    checks["d652_1x4"] = check_cols_kernel(torch, np, "rowgather_sum_cols", calls4[0],
                                           "D652 sharded 1x4, shard 0")
    for s, call in enumerate(calls4[1:], 1):
        e = check_cols_kernel(torch, np, "rowgather_sum_cols", call,
                              f"D652 sharded 1x4, shard {s}", time_it=False)
        checks["d652_1x4"]["err"] = max(checks["d652_1x4"]["err"], e["err"])
    del placer, calls4
    torch.cuda.empty_cache()

    # ---- 10c. D652 on the classic plane, 1x1, through the library ----------------------------
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                config=PlacerConfig(plane_mode="classic"))
    if placer.route != "dense" or placer._shifted:
        raise AssertionError(f"D652 classic: route {placer.route}, shifted {placer._shifted}")
    calls_c, steps_c = [], []
    with recording(sharding_mod, "rowgather_sum_counts_cols", calls_c, limit=1), \
            recording(sharding_mod, "sharded_dense_bytes_step", steps_c, limit=1):
        stats_c, counts_c, rows_c = run_placer(
            torch, placer, d652["fasta"], os.path.join(d652["work"], "sharded_classic.jplace"),
            newick, BATCH)
    check_counts(counts_c, "D652 sharded classic", route=("rowgather_sum_counts_cols",))
    worst_c = check_parity(d652["oracle_out"], rows_c, "D652 sharded classic")
    summary["d652_sharded_classic_reads_per_s"] = stats_c.num_seq_placed / stats_c.wall_seconds
    (sc_args, sc_kw) = steps_c[0]
    summary["d652_sharded_classic_step_ms"] = cuda_ms(
        torch, lambda: sharding_mod.sharded_dense_bytes_step(*sc_args, **sc_kw), reps=5)
    log(f"D652 sharded classic 1x1 (run_pipeline): {stats_c.summary()} [{card}]; launches "
        f"{ {n: c for n, c in counts_c.items() if c} }; parity on {PARITY_READS} reads: "
        f"largest score difference {worst_c:.3g}; sharded classic step (tokenize + first hit "
        f"+ rowgather_sum_counts_cols + merge) at R={sc_args[2].shape[0]}: "
        f"{summary['d652_sharded_classic_step_ms']:.4f} ms")
    checks["d652_classic"] = check_cols_kernel(torch, np, "rowgather_sum_counts_cols",
                                               calls_c[0], "D652 sharded classic 1x1")
    pair_ms = cuda_ms(torch, unfused_pair(kernels_mod, calls_c[0], cols=True))
    summary["d652_sharded_classic_unfused_pair_ms"] = pair_ms
    log(f"rowgather_sum_counts_cols (D652 sharded classic 1x1): "
        f"{checks['d652_classic']['ms']:.4f} ms; the unfused pair on the same rows "
        f"(rowgather_sum_counts + add_first_hits + finish_cols_partial_counts) {pair_ms:.4f} ms "
        f"[{card}]")
    # kernel A's counts form on the same shard's sums and counts (what the
    # shard runs past the fused kernel's limit)
    (plane_c, rows_cl, m_c, read_c, dS_c, hit_c), ckw = calls_c[0]
    S_c, C_c = add_first_hits(*rowgather_sum_counts(plane_c, rows_cl), read_c, dS_c, hit_c)
    akw = dict(K=ckw["K"], k=ckw["k"], log_eps=ckw["log_eps"], col0=ckw["col0"])
    got = finish_cols_partial_counts(S_c, C_c, m_c, **akw)
    again = finish_cols_partial_counts(S_c, C_c, m_c, **akw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        raise AssertionError("finish_cols_partial_counts (D652 classic): two launches differ")
    err_a = check_partial(np, got, finish_cols_partial_counts_plain(S_c, C_c, m_c, **akw),
                          "finish_cols_partial_counts (D652 classic)")
    R_c, bw_c = S_c.shape
    Kl = min(akw["K"], bw_c)
    touched = int((C_c > 0).sum())
    ka = {"err": err_a, "shape": (R_c, bw_c),
          "ms": cuda_ms(torch, lambda: finish_cols_partial_counts(S_c, C_c, m_c, **akw)),
          "plain_ms": cuda_ms(torch, lambda: finish_cols_partial_counts_plain(
              S_c, C_c, m_c, **akw), reps=5, warmup=1),
          # S, C and m read once, the pack and the counts written once; a
          # compare per column and the finish's operations per touched column
          "io": (nbytes(S_c, C_c, m_c) + R_c * (3 * Kl + 3) * 4,
                 R_c * bw_c + FINISH_OPS * touched)}
    log(f"finish_cols_partial_counts {ka['shape']} (D652 classic's sums and counts, "
        f"{touched / R_c:.1f} touched per read): bit-equal but e_s, two launches alike; "
        f"kernel {ka['ms']:.4f} ms, plain (stable sort) {ka['plain_ms']:.4f} ms, bound "
        f"{bound(*ka['io'])[0]:.4f} ms [{card}]")
    del placer, calls_c, steps_c, sc_args, S_c, C_c, got, again
    torch.cuda.empty_cache()

    # ---- 10d. config 4 through --engine sharded: the unpaired 51.8 GB column plane -----------
    reads = fx["reads"]
    long_reads = fx["records"][BT_READS:]
    sub = ([r for r in reads if not r[0].startswith("read_")] + reads[:100]
           + reads[BT_READS - C4_SHARDED_READS:] + long_reads)
    sub_fasta = os.path.join(fx["work"], "c4_sharded.fasta")
    write_fasta(sub_fasta, sub)
    t0 = time.monotonic()
    rows_4, counts_4, pl_ms4, (s_args, s_kw), f_call, route_4 = sharded_cli(
        fx["c4_path"], sub_fasta, os.path.join(fx["work"], "out_sharded_c4"), BT_BATCH,
        "config 4 sharded", "sharded_dense_bytes_step")
    summary["config4_sharded_cli_s"] = time.monotonic() - t0
    if route_4 != ("rowgather_sum", "finish_cols_partial"):  # the width rule's, up front
        raise AssertionError(f"config 4 sharded: the route {route_4}, not the unfused pair")
    if set(rows_4) != {n for n, _ in sub}:
        raise AssertionError("config 4 sharded: jplace names differ")
    worst_4 = check_parity(fx["oracle_c4"], rows_4, "config 4 sharded dense")
    summary["config4_sharded_cli_reads_per_s"] = len(sub) / pl_ms4 * 1e3
    summary["config4_sharded_step_ms"] = cuda_ms(
        torch, lambda: sharding_mod.sharded_dense_bytes_step(*s_args, **s_kw), reps=3)
    plane_c4 = s_args[0][0]
    log(f"config 4 sharded dense (unpaired column plane {tuple(plane_c4.shape)} f32 = "
        f"{plane_c4.numel() * 4} bytes): {len(sub)} reads, pipeline {pl_ms4} ms = "
        f"{summary['config4_sharded_cli_reads_per_s']:.0f} reads/s, whole CLI "
        f"{summary['config4_sharded_cli_s']:.1f} s [{card}]; launches "
        f"{ {n: c for n, c in counts_4.items() if c} }; parity on "
        f"{len(fx['parity_records'])} reads: largest score difference {worst_4:.3g}; sharded "
        f"dense step at R={s_args[2].shape[0]}: {summary['config4_sharded_step_ms']:.4f} ms")
    # the fused column kernel on the shard's rows whichever route it took
    checks["config4"] = check_cols_kernel(torch, np, "rowgather_sum_cols", f_call,
                                          "config 4 sharded 1x1")
    summary["config4_sharded_route"] = route_4
    c4_call = f_call
    del s_args, f_call, plane_c4
    torch.cuda.empty_cache()

    # ---- 10e. the fused kernels at and past their limits; kernel A past 2^16 -----------------
    errs, past = cols_limit_checks(torch, np, card, dev)

    for name, c in checks.items():
        summary.update({f"{name}_cols_{key}": c[key]
                        for key in ("ms", "plain_ms", "library_ms", "pair_ms")})
        summary[f"{name}_cols_bound_ms"] = bound(*c["io"])[0]
    summary.update(finish_cols_partial_counts_d652_ms=ka["ms"],
                   finish_cols_partial_counts_d652_plain_ms=ka["plain_ms"])
    # 1e's main path is D652's 1x4 mesh (the 1x1 shard takes the pair: a tie)
    main_s, main_c = checks["d652_1x4"], checks["d652_classic"]
    at_1x1 = checks["d652_1x1"]
    err_s = max([checks[n]["err"] for n in ("d652_1x1", "d652_1x4", "config4")]
                + [errs.get("rowgather_sum_cols", 0.0)])
    err_c = max(main_c["err"], errs.get("rowgather_sum_counts_cols", 0.0))
    c4 = checks["config4"]
    # the route's gather, on the same rows, with 1e's time beside it
    g_err, g_ms, g_plain, g_io, g_lib, _ = check_dense_kernel(
        torch, np, "rowgather_sum", (c4_call[0][:2], {}),
        "config 4 sharded 1x1, the unfused pair's gather")
    c4_entry = entry("rowgather_sum_sharded_config4", counts_4["rowgather_sum"], g_err, g_ms,
                     g_plain, *g_io, g_lib, fused="rowgather_sum_cols", fused_ms=c4["ms"],
                     fused_max_abs_err=c4["err"], fused_bound_ms=bound(*c4["io"])[0],
                     pair_ms=c4["pair_ms"], route=list(route_4), **c4["layout"])
    del c4_call
    kernels = [
        entry("rowgather_sum_cols", counts4["rowgather_sum_cols"], err_s, main_s["ms"],
              main_s["plain_ms"], *main_s["io"], main_s["library_ms"], pair_ms=main_s["pair_ms"],
              **main_s["layout"], d652_1x1_ms=at_1x1["ms"], d652_1x1_pair_ms=at_1x1["pair_ms"],
              d652_1x1_bound_ms=bound(*at_1x1["io"])[0], d652_1x1_route=list(route1),
              d652_1x1_launches=counts1["rowgather_sum_cols"]),
        c4_entry,
        entry("rowgather_sum_counts_cols", counts_c["rowgather_sum_counts_cols"], err_c,
              main_c["ms"], main_c["plain_ms"], *main_c["io"], main_c["library_ms"],
              pair_ms=main_c["pair_ms"], **main_c["layout"]),
        # kernel A's counts form: its main path is a classic shard past the
        # fused kernel's limit (10e); timed on D652 classic's sums and counts
        entry("finish_cols_partial_counts", past.get("finish_cols_partial_counts", 0),
              max(ka["err"], errs.get("finish_cols_partial_counts", 0.0)), ka["ms"],
              ka["plain_ms"], *ka["io"], None),
    ]
    summary["cols_past_limit_launches"] = past
    return kernels, summary, past, errs


def config2_fixture():
    """BASELINE.md config 2 at full size (epik_tpu/tools/bench_configs.py:
    38-45): the amino database (652 leaves, k = 8) and the FASTA records:
    reads with X, B, Z and J (each over a residue it expands to), reads
    shorter than k and a no-hit read, then 20,000 144 aa reads."""
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=652, kmer_size=8, ref_length=400_000,
                                mean_posting_len=12.0, sequence_type="amino", seed=20)
    reads = reads_from_reference(ref, AA_READS, length=144, mutation_rate=0.02,
                                 sequence_type="amino", seed=21)
    def amb(seq: bytes, code: bytes, covers: bytes) -> bytes:
        """``seq`` with its first residue in ``covers`` from position 60 on
        replaced by the ambiguity ``code`` that expands to it."""
        i = next(i for i in range(60, len(seq)) if seq[i] in covers)
        return seq[:i] + code + seq[i + 1:]

    r = [rec[1] for rec in reads[:6]]
    extras = [
        ("amb_x", amb(r[0], b"X", b"ACDEFGHIKLMNPQRSTVWY")),
        ("amb_x2", amb(r[1], b"X", b"ACDEFGHIKLMNPQRSTVWY")),
        ("amb_b", amb(r[2], b"B", b"DN")),
        ("amb_zj", amb(amb(r[3], b"Z", b"EQ"), b"J", b"IL")),
        ("short_7", r[4][:7]),
        ("short_2", b"AC"),
        ("nohit", b"W" * 144),
    ]
    return db, extras + reads


def amino_cli(torch, name: str, argv: list, records, step_mod_name: str, kernel: str):
    """One phase-11 CLI run with the counts zeroed just before and read just
    after, recording every call of the step ``step_mod_name`` (in
    ``engine.placer``; in ``parallel.sharding`` for the sharded steps) and of
    ``kernel`` (in ``engine.step``). The pipeline stages batches on several
    threads, so the calls come in any order. Returns (jplace rows, counts,
    reads/s, the step call of the most reads, kernel calls, CLI output)."""
    from epik_tpu_torch.engine import placer as placer_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.parallel import sharding as sharding_mod
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    out_dir = argv[argv.index("-o") + 1]
    os.makedirs(out_dir)
    module = sharding_mod if step_mod_name.startswith("sharded") else placer_mod
    steps, calls = [], []
    reset_launch_counts()
    with recording(module, step_mod_name, steps), recording(step_mod, kernel, calls):
        rc, cli_out, _ = run_cli(torch, argv)
    counts = launch_counts()
    log("cli: python -m epik_tpu_torch " + " ".join(argv))
    for line in cli_out.splitlines():
        log("  | " + line)
    if rc != 0 or not steps:
        raise AssertionError(f"{name}: rc {rc}, the step {step_mod_name} never ran")
    rows = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
    if set(rows) != {n for n, _ in records}:
        raise AssertionError(f"{name}: jplace names differ")
    rate = len(records) / placement_ms(cli_out) * 1e3
    widest = max(steps, key=lambda c: c[0][-2].shape[0])  # (..., buf, arows)
    return rows, counts, rate, widest, calls, cli_out


def amino_phase(torch, np, card: str, dev, d652: dict) -> tuple[list, dict]:
    """Phase 11 (see the module docstring). Returns the fused kernel's
    config-2 entry and the phase's summary numbers."""
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import reference_like_db
    from epik_tpu_torch.io.db import load, save
    from epik_tpu_torch.kernels.rowgather import shifted_fused
    from epik_tpu_torch.ops.tokenize import tokenize_codes, tokenize_radix

    summary = {}
    work = os.path.join(d652["work"], "amino")
    os.makedirs(work)
    # ---- 11a. fixture ---------------------------------------------------------------------
    t0 = time.monotonic()
    db, records = config2_fixture()
    db_path = os.path.join(work, "config2.eptk")
    save(db, db_path)
    fasta = os.path.join(work, "q.fasta")
    write_fasta(fasta, records)
    db = load(db_path, mu=1.0, user_omega=1.5)
    tree = parse_newick(db.tree())
    summary["config2_fixture_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    oracle = ReferencePlacer(db, tree).place(records[:PARITY_READS])
    summary["config2_oracle_s"] = time.monotonic() - t0
    B = tree.get_node_count()
    log(f"config 2 fixture: {db.num_kmers} k-mers, {db.num_entries} postings, {B} branches, "
        f"{len(records)} reads ({summary['config2_fixture_s']:.1f} s; oracle on "
        f"{PARITY_READS} reads {summary['config2_oracle_s']:.1f} s)")

    def argv(out: str, *flags, path=db_path, fa=fasta, states="amino"):
        return ["place", "-s", states, "-i", path, "-o", os.path.join(work, out),
                "--batch-size", str(AA_BATCH), *flags, fa]

    # ---- 11b. the amino main path through the CLI ---------------------------------------------
    rows, counts, rate, step, fused, cli_out = amino_cli(
        torch, "config 2", argv("out"), records, "place_batch_dense_codes", "rowgather_sum_topk")
    if "(1 device(s), dense)" not in cli_out:
        raise AssertionError("config 2: not on the dense route")
    if counts["rowgather_sum_topk"] <= 0 or counts["rowgather_sum"] or counts["finish_topk"]:
        raise AssertionError(f"config 2: launches {counts}")
    worst = check_parity(oracle, rows, "config 2")
    summary.update(config2_cli_reads_per_s=rate, config2_fused_launches=counts[
        "rowgather_sum_topk"], config2_parity_worst=worst)
    log(f"config 2 main path: {len(records)} reads, pipeline {rate:.0f} reads/s [{card}]; "
        f"launches { {n: c for n, c in counts.items() if c} }; parity on {PARITY_READS} reads "
        f"(X/B/Z, short, no-hit included): largest score difference {worst:.3g}")

    # ---- 11c. the fused kernel on the first two batches, the rows, the step's parts -----------
    # the pipeline stages batches on several threads: the batch holding the
    # X/B/Z reads is the call with delta rows, whichever came first
    amb = [c for c in fused if c[0][3] is not None and c[0][3].numel()]
    clean = [c for c in fused if c[0][3] is None]
    if not amb or not clean:
        seen = [None if c[0][3] is None else c[0][3].numel() for c in fused]
        raise AssertionError(f"config 2: no batch with delta rows, or none without: the "
                             f"batches' delta row counts {seen}")
    err, ms, plain_ms, io_k, _, shape = check_dense_kernel(
        torch, np, "rowgather_sum_topk", amb[0], "config 2, the batch with delta rows")
    err = max(err, check_dense_kernel(torch, np, "rowgather_sum_topk", clean[0],
                                      "config 2, a batch without")[0])
    aa_pair = cuda_ms(torch, unfused_pair(kernels_mod, amb[0], cols=False))
    aa_layout = group_launch(torch, amb[0][0][0], amb[0][1]["B"], amb[0][1]["K"], counts=False,
                             cols=False)
    plane, rows_t = amb[0][0][:2]
    rows_long = rows_t.long()
    lib_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(rows_long, plane,
                                                                     mode="sum"))
    del rows_long
    (plane, radix, buf, arows), kw_s = step
    ck = dict(k=kw_s["k"], sigma=kw_s["sigma"], Lmax=kw_s["Lmax"])
    key, ok, _ = tokenize_codes(buf, **ck)
    got_rows, _ = tokenize_radix(buf, radix, num_kmers=kw_s["num_kmers"], **ck)
    key_np, ok_np = key.cpu().numpy(), ok.cpu().numpy()
    pos = np.minimum(np.searchsorted(db.keys, key_np.astype(np.uint64)), db.num_kmers - 1)
    want_rows = np.where(ok_np & (db.keys[pos] == key_np.astype(np.uint64)), pos, db.num_kmers)
    if not np.array_equal(got_rows.cpu().numpy(), want_rows):
        raise AssertionError("config 2: the radix rows differ from the host's binary search")
    summary.update(
        config2_fused_ms=ms, config2_fused_plain_ms=plain_ms, config2_fused_bound_ms=bound(
            *io_k)[0], config2_embedding_bag_ms=lib_ms, config2_unfused_pair_ms=aa_pair,
        config2_step_ms=cuda_ms(torch, lambda: step_mod.place_batch_dense_codes(
            plane, radix, buf, arows, **kw_s), reps=5),
        config2_tokenize_lookup_ms=cuda_ms(torch, lambda: tokenize_radix(
            buf, radix, num_kmers=kw_s["num_kmers"], **ck)),
        config2_tokenize_ms=cuda_ms(torch, lambda: tokenize_codes(buf, **ck)),
        config2_lookup_ms=cuda_ms(torch, lambda: radix.lookup(key, kw_s["num_kmers"])),
        config2_radix_form=radix.form, config2_radix_bytes=radix.nbytes,
        config2_hit_share=float((want_rows < db.num_kmers).sum()) / float(ok_np.sum()))
    log(f"rowgather_sum_topk {shape} bw={plane.shape[1]} B={B} (config 2, a batch with "
        f"{int(amb[0][0][3].numel())} delta rows, one without): bit-equal but log_sum, two "
        f"launches alike; kernel {ms:.4f} ms ({aa_layout}), the unfused pair on the same rows "
        f"{aa_pair:.4f} ms, plain {plain_ms:.4f} ms, embedding_bag (sums only) {lib_ms:.4f} ms, "
        f"bound {bound(*io_k)[0]:.4f} ms ({io_k[0]} bytes) [{card}]")
    log(f"config 2 codes step at R={buf.shape[0]} (Lmax {kw_s['Lmax']}): "
        f"{summary['config2_step_ms']:.4f} ms; tokenize + radix lookup "
        f"{summary['config2_tokenize_lookup_ms']:.4f} ms (tokenize "
        f"{summary['config2_tokenize_ms']:.4f}, lookup {summary['config2_lookup_ms']:.4f} over "
        f"{key.numel()} window keys, {radix.form} form, {radix.nbytes} bytes of tables); rows "
        f"equal to the host's binary search; {summary['config2_hit_share']:.3f} of the valid "
        f"windows hit [{card}]")
    del plane, radix, buf, arows, step, fused, amb, clean, key, ok, got_rows, rows_t
    torch.cuda.empty_cache()

    # ---- 11d. place(): synchronous batches ------------------------------------------------------
    placer = TorchPlacer(db, tree, device=dev)
    batches = [records[i:i + AA_BATCH] for i in range(0, len(records), AA_BATCH)]
    placer.place(batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for b in batches:
        placer.place(b)
    torch.cuda.synchronize()
    summary["config2_place_reads_per_s"] = len(records) / (time.monotonic() - t0)
    log(f"config 2 place(): {len(records)} reads in batches of {AA_BATCH}: "
        f"{summary['config2_place_reads_per_s']:.0f} reads/s [{card}]; plane "
        f"{tuple(placer.state.plane.shape)} f32, {placer.state.nbytes} bytes with the radix")
    del placer
    torch.cuda.empty_cache()

    # ---- 11e. the variants: pair plane, int16, sharded 1x1 ---------------------------------
    variants = [
        ("pair_on", ["--pair-plane", "on"], "place_batch_dense_codes_paired",
         "rowgather_sum_topk", "sets", "(1 device(s), dense)"),
        ("int16", ["--precision", "int16"], "place_batch_dense_codes",
         "rowgather_sum_topk_int16", "jplace_diff", "(1 device(s), dense)"),
        ("sharded", ["--engine", "sharded"], "sharded_dense_rows_step", "rowgather_sum_cols",
         "sets", "sharded mesh 1x1 (dense)"),
    ]
    for name, flags, step_name, kernel, rule, line in variants:
        rows, counts, rate, step, _, cli_out = amino_cli(
            torch, f"config 2 {name}", argv(f"out_{name}", *flags), records, step_name,
            kernel if name != "sharded" else "rowgather_sum_topk")
        route = (kernel,)
        if name == "sharded":  # the shard's route, by the width rule
            bwl = step[0][0][0].shape[1]
            route = (("rowgather_sum_cols",) if shifted_fused(bwl, cols=True)
                     else ("rowgather_sum", "finish_cols_partial"))
            summary["config2_sharded_route"] = route
        shifted = ("rowgather_sum_topk", "rowgather_sum", "finish_cols_partial",
                   "rowgather_sum_cols")
        if line not in cli_out or any(counts[n] <= 0 for n in route) or (
                name == "sharded" and any(counts[n] for n in shifted if n not in route)):
            raise AssertionError(f"config 2 {name}: launches {counts}, the route {route}\n"
                                 f"{cli_out}")
        worst = check_parity(oracle, rows, f"config 2 {name}", rule)
        summary[f"config2_{name}_cli_reads_per_s"] = rate
        extra = ""
        if name == "pair_on":
            pr = step[0][2]
            extra = (f"; pair radix {pr.form} form, {pr.n_probe} probes; pair plane "
                     f"{tuple(step[0][0].shape)}")
            summary["config2_pair_step_ms"] = cuda_ms(
                torch, lambda: step_mod.place_batch_dense_codes_paired(*step[0], **step[1]),
                reps=5)
            extra += f"; paired codes step {summary['config2_pair_step_ms']:.4f} ms"
        log(f"config 2 {name} (CLI {' '.join(flags)}): {rate:.0f} reads/s [{card}]; launches "
            f"{ {n: c for n, c in counts.items() if c} }; parity on {PARITY_READS} reads by "
            f"{rule}: largest score difference {worst:.3g}{extra}")
        del step
        torch.cuda.empty_cache()

    # ---- 11f. DNA k = 14 at D652's leaves: the codes tokenizer over 28-bit keys -------------
    t0 = time.monotonic()
    db14, _ = reference_like_db(num_leaves=652, kmer_size=14, ref_length=520_000,
                                mean_posting_len=12.0, seed=652)
    path14 = os.path.join(work, "k14.eptk")
    save(db14, path14)
    db14 = load(path14, mu=1.0, user_omega=1.5)
    recs14 = d652["records"][:K14_READS]
    fasta14 = os.path.join(work, "k14", "q.fasta")
    os.makedirs(os.path.dirname(fasta14))
    write_fasta(fasta14, recs14)
    oracle14 = ReferencePlacer(db14, parse_newick(db14.tree())).place(recs14[:PARITY_READS])
    build_s = time.monotonic() - t0
    rows, counts, rate, step, _, cli_out = amino_cli(
        torch, "DNA k=14", argv("out_k14", path=path14, fa=fasta14, states="nucl"), recs14,
        "place_batch_dense_codes", "rowgather_sum_topk")
    if "(1 device(s), dense)" not in cli_out or counts["rowgather_sum_topk"] <= 0:
        raise AssertionError(f"DNA k=14: launches {counts}")
    worst = check_parity(oracle14, rows, "DNA k=14")
    (plane, radix, buf, arows), kw_s = step
    summary.update(k14_cli_reads_per_s=rate, k14_step_ms=cuda_ms(
        torch, lambda: step_mod.place_batch_dense_codes(plane, radix, buf, arows, **kw_s),
        reps=5))
    log(f"DNA k=14 ({kw_s['B']} branches, {db14.num_kmers} k-mers, plane {tuple(plane.shape)}, "
        f"radix {radix.form} form, {radix.n_probe} probes; fixture and oracle {build_s:.1f} s): "
        f"{len(recs14)} reads, {rate:.0f} reads/s [{card}]; launches "
        f"{ {n: c for n, c in counts.items() if c} }; parity on {PARITY_READS} reads: largest "
        f"score difference {worst:.3g}; codes step at R={buf.shape[0]} "
        f"{summary['k14_step_ms']:.4f} ms")
    del plane, radix, buf, arows, step
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    # embedding_bag computes the sums alone, not the finish
    kernels = [entry("rowgather_sum_topk_config2", summary["config2_fused_launches"], err, ms,
                     plain_ms, *io_k, lib_ms, pair_ms=aa_pair, **aa_layout)]
    return kernels, summary


def check_csr_sums(torch, b, s, ptr, R: int, B: int, what: str) -> float:
    """Kernel 4's row-pointer form against its plain version on the flat
    cells (b, s) with row pointer ``ptr``: the sums' bits (-0.0 included) and
    the counts equal, and a second launch gives the same bytes. Returns the
    largest absolute difference."""
    from epik_tpu_torch.kernels.accumulate_sums import (
        accumulate_sums_counts_csr,
        accumulate_sums_counts_csr_plain,
    )

    S1, C1 = accumulate_sums_counts_csr(b, s, ptr, R=R, B=B)
    S2, C2 = accumulate_sums_counts_csr(b, s, ptr, R=R, B=B)
    S_p, C_p = accumulate_sums_counts_csr_plain(b, s, ptr, R=R, B=B)
    torch.cuda.synchronize()
    if not (torch.equal(S1.view(torch.int32), S_p.view(torch.int32)) and torch.equal(C1, C_p)):
        raise AssertionError(f"{what}: not bit-equal to the plain version")
    if not (torch.equal(S1.view(torch.int32), S2.view(torch.int32)) and torch.equal(C1, C2)):
        raise AssertionError(f"{what}: two launches differ")
    return float((S1 - S_p).abs().max())


def last_configs_phase(torch, np, card: str, dev, fx: dict) -> tuple[list, dict]:
    """Phase 12 (see the module docstring), on phase 7's fixture. Returns the
    kernel entries of kernel 2 over the pair rows and of kernel 4's
    row-pointer form, and the phase's summary numbers."""
    from epik_tpu_torch.engine import placer as placer_mod
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.accumulate_packed import (
        accumulate_packed_topk,
        accumulate_packed_topk_plain,
        packed_sums_plain,
    )
    from epik_tpu_torch.kernels.accumulate_sums import (
        accumulate_sums_counts_csr,
        accumulate_sums_counts_csr_plain,
        plan,
    )
    from epik_tpu_torch.ops import csr as csr_mod
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
    from torch_fixtures import flat_cells, score_rows

    db, tree, reads, records = fx["db"], fx["tree"], fx["reads"], fx["records"]
    B = tree.get_node_count()
    summary = {}
    clean = reads[BT_READS - BT_BATCH:]  # the last batch: no IUPAC or short reads
    seqs = list(dict.fromkeys(s for _, s in clean))
    long_reads = [r for r in records if r[0].startswith("long_")]
    long_seqs = list(dict.fromkeys(s for _, s in long_reads))

    def run(placer, name: str):
        return run_placer(torch, placer, fx["fasta"], os.path.join(fx["work"], name),
                          fx["newick"], BT_BATCH)

    def counting(placer, attr: str) -> list:
        """Count the calls of the placer's method ``attr`` (one per step)."""
        n, fn = [0], getattr(placer, attr)

        def wrapped(*args, _f=fn):
            n[0] += 1
            return _f(*args)

        setattr(placer, attr, wrapped)
        return n

    def check_rows(rows, what: str) -> float:
        if set(rows) != {name for name, _ in records}:
            raise AssertionError(f"{what}: jplace names differ")
        lls = [ll for rws in rows.values() for _, ll in rws]
        if not lls or not all(math.isfinite(x) for x in lls):
            raise AssertionError(f"{what}: no likelihoods or non-finite ones")
        return check_parity(fx["oracle_out"], rows, what)

    # ---- 12a. the pair-fused posting tiles: kernel 2 over 2 * PT pair rows ----------
    t0 = time.monotonic()
    placer = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", pair_plane="on"),
                         device=dev)
    torch.cuda.synchronize()
    summary["paired_build_s"] = time.monotonic() - t0
    ts = placer.tiles
    if placer.route != "tiles" or not (ts.paired and ts.packed) or ts.tiles_ov is not None:
        raise AssertionError(f"pair_plane='on': route {placer.route}, paired {ts.paired}")
    n_pairs = ts.tiles.shape[0] - ts.n_keys - 1
    summary.update(paired_plane_bytes=nbytes(ts.tiles), paired_state_bytes=ts.nbytes,
                   n_pairs=n_pairs, paired_pt=ts.pt)
    log(f"12a pair-fused tiles: route {placer.route}, paired {ts.paired}; plane "
        f"({ts.tiles.shape[0]} x {ts.tiles.shape[1]}) int32 = {nbytes(ts.tiles)} bytes "
        f"({n_pairs} pair rows, PT = {ts.pt}), {ts.nbytes} bytes with the direct tables "
        f"(built in {summary['paired_build_s']:.1f} s)")
    calls = []
    with recording(step_mod, "accumulate_packed_topk", calls):
        placer.place(clean)
    (p, m_f32), kw = calls[0]
    K = kw["K"]
    got, sq = accumulate_packed_topk(p, m_f32, **kw, return_sums=True)
    again, sq2 = accumulate_packed_topk(p, m_f32, **kw, return_sums=True)
    want = accumulate_packed_topk_plain(p, m_f32, **kw)
    torch.cuda.synchronize()
    if not torch.equal(sq.long(), packed_sums_plain(p, B)):
        raise AssertionError("accumulate_packed_topk (pair rows): integer sums differ")
    if not (torch.equal(got, again) and torch.equal(sq, sq2)):
        raise AssertionError("accumulate_packed_topk (pair rows): two launches differ")
    err2p = check_finish(np, got.cpu().numpy(), want.cpu().numpy(), K, B,
                         "accumulate_packed_topk (pair rows)")
    touched = int((sq > 0).sum())
    ms2p = cuda_ms(torch, lambda: accumulate_packed_topk(p, m_f32, **kw))
    plain_ms2p = cuda_ms(torch, lambda: accumulate_packed_topk_plain(p, m_f32, **kw))
    io2p = (nbytes(p, m_f32) + p.shape[0] * (2 * K + 3) * 4, p.numel() + FINISH_OPS * touched)
    del got, again, want, sq, sq2, calls
    log(f"accumulate_packed_topk over pair rows {tuple(p.shape)} B={B} K={K} "
        f"({touched / p.shape[0]:.1f} branches touched per read): sums and pack bit-equal "
        f"but log_sum, two launches alike; kernel {ms2p:.4f} ms, plain {plain_ms2p:.4f} ms, "
        f"bound {bound(*io2p)[0]:.4f} ms [{card}]")
    # the pair-fused step against the unpaired one, in turns
    unpaired = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device=dev)
    unpaired._csr_cache = placer.csr  # the same cuckoo table: built once
    step_p, _, _ = placer._stage_tiles(seqs)
    step_u, OV, _ = unpaired._stage_tiles(seqs)
    turns = [cuda_ms(torch, lambda: step_u(OV)), cuda_ms(torch, lambda: step_p(None)),
             cuda_ms(torch, lambda: step_p(None)), cuda_ms(torch, lambda: step_u(OV))]
    summary.update(tile_step_unpaired_ms=[turns[0], turns[3]],
                   tile_step_paired_ms=[turns[1], turns[2]])
    log(f"device step at R={len(seqs)}: pair-fused tiles (paired tokenizer + one 2*PT "
        f"gather per slot + kernel 2 over {p.shape[1]} cells) {turns[1]:.4f}, "
        f"{turns[2]:.4f} ms; unpaired tiles (OV = {OV}) {turns[0]:.4f}, {turns[3]:.4f} ms "
        f"(in turns) [{card}]")
    del step_p, step_u, unpaired, p, m_f32
    torch.cuda.empty_cache()
    n_csr = counting(placer, "_stage_csr")
    tile_steps = []
    with recording(placer_mod, "place_batch_tiles_paired", tile_steps):
        stats, counts_a, rows = run(placer, "placements_paired.jplace")
    if not tile_steps or counts_a["accumulate_packed_topk"] != len(tile_steps):
        raise AssertionError(f"pair-fused pass: kernel 2 launched "
                             f"{counts_a['accumulate_packed_topk']} times for "
                             f"{len(tile_steps)} tile steps")
    if counts_a["accumulate_sums_counts"] <= 0 or counts_a["finish_topk_counts"] <= 0:
        raise AssertionError(f"pair-fused pass: no CSR step ran: {counts_a}")
    worst = check_rows(rows, "pair-fused tiles")
    summary.update(paired_pipeline_reads_per_s=stats.num_seq_placed / stats.wall_seconds,
                   paired_tile_steps=len(tile_steps), paired_csr_steps=n_csr[0],
                   paired_overflow_retries=placer.overflow_retries)
    log(f"pair-fused pass: {stats.summary()} = "
        f"{summary['paired_pipeline_reads_per_s']:.0f} reads/s through the pipeline "
        f"[{card}]; {len(tile_steps)} tile steps, {n_csr[0]} CSR steps of "
        f"{stats.num_iterations} batches; launches {counts_a}; parity on "
        f"{len(fx['parity_records'])} reads: largest score difference {worst:.3g}")
    del placer, tile_steps
    torch.cuda.empty_cache()

    # ---- 12b. accumulate="scatter": the flat CSR step, kernel 4's row-pointer form -----
    placer = TorchPlacer(db, tree, config=PlacerConfig(accumulate="scatter"), device=dev)
    if placer.route != "csr":
        raise AssertionError(f"accumulate='scatter' took route {placer.route}")
    placer.csr
    calls = []
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with recording(csr_mod, "accumulate_sums_counts_csr", calls):
        placer.place(long_reads)
    torch.cuda.synchronize()
    summary["flat_csr_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    (b, s, ptr), kw5 = calls[0]
    R = kw5["R"]
    err5 = check_csr_sums(torch, b, s, ptr, R, B, "accumulate_sums_counts_csr (400 bp batch)")
    how = plan(B, True, row_ptr=True)
    rng = np.random.default_rng(12)
    b_e, s_e = score_rows(rng, 256, 6000, B,
                          edges=tuple(how.tile_w * t for t in range(1, how.n_tiles)))
    lens = rng.integers(0, 6001, 256)
    lens[[0, 3]] = [6000, 0]
    fb, fs, fptr = (torch.from_numpy(x).to(dev) for x in flat_cells(b_e, s_e, lens, extra=999))
    err5 = max(err5, check_csr_sums(torch, fb, fs, fptr, 256, B,
                                    "accumulate_sums_counts_csr (engineered)"))
    del fb, fs, fptr, b_e, s_e
    ms5 = cuda_ms(torch, lambda: accumulate_sums_counts_csr(b, s, ptr, R=R, B=B))
    plain_ms5 = cuda_ms(torch, lambda: accumulate_sums_counts_csr_plain(b, s, ptr, R=R, B=B),
                        reps=5, warmup=1)
    # the library yardstick: one scatter-add of the kept cells' scores into
    # (R, B) zeros, the sums alone (JAX scatter-adds into (R+1, B), the slots
    # past the last read's cells on a trash row)
    n_cells = int(ptr[R] - ptr[0])
    kept = slice(int(ptr[0]), int(ptr[R]))
    rows_l = torch.arange(R, device=dev).repeat_interleave(ptr[1:] - ptr[:-1])
    cols_l, s_l = b[kept].long(), s[kept]

    def index_put():
        return torch.zeros((R, B), device=dev).index_put_((rows_l, cols_l), s_l,
                                                           accumulate=True)

    lib_ms5 = cuda_ms(torch, index_put)
    # the kept cells (branch id and score) and the row pointer read once, S
    # and C written once; an add and a count per cell
    io5 = (n_cells * 8 + nbytes(ptr) + R * B * 8, 2 * n_cells)
    summary.update(flat_P=int(b.shape[0]), flat_cells=n_cells)
    log(f"accumulate_sums_counts_csr: {n_cells} cells of {R} reads in a flat budget of "
        f"P = {b.shape[0]}, B={B}: bit-equal on the path's and engineered cells (a read "
        f"with none, reads past one 5,120-cell chunk of the sort, cells past the last "
        f"read), two launches alike; {how.n_tiles} tile(s) of {how.tile_w} branches, "
        f"{how.threads} threads, {how.smem} bytes of shared memory, {how.radix_bits}-bit "
        f"sort passes; kernel {ms5:.4f} ms, "
        f"plain {plain_ms5:.4f} ms, index_put_ (sums only) "
        f"{lib_ms5:.4f} ms, bound {bound(*io5)[0]:.4f} ms; the step's peak "
        f"{summary['flat_csr_peak_bytes']} bytes over the placer's [{card}]")
    del rows_l, cols_l, s_l, b, s, ptr, calls
    # the flat CSR step against the per-read one, in turns
    per_read = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", dense_db_budget=1),
                           device=dev)
    per_read._csr_cache = placer.csr
    step_f, P_f, PA_f, _ = placer._stage_csr(long_seqs)
    step_r, P_r, PA_r, _ = per_read._stage_csr(long_seqs)
    turns = [cuda_ms(torch, lambda: step_f(P_f, PA_f), reps=5),
             cuda_ms(torch, lambda: step_r(P_r, PA_r), reps=5),
             cuda_ms(torch, lambda: step_r(P_r, PA_r), reps=5),
             cuda_ms(torch, lambda: step_f(P_f, PA_f), reps=5)]
    summary.update(csr_step_flat_ms=[turns[0], turns[3]], csr_step_per_read_ms=turns[1:3])
    log(f"CSR step at R={len(long_seqs)} x 400 bp: flat (P = {P_f}) {turns[0]:.4f}, "
        f"{turns[3]:.4f} ms; per read (P = {P_r}) {turns[1]:.4f}, {turns[2]:.4f} ms (in "
        f"turns) [{card}]")
    del step_f, step_r, per_read
    torch.cuda.empty_cache()
    n_csr = counting(placer, "_stage_csr")
    placer.overflow_retries = 0
    stats, counts_b, rows = run(placer, "placements_scatter.jplace")
    if n_csr[0] != stats.num_iterations:
        raise AssertionError(f"scatter pass: {n_csr[0]} CSR steps of {stats.num_iterations} "
                             f"batches")
    if (counts_b["accumulate_sums_counts_csr"] < n_csr[0]
            or counts_b["finish_topk_counts"] != counts_b["accumulate_sums_counts_csr"]
            or counts_b["accumulate_sums_counts"] or counts_b["accumulate_packed_topk"]):
        raise AssertionError(f"scatter pass: launches {counts_b}")
    worst = check_rows(rows, "scatter")
    summary.update(scatter_pipeline_reads_per_s=stats.num_seq_placed / stats.wall_seconds,
                   scatter_overflow_retries=placer.overflow_retries)
    log(f"scatter pass: {stats.summary()} = {summary['scatter_pipeline_reads_per_s']:.0f} "
        f"reads/s through the pipeline [{card}]; every batch ({n_csr[0]} of "
        f"{stats.num_iterations}) on the CSR step; overflow_retries "
        f"{placer.overflow_retries}; launches {counts_b}; parity on "
        f"{len(fx['parity_records'])} reads: largest score difference {worst:.3g}")
    del placer
    torch.cuda.empty_cache()

    # ---- 12c. the sharded scatter engine on a 1x1 mesh ---------------------------------------
    names = {name for name, _ in reads[:SH_READS]}
    sub = (reads[:SH_READS] + [r for r in fx["parity_records"] if r[0] not in names
                               and not r[0].startswith("long_")] + long_reads)
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=1),
                                config=PlacerConfig(accumulate="scatter"))
    if placer.route != "csr":
        raise AssertionError(f"sharded accumulate='scatter' took route {placer.route}")
    reset_launch_counts()
    t0 = time.monotonic()
    rows = {}
    for i in range(0, len(sub), BT_BATCH):
        rows.update(placed_rows(placer.place(sub[i:i + BT_BATCH])))
    torch.cuda.synchronize()
    sh_s = time.monotonic() - t0
    counts_c = launch_counts()
    if (counts_c["accumulate_sums_counts_csr"] <= 0 or counts_c["finish_topk_counts"] <= 0
            or counts_c["accumulate_sums_counts"] or counts_c["accumulate_packed_sums"]):
        raise AssertionError(f"sharded scatter: launches {counts_c}")
    worst = check_parity(fx["oracle_out"], rows, "sharded scatter")
    summary.update(sharded_scatter_reads_per_s=len(sub) / sh_s,
                   sharded_scatter_overflow_retries=placer.overflow_retries)
    log(f"sharded scatter 1x1: {len(sub)} reads in {sh_s:.2f} s (place(), batches of "
        f"{BT_BATCH}) [{card}]; overflow_retries {placer.overflow_retries}; launches "
        f"{counts_c}; parity on {len(fx['parity_records'])} reads: largest score "
        f"difference {worst:.3g}")
    del placer
    torch.cuda.empty_cache()
    kernels = [
        # no one library call computes kernel 2 (the finish)
        entry("accumulate_packed_topk_paired", counts_a["accumulate_packed_topk"], err2p, ms2p,
              plain_ms2p, *io2p, None),
        entry("accumulate_sums_counts_csr", counts_b["accumulate_sums_counts_csr"], err5, ms5,
              plain_ms5, *io5, lib_ms5),
    ]
    return kernels, summary


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(make_argv, timeout: float, what: str) -> list[str]:
    """Two ranks (``make_argv(rank, port)``) as processes of their own, both on
    the card, each within ``timeout`` seconds; a rank that fails or runs past
    it fails the phase, and every process is ended either way."""
    port = free_port()
    procs = [subprocess.Popen(make_argv(rank, port), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if "socket.cpp" not in line:
                log(f"  rank {rank} | {line}")
        if p.returncode != 0:
            raise AssertionError(f"{what}: rank {rank} exited with {p.returncode}")
    return outs


def cli_launches(text: str) -> dict:
    """The kernel launches a ``place --verbose`` run printed (none: {})."""
    for line in text.splitlines():
        if line.startswith("Kernel launches: "):
            return ast.literal_eval(line[len("Kernel launches: "):])
    return {}


def surface_phase(torch, np, card: str, dev, d652: dict) -> dict:
    """Phase 13 (see the module docstring): the verify tool, D652 on two ranks
    of one card, the worker's CSR mode, a profiled D652 run, and the database
    and jplace commands. Returns the phase's summary."""
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary = {}
    work = os.path.join(d652["work"], "surface")
    os.makedirs(work)
    platform = ["--platform", PLATFORM]

    # ---- 13a. the verify tool ----------------------------------------------------------
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "epik_tpu_torch.tools.verify_cuda",
                          "--workdir", os.path.join(work, "verify"), *platform], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    summary["verify_s"] = time.monotonic() - t0
    for line in out.stderr.splitlines():
        log("  verify | " + line)
    lines = out.stdout.splitlines()
    log("verify: " + (lines[-1] if lines else "(no line)"))
    if out.returncode != 0 or len(lines) != 1 or not json.loads(lines[0])["ok"]:
        raise AssertionError(f"verify_cuda: rc {out.returncode}, stdout {out.stdout[-500:]}")
    verdict = json.loads(lines[0])
    log(f"verify_cuda: {verdict['cases_passed']}/{verdict['cases_total']} cases, "
        f"{verdict['reads_matched']}/{verdict['reads_total']} mixed reads, backend "
        f"{verdict['backend']}, {summary['verify_s']:.1f} s [{card}]")

    # ---- 13b. D652 on two ranks of the one card, against phase 10's 1x1 run ---------------
    base = [sys.executable, "-m", "epik_tpu_torch", "place", "-i", d652["db_path"],
            "--batch-size", str(BATCH), "--engine", "sharded", "--verbose", *platform]
    for rank in (0, 1):
        os.makedirs(os.path.join(work, f"rank{rank}"))
    outs = run_ranks(lambda rank, port: base + [
        "-o", os.path.join(work, f"rank{rank}"), "--num-processes", "2", "--process-id",
        str(rank), "--coordinator", f"127.0.0.1:{port}", d652["fasta"]], 600, "D652 2 ranks")
    want = d652["sharded_rows"]
    name = "placements_" + os.path.basename(d652["fasta"]) + ".jplace"
    for rank, text in enumerate(outs):
        if "sharded mesh 2x1 (dense)" not in text:
            raise AssertionError(f"D652 2 ranks: rank {rank} is not on the 2x1 dense mesh")
        got = parse_jplace(os.path.join(work, f"rank{rank}", name))
        if got != want:
            bad = [n for n in want if got.get(n) != want[n]]
            raise AssertionError(f"D652 2 ranks: rank {rank} differs from the 1x1 run on "
                                 f"{len(bad)} reads, e.g. {bad[:3]}")
        launched = cli_launches(text)
        route = {*d652["sharded_route"], "tokenize_combo_fused"}
        if set(launched) != route or min(launched.values()) <= 0:
            raise AssertionError(f"D652 2 ranks: rank {rank} launched {launched}, not the "
                                 f"1x1 run's route {sorted(route)}")
        gather = text.split("All-gather: ")[1].splitlines()[0]
        pl_ms = placement_ms(text)
        summary[f"d652_2rank_r{rank}_reads_per_s"] = len(want) / pl_ms * 1e3
        summary[f"d652_2rank_r{rank}_gather_ms_per_batch"] = float(
            gather.split(", ")[1].split(" ms")[0])
        summary[f"d652_2rank_r{rank}_launches"] = launched
        log(f"D652 2 ranks, rank {rank}: {len(want)} reads equal to the 1x1 run read by read; "
            f"launches {launched}; all-gather "
            f"{gather}; pipeline {pl_ms} ms = "
            f"{summary[f'd652_2rank_r{rank}_reads_per_s']:.0f} reads/s [{card}]")

    # ---- 13c. the worker's CSR mode on two ranks of the card ---------------------------------
    outs = run_ranks(lambda rank, port: [
        sys.executable, "-m", "epik_tpu_torch.tools.multihost_worker", str(rank), "2",
        str(port), "csr", *platform], 300, "worker csr")
    if not all("PARITY OK" in text for text in outs):
        raise AssertionError("worker csr: no PARITY OK")
    log(f"multihost_worker csr: PARITY OK on both ranks [{card}]")

    # ---- 13d. a profiled D652 run: the trace names the fused kernel ---------------------------
    prof_fasta = os.path.join(work, "q2.fasta")
    write_fasta(prof_fasta, d652["records"][:2 * BATCH])
    prof_dir = os.path.join(work, "profile")
    os.makedirs(os.path.join(work, "prof_out"))
    argv = ["place", "-i", d652["db_path"], "-o", os.path.join(work, "prof_out"),
            "--batch-size", str(BATCH), "--profile-dir", prof_dir, *platform, prof_fasta]
    reset_launch_counts()
    rc, cli_out, cli_s = run_cli(torch, argv)
    counts = launch_counts()
    traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
    if rc != 0 or len(traces) != 1 or counts["rowgather_sum_topk"] <= 0:
        raise AssertionError(f"--profile-dir: rc {rc}, traces {traces}, launches {counts}")
    with open(traces[0]) as f:
        trace = f.read()
    events = json.loads(trace)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the fused shifted kernel is the group layout's template (csrc/rowgather_sum.cu)
    # in its shifted f32 slim-pack instance: <T, V, kCounts, kCols>
    group = [e for e in kernels if "rowgather_group_kernel<" in e.get("name", "")]
    fused = [e for e in group if SHIFTED_KERNEL in e["name"]]
    if not fused or len(fused) != len(group):
        raise AssertionError(f"--profile-dir: {len(fused)} events of {SHIFTED_KERNEL}, "
                             f"{len(group)} of the group template ({len(kernels)} kernel "
                             f"events)")
    summary.update(profile_trace_bytes=len(trace), profile_kernel_events=len(kernels),
                   profile_fused_us=sum(e.get("dur", 0) for e in fused) / len(fused))
    log(f"--profile-dir: {len(trace)} bytes of Chrome trace, {len(kernels)} kernel events, "
        f"{len(fused)} of {fused[0]['name'][:90]!r} "
        f"({summary['profile_fused_us']:.1f} us each), the CLI {cli_s:.1f} s [{card}]")
    del trace, events

    # ---- 13e. stats, convert, diff on phase 4's database and phase 5's jplace -----------------
    def cli(*args):
        rc_, text, _ = run_cli(torch, list(args))
        if rc_ != 0:
            raise AssertionError(f"{args[0]}: rc {rc_}: {text[-500:]}")
        return text

    text = cli("stats", d652["db_path"])
    if f"k-mers: {d652['db'].num_kmers}" not in text:
        raise AssertionError(f"stats: {text}")
    ipk, back = os.path.join(work, "D652.ipk"), os.path.join(work, "D652_back.eptk")
    cli("convert", d652["db_path"], ipk)
    cli("convert", ipk, back)
    with open(d652["db_path"], "rb") as a, open(back, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("convert: .eptk -> .ipk -> .eptk is not byte-equal")
    text = cli("diff", d652["jplace"], os.path.join(work, "rank0", name))
    log(f"stats, convert (.eptk -> .ipk -> .eptk byte-equal, {os.path.getsize(ipk)} bytes of "
        f".ipk), diff of phase 5's jplace against rank 0's: {text.strip().splitlines()[-1]}")

    summary.update(model_groups_phase(torch, card, dev, d652, work))
    return summary


def model_groups_phase(torch, card: str, dev, d652: dict, work: str) -> dict:
    """Phase 13f (see the module docstring): a model group over two ranks of
    the card. D652 through ``place --engine sharded --n-model 2
    --num-processes 2`` against the single-process 1x2 run on the card; the
    worker's one-slot layout in every mode; the CSR merges' (R, B) exchange
    at D652's B. Returns the sub-phase's summary."""
    from epik_tpu_torch.core.tree import parse_newick, to_newick
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
    from epik_tpu_torch.tools.jplace_diff import parse_jplace

    summary = {}
    t_phase = time.monotonic()
    platform = ["--platform", PLATFORM]
    name = "placements_" + os.path.basename(d652["fasta"]) + ".jplace"

    # the two ranks, each holding one 768-column shard of the pair plane
    base = [sys.executable, "-m", "epik_tpu_torch", "place", "-i", d652["db_path"],
            "--batch-size", str(BATCH), "--engine", "sharded", "--n-model", "2", "--verbose",
            *platform]
    for rank in (0, 1):
        os.makedirs(os.path.join(work, f"mg_rank{rank}"))
    outs = run_ranks(lambda rank, port: base + [
        "-o", os.path.join(work, f"mg_rank{rank}"), "--num-processes", "2", "--process-id",
        str(rank), "--coordinator", f"127.0.0.1:{port}", d652["fasta"]], 600,
        "D652 1x2 over 2 ranks")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the single-process 1x2 run laid on the card, through the port's writer
    db = d652["db"]
    tree = parse_newick(db.tree())
    placer = ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=2, devices=[dev] * 2))
    if placer.route != "dense" or not placer._paired:
        raise AssertionError(f"D652 1x2: route {placer.route}, paired {placer._paired}")
    stats, counts, want = run_placer(torch, placer, d652["fasta"],
                                     os.path.join(work, "mg_single.jplace"),
                                     to_newick(tree, jplace_edges=True), BATCH)
    del placer
    gc.collect()
    torch.cuda.empty_cache()
    if counts["rowgather_sum_cols"] <= 0:
        raise AssertionError(f"D652 1x2 in one process: launches {counts}")
    launches = []
    for rank, text in enumerate(outs):
        if "sharded mesh 1x2 (dense)" not in text:
            raise AssertionError(f"D652 1x2 over 2 ranks: rank {rank} is not on the 1x2 dense mesh")
        got = parse_jplace(os.path.join(work, f"mg_rank{rank}", name))
        if got != want:
            bad = [n for n in want if got.get(n) != want[n]]
            raise AssertionError(f"D652 1x2 over 2 ranks: rank {rank} differs from the "
                                 f"single-process 1x2 run on {len(bad)} reads, e.g. {bad[:3]}")
        launched = cli_launches(text)
        if launched.get("rowgather_sum_cols", 0) <= 0:
            raise AssertionError(f"D652 1x2 over 2 ranks: rank {rank} launched {launched}")
        gather = text.split("All-gather: ")[1].splitlines()[0]
        exchange = text.split("Model exchange: ")[1].splitlines()[0]
        pl_ms = placement_ms(text)
        launches.append(launched["rowgather_sum_cols"])
        summary[f"mg_r{rank}_reads_per_s"] = len(want) / pl_ms * 1e3
        summary[f"mg_r{rank}_gather_ms_per_batch"] = float(gather.split(", ")[1].split(" ms")[0])
        summary[f"mg_r{rank}_exchange_ms_per_batch"] = float(
            exchange.split(", ")[1].split(" ms")[0])
        summary[f"mg_r{rank}_launches"] = launched
        log(f"D652 1x2 over 2 ranks, rank {rank}: {len(want)} reads equal to the single-process "
            f"1x2 run read by read; launches {launched}; all-gather {gather}; model exchange "
            f"{exchange}; pipeline {pl_ms} ms = {summary[f'mg_r{rank}_reads_per_s']:.0f} "
            f"reads/s [{card}]")
    summary["model_groups_launches"] = launches
    log(f"D652 1x2 in one process on the card: {stats.summary()}; launches "
        f"{ {n: c for n, c in counts.items() if c} } [{card}]")

    # the worker's one-slot layout: one data group over both ranks, every mode
    worker = [sys.executable, "-m", "epik_tpu_torch.tools.multihost_worker"]
    outs = run_ranks(lambda rank, port: worker + [
        str(rank), "2", str(port), "dense,csr,tiles,scatter", "--slots", "1", "--n-model", "2",
        *platform], 300, "worker 1 slot a rank")
    for rank, text in enumerate(outs):
        oks = [ln for ln in text.splitlines() if ln.startswith("PARITY OK")]
        if len(oks) != 4 or not all("(mesh 1x2, 1 all-gather(s))" in ln and
                                    "1 model exchange(s)" in ln for ln in oks):
            raise AssertionError(f"worker 1 slot a rank: rank {rank} printed {oks}")
    log(f"multihost_worker --slots 1 --n-model 2, dense/csr/tiles/scatter: PARITY OK on both "
        f"ranks [{card}]")

    # the CSR merges' (R, B) sums and counts through the exchange at D652's B: the
    # IUPAC batch (the host-staged CSR step, the first hits too) and a clean one
    outs = run_ranks(lambda rank, port: worker + [
        str(rank), "2", str(port), "csr", "--slots", "1", "--n-model", "2", *platform,
        "--database", d652["db_path"], "--fasta", d652["fasta"], "--reads", str(2 * BATCH),
        "--batch-size", str(BATCH)], 300, "worker D652 csr")
    for rank, text in enumerate(outs):
        line = next((ln for ln in text.splitlines() if ln.startswith("FILE OK")), None)
        if line is None:
            raise AssertionError(f"worker D652 csr: rank {rank} printed no FILE OK")
        summary[f"mg_csr_r{rank}"] = line
    summary["model_groups_s"] = time.monotonic() - t_phase
    log(f"13f model groups across processes: {summary['model_groups_s']:.1f} s [{card}]")
    return summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.cli.main import main as cli_main
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.db import load, save
    from epik_tpu_torch.engine.step import place_batch_dense_paired
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels._build import build_info, library
    from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
    from epik_tpu_torch.kernels.rowgather import (
        rowgather_sum,
        rowgather_sum_plain,
        rowgather_sum_topk,
        rowgather_sum_topk_plain,
    )
    from epik_tpu_torch.ops.dense import amb_deltas
    from epik_tpu_torch.ops.tokenize import tokenize_combo
    from epik_tpu_torch.tools.jplace_diff import parse_jplace
    from torch_fixtures import finish_rows  # the engineered rows of the kernel tests

    # ---- 1. device --------------------------------------------------------------
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}")

    # ---- 2. build ----------------------------------------------------------------
    library()
    log(f"build: {build_info().build_seconds:.3f} s (nvcc, sm_90a, "
        f"{len(build_info().sources())} sources in parallel)")
    for line in build_info().build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # ---- 3. fixture ----------------------------------------------------------------
    t0 = time.monotonic()
    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "out"))
    db, records = d652_fixture()
    db_path = os.path.join(work, "D652.eptk")
    save(db, db_path)
    fasta = os.path.join(work, "q.fasta")
    write_fasta(fasta, records)
    tree = parse_newick(db.tree())
    B = tree.get_node_count()
    log(f"fixture: {db.num_kmers} k-mers, {db.num_entries} postings, {B} branches, "
        f"{len(records)} reads ({time.monotonic() - t0:.1f} s)")

    # ---- 4. kernels against their plain versions, at the main path's shapes -------
    t0 = time.monotonic()
    placer = TorchPlacer(db, tree, device=dev)
    torch.cuda.synchronize()
    st = placer.state
    log(f"plane: {tuple(st.plane.shape)} f32 + {st.n_pairs} pair rows; "
        f"{st.nbytes} bytes on the card with the combo table "
        f"(built in {time.monotonic() - t0:.1f} s)")
    batch = records[:BATCH]
    seqs = list(dict.fromkeys(s for _, s in batch))
    buf, arows, Amax, Lmax, _ = placer._stage_bytes(seqs)
    buf_t = torch.from_numpy(buf).to(dev)
    arows_t = torch.from_numpy(arows).to(dev)
    rows, lens = tokenize_combo(buf_t, st.combo, k=placer.k, Lmax=Lmax)
    m_signed = (lens - (placer.k - 1)).float()
    m_f32 = torch.where(m_signed >= 0, m_signed, m_signed + float(2**64))
    K = min(placer.config.keep_at_most, B)
    log(f"main-path shapes: rows {tuple(rows.shape)}, Sp ({rows.shape[0]}, {B}), "
        f"K={K}, Amax={Amax}")
    tok = tokenizer_check(torch, card, placer, seqs, dev)

    sp_k = rowgather_sum(st.plane, rows, pair_rows=True)  # as the paired step gathers
    sp_p = rowgather_sum_plain(st.plane, rows)
    torch.cuda.synchronize()
    if not torch.equal(sp_k, sp_p):
        raise AssertionError("rowgather_sum: not bit-equal to the plain version")
    err1 = float((sp_k - sp_p).abs().max())
    ms1 = cuda_ms(torch, lambda: rowgather_sum(st.plane, rows, pair_rows=True))
    plain_ms1 = cuda_ms(torch, lambda: rowgather_sum_plain(st.plane, rows))
    rows_long = rows.long()
    lib_ms1 = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(
        rows_long, st.plane, mode="sum"))
    del rows_long
    row_bytes = rows.numel() * st.plane.shape[1] * 4
    n_zero = int((rows == st.n_keys).sum())
    # the distinct plane rows read once, the row ids, the sums written once;
    # an add per gathered float
    n_distinct = int(torch.unique(rows).numel())
    io1 = (n_distinct * st.plane.shape[1] * 4 + nbytes(rows, sp_k),
           rows.numel() * st.plane.shape[1])
    log(f"rowgather_sum {tuple(rows.shape)}: bit-equal; kernel {ms1:.4f} ms, plain "
        f"{plain_ms1:.4f} ms, embedding_bag {lib_ms1:.4f} ms; {row_bytes} bytes of rows "
        f"gathered = {row_bytes / ms1 / 1e9:.3f} TB/s ({n_zero} of {rows.numel()} slots "
        f"read the zero row, which stays in L2); {n_distinct} distinct rows: bound "
        f"{bound(*io1)[0]:.4f} ms")

    Sp = sp_k[:, :B]
    kw = dict(K=K, k=placer.k, log_eps=float(placer.log_eps))
    f_k = finish_topk(Sp, m_f32, **kw).cpu().numpy()
    f_p = finish_topk_plain(Sp, m_f32, **kw).cpu().numpy()
    err2 = check_finish(np, f_k, f_p, K, B, "finish_topk (D652 sums)")
    rng = np.random.default_rng(2)
    engineered = [(*finish_rows(rng, R_e, B_e), K_e)
                  for R_e, B_e, K_e in ((512, B, K), (64, 40, 40), (16, 20000, 5))]
    for Sp_e, m_e, K_e in engineered:
        R_e, B_e = Sp_e.shape
        Sp_e, m_e = torch.from_numpy(Sp_e).to(dev), torch.from_numpy(m_e).to(dev)
        kw_e = dict(K=K_e, k=placer.k, log_eps=float(placer.log_eps))
        got = finish_topk(Sp_e, m_e, **kw_e).cpu().numpy()
        want = finish_topk_plain(Sp_e, m_e, **kw_e).cpu().numpy()
        err2 = max(err2, check_finish(np, got, want, K_e, B_e,
                                      f"finish_topk (engineered {R_e}x{B_e})"))
        kk = min(K_e, 20)
        if not np.array_equal(got[2, K_e:K_e + kk], np.arange(10, 10 + kk)):
            raise AssertionError("finish_topk: exact ties did not go to the lowest index")
    ms2_d652 = cuda_ms(torch, lambda: finish_topk(Sp, m_f32, **kw))
    plain_ms2_d652 = cuda_ms(torch, lambda: finish_topk_plain(Sp, m_f32, **kw))
    io2_d652 = ((Sp.shape[0] * B + Sp.shape[0]) * 4 + Sp.shape[0] * (2 * K + 3) * 4,
                FINISH_OPS * Sp.shape[0] * B)
    log(f"finish_topk ({Sp.shape[0]}, {B}) K={K}: bit-equal but log_sum, engineered "
        f"rows pass; kernel {ms2_d652:.4f} ms, plain {plain_ms2_d652:.4f} ms, bound "
        f"{bound(*io2_d652)[0]:.4f} ms; rowgather_sum + finish_topk "
        f"{ms1 + ms2_d652:.4f} ms [{card}]")

    # the fused kernel: the sums, the ambiguous delta rows and the finish
    def check_fused(plane, rows_, m_, amb_read, delta, B_, K_, what, pair_rows=False):
        """The fused kernel against its plain version, two launches alike
        (``pair_rows``: in read order, as the paired step runs it)."""
        fkw = dict(B=B_, K=K_, k=placer.k, log_eps=float(placer.log_eps))
        want = rowgather_sum_topk_plain(plane, rows_, m_, amb_read, delta, **fkw)
        want = want.cpu().numpy()
        got = rowgather_sum_topk(plane, rows_, m_, amb_read, delta, pair_rows=pair_rows, **fkw)
        again = rowgather_sum_topk(plane, rows_, m_, amb_read, delta, pair_rows=pair_rows,
                                   **fkw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"rowgather_sum_topk ({what}): two launches differ")
        err = check_finish(np, got.cpu().numpy(), want, K_, B_, f"rowgather_sum_topk ({what})")
        return err, want

    step_kw = dict(k=placer.k, eps=float(placer.eps), log_eps=float(placer.log_eps))
    amb_read, delta = amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=B, **step_kw)
    if amb_read.numel() == 0:
        raise AssertionError("the first D652 batch holds no ambiguous read")
    err1f, want = check_fused(st.plane, rows, m_f32, amb_read, delta, B, K, "IUPAC batch",
                              pair_rows=True)
    ar = amb_read.cpu().numpy()
    if np.array_equal(want[ar], f_p[ar]):
        raise AssertionError("rowgather_sum_topk: the delta rows changed nothing")
    clean = list(dict.fromkeys(s for _, s in records[BATCH:2 * BATCH]))
    buf_c, _, Amax_c, Lmax_c, _ = placer._stage_bytes(clean)
    if Amax_c != 0:
        raise AssertionError("the second D652 batch holds an ambiguous read")
    rows_c, lens_c = tokenize_combo(torch.from_numpy(buf_c).to(dev), st.combo, k=placer.k,
                                    Lmax=Lmax_c)
    m_c = (lens_c - (placer.k - 1)).float()
    err1f = max(err1f, check_fused(st.plane, rows_c, m_c, None, None, B, K,
                                   "clean batch", pair_rows=True)[0])
    del rows_c, lens_c, m_c
    for Sp_e, m_e, K_e in engineered:
        R_e, B_e = Sp_e.shape
        plane_e, rows_e, m_e = fused_rows_case(torch, np, dev, Sp_e, m_e)
        e, want_e = check_fused(plane_e, rows_e, m_e, None, None, B_e, K_e,
                                f"engineered {R_e}x{B_e}")
        err1f = max(err1f, e)
        want_f = finish_topk_plain(torch.from_numpy(Sp_e).to(dev), m_e, K=K_e, k=placer.k,
                                   log_eps=float(placer.log_eps)).cpu().numpy()
        if not np.array_equal(want_e, want_f):
            raise AssertionError("rowgather_sum_topk_plain: engineered rows differ from "
                                 "finish_topk_plain")
    fkw = dict(B=B, pair_rows=True, **kw)
    ms1f = cuda_ms(torch, lambda: rowgather_sum_topk(st.plane, rows, m_f32, amb_read, delta,
                                                      **fkw))
    pair_ms1f = cuda_ms(torch, unfused_pair(kernels_mod, (
        (st.plane, rows, m_f32, amb_read, delta), fkw), cols=False))
    layout1f = group_launch(torch, st.plane, B, K, counts=False, cols=False)
    del fkw["pair_rows"]
    plain_ms1f = cuda_ms(torch, lambda: rowgather_sum_topk_plain(
        st.plane, rows, m_f32, amb_read, delta, **fkw), reps=5, warmup=1)
    # the distinct plane rows, the row ids, m, the delta rows read once and
    # the pack written once; an add per gathered float and the finish's
    # operations per (read, branch); no one library call computes it
    io1f = (n_distinct * st.plane.shape[1] * 4 + nbytes(rows, m_f32, amb_read, delta)
            + rows.shape[0] * (2 * K + 3) * 4,
            rows.numel() * st.plane.shape[1] + FINISH_OPS * rows.shape[0] * B)
    log(f"rowgather_sum_topk {tuple(rows.shape)} B={B} K={K} ({amb_read.numel()} reads "
        f"with delta rows): bit-equal but log_sum on the IUPAC and the clean batch and "
        f"on engineered rows, two launches alike; kernel {ms1f:.4f} ms ({layout1f}), plain "
        f"{plain_ms1f:.4f} ms, bound {bound(*io1f)[0]:.4f} ms; the unfused pair on the same "
        f"rows (rowgather_sum in read order, the delta add, finish_topk) {pair_ms1f:.4f} ms, "
        f"the gather and the finish timed apart {ms1 + ms2_d652:.4f} ms [{card}]")

    step_kw = dict(B=B, K=K, Amax=Amax, Lmax=Lmax, num_kmers=st.n_keys, **step_kw)
    step_ms = cuda_ms(torch, lambda: place_batch_dense_paired(
        st.plane, st.combo, buf_t, arows_t, **step_kw))
    log(f"device step (tokenize + amb delta rows + fused kernel 1) at R={len(seqs)}: "
        f"{step_ms:.4f} ms ({len(seqs) / step_ms * 1e3:.0f} reads/s) [{card}]")

    batches = [records[i:i + BATCH] for i in range(0, N_READS, BATCH)]
    placer.place(batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    placed = sum(len(placer.place(b).seqs) for b in batches)
    place_s = time.monotonic() - t0
    place_rate = N_READS / place_s
    log(f"place(): {N_READS} reads ({placed} unique) in {place_s:.3f} s = "
        f"{place_rate:.0f} reads/s, synchronous batches of {BATCH} [{card}]")
    plane_bytes = st.nbytes
    del placer, st, sp_k, sp_p, Sp, rows, buf_t, arows_t, amb_read, delta
    torch.cuda.empty_cache()

    # ---- 5. the main path, through the CLI ------------------------------------------
    out_dir = os.path.join(work, "out")
    argv = ["place", "-i", db_path, "-o", out_dir, "--batch-size", str(BATCH), fasta]
    stdout = io.StringIO()
    reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(stdout):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.monotonic() - t0
    counts = launch_counts()
    cli_out = stdout.getvalue()
    log("cli: python -m epik_tpu_torch " + " ".join(argv))
    for line in cli_out.splitlines():
        log("  | " + line)
    if rc != 0:
        raise AssertionError(f"CLI exited with {rc}")
    if counts["rowgather_sum_topk"] <= 0:
        raise AssertionError("the fused kernel 1 never launched on the main path")
    if counts["rowgather_sum"] or counts["finish_topk"]:
        raise AssertionError(f"the dense path ran the gather or the finish apart: {counts}")
    if counts["tokenize_combo_fused"] != counts["rowgather_sum_topk"]:
        raise AssertionError(f"the tokenizer kernel did not launch once a batch: {counts}")
    jplace = os.path.join(out_dir, "placements_q.fasta.jplace")
    with open(jplace) as f:
        content = json.load(f)
    rows_by_name = parse_jplace(jplace)
    names = {name for name, _ in records}
    if set(rows_by_name) != names:
        raise AssertionError(f"jplace names differ: {len(rows_by_name)} vs {len(names)}")
    lls = [ll for rws in rows_by_name.values() for _, ll in rws]
    if not lls or not all(math.isfinite(x) for x in lls):
        raise AssertionError("jplace holds no likelihoods or non-finite ones")
    if content["version"] != 3:
        raise AssertionError(f"unexpected jplace version {content['version']}")
    pl_ms = int(cli_out.split("Placement time:")[1].split("(")[1].split(" ms")[0])
    log(f"main path: {len(records)} reads -> {len(content['placements'])} jplace "
        f"records; launches {counts}; whole CLI {cli_s:.3f} s = "
        f"{len(records) / cli_s:.0f} reads/s end to end (load + plane build + "
        f"pipeline); pipeline {pl_ms} ms = {len(records) / pl_ms * 1e3:.0f} reads/s "
        f"[{card}]")

    # ---- 6. parity with the scalar oracle --------------------------------------------
    t0 = time.monotonic()
    db_loaded = load(db_path, mu=1.0, user_omega=1.5)
    oracle_d652 = ReferencePlacer(db_loaded, parse_newick(db_loaded.tree())).place(
        records[:PARITY_READS])
    worst = check_parity(oracle_d652, rows_by_name, "D652")
    log(f"parity: {PARITY_READS} reads (IUPAC, short, no-hit included) match the "
        f"scalar oracle; largest score difference {worst:.3g} "
        f"({time.monotonic() - t0:.1f} s)")

    # ---- 7. the big-tree posting-tile path and its CSR fallback -----------------------
    bt_kernels, bt, fx = bigtree_phase(torch, np, card, dev, finish_err=err2)

    # ---- 8. the column-sharded big-tree path ---------------------------------------------
    sh_kernels, sh = sharded_phase(torch, np, card, dev, fx)

    # ---- 9. the rest of the dense engine ---------------------------------------------------
    d652 = {"db": db_loaded, "db_path": db_path, "fasta": fasta, "records": records,
            "oracle_out": oracle_d652, "work": work, "jplace": jplace}
    dn_kernels, dn, extra_err = dense_phase(torch, np, card, dev, fx, d652)

    # ---- 10. the column-sharded dense engine -------------------------------------------------
    sd_kernels, sd, past, cols_errs = sharded_dense_phase(torch, np, card, dev, fx, d652)

    # ---- 11. amino (config 2) and DNA k = 14: the codes tokenizer and the radix lookup ----------
    aa_kernels, aa = amino_phase(torch, np, card, dev, d652)

    # ---- 12. the last two configs: pair-fused tiles, accumulate="scatter" --------------------
    lc_kernels, lc = last_configs_phase(torch, np, card, dev, fx)

    # ---- 13. the rest of the surface: verify tool, two ranks, profile, commands -------------
    torch.cuda.empty_cache()
    sf = surface_phase(torch, np, card, dev, d652)

    # ---- 14. the wide classic path: 1c past the fused counts kernel's limit ------------------
    torch.cuda.empty_cache()
    wc_kernels, wc = wide_classic_phase(torch, np, card, dev)

    # ---- 15. the wide shifted path: 1d past the fused kernel's limit, f32 and int16 -----------
    gc.collect()
    torch.cuda.empty_cache()
    ws_kernels, ws = wide_shifted_phase(torch, np, card, dev)
    shutil.rmtree(fx["work"], ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    imported = [m for m in sys.modules
                if m in ("jax", "epik_tpu") or m.startswith(("jax.", "epik_tpu."))]
    if imported:
        raise AssertionError(f"imported {imported[:5]}")

    kernels = [
        # the gather alone runs past the fused kernels' limits only: the
        # single-device step at B = 40,000 (phase 9) and a sharded shard past
        # rowgather_sum_cols's limit (phase 10); config 4's paths, which the
        # width rule routes to it, have entries of their own
        entry("rowgather_sum", dn["wide_rowgather_sum_launches"] + past.get("rowgather_sum", 0),
              err1, ms1, plain_ms1, *io1, lib_ms1),
        # embedding_bag computes the gather's sums alone, without the finish
        entry("rowgather_sum_topk", counts["rowgather_sum_topk"], err1f, ms1f, plain_ms1f,
              *io1f, lib_ms1, pair_ms=pair_ms1f, **layout1f),
        # bit-equal (checked), so no difference; no one library call tokenizes
        entry("tokenize_combo_fused", counts["tokenize_combo_fused"], 0.0, tok["ms"],
              tok["plain_ms"], *tok["io"], None, cell_reads=CELL_BATCH, cell_ms=tok["ms_cell"],
              cell_plain_ms=tok["plain_ms_cell"],
              cell_bound_ms=bound(*tok["io_cell"])[0]),
        *bt_kernels,
        *sh_kernels,
        *dn_kernels,
        *sd_kernels,
        *aa_kernels,
        *lc_kernels,
        *wc_kernels,
        *ws_kernels,
    ]
    for e in kernels:  # the wide-tree checks of phase 9, the limit checks of phase 10
        e["max_abs_err"] = max(e["max_abs_err"], extra_err.get(e["name"], 0.0),
                               cols_errs.get(e["name"], 0.0))
        if e["name"] == "rowgather_sum_cols":  # phase 13f's ranks, each its own count
            e["model_group_launches"] = sf["model_groups_launches"]
        if e["name"] == "rowgather_sum_counts":  # past both fused counts kernels' limits
            e["launches"] += past.get("rowgather_sum_counts", 0)
    log(f"summary: plane_bytes={plane_bytes} step_ms={step_ms} "
        f"rowgather_sum_ms={ms1} finish_topk_d652_ms={ms2_d652} rowgather_sum_topk_ms={ms1f} "
        f"place_reads_per_s={place_rate} cli_reads_per_s={len(records) / cli_s}")
    log("summary big tree: " + " ".join(f"{k}={v}" for k, v in bt.items()))
    log("summary sharded: " + " ".join(f"{k}={v}" for k, v in sh.items()))
    log("summary dense engine: " + " ".join(f"{k}={v}" for k, v in dn.items()))
    log("summary sharded dense: " + " ".join(f"{k}={v}" for k, v in sd.items()))
    log("summary amino: " + " ".join(f"{k}={v}" for k, v in aa.items()))
    log("summary last configs: " + " ".join(f"{k}={v}" for k, v in lc.items()))
    log("summary surface: " + " ".join(f"{k}={v}" for k, v in sf.items()))
    log("summary wide classic: " + " ".join(f"{k}={v}" for k, v in wc.items()))
    log("summary wide shifted: " + " ".join(f"{k}={v}" for k, v in ws.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
