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
4. kernels  -- the dense path's kernel, the row gather with the ambiguous
               delta rows and the finish fused in (``rowgather_sum_topk``),
               against its plain PyTorch version at the path's shapes (R =
               16,384) on a batch with IUPAC reads and on a clean one, and on
               the finish's engineered rows, two launches alike; the gather
               alone (``rowgather_sum``) and the finish alone (``finish_topk``)
               against theirs at the same shapes; CUDA-event times of all; the
               device step time; place() reads/s;
5. main     -- ``python -m epik_tpu_torch place`` (in process) over the FASTA,
               with every kernel's launch count zeroed just before and read
               just after: the fused kernel must have launched, the gather
               and the finish apart never;
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
                 400 bp CSR batch; the device step times (packed tiles, f32
                 tiles, CSR);
               * ``TorchPlacer(dense_db="off")`` through ``run_pipeline`` with
                 the CLI's FASTA reader and the jplace writer, the counts zeroed
                 before and read after: the packed tile kernel and the CSR
                 kernel must have launched; then one pass with
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
                 kernel 3's sums and the CSR kernel must have launched; 256
                 reads against the scalar oracle, score sets within 1e-4;
               * a 1x4 mesh laid on the one card (4 shards of 5,120 columns) on
                 8,192 clean reads and the IUPAC and short ones, score sets
                 within 1e-4 of the 1x1 jplace.
9. dense    -- the rest of the single-device dense engine:
               * config 4 through ``python -m epik_tpu_torch place`` with no
                 flags (phase 7's database saved and loaded, its FASTA): the
                 51.8 GB base plane fits the card and the pair plane does not,
                 so the CLI takes the unpaired dense route; the fused kernel
                 at (4,096 x 143) rows and bw 20,096 against its plain
                 version on the first batch, its time, the device step's; the
                 launches counted; 256 reads against the oracle, within 1e-4;
               * D652 under ``--pair-plane off``, ``--plane-mode classic``,
                 ``--precision int16``, ``--precision bf16`` (the CLI) and
                 ``lookup_where="device"``, ``tokenize_where="host"`` (the
                 library, through run_pipeline): each config's kernel (the
                 fused kernel over the unpaired f32 or the int16 plane, the
                 sums with counts over the classic f32 or bf16 plane) against
                 its plain version on the first batch, bit for bit; 256 reads
                 against the oracle (int16 by the jplace_diff rule, bf16 by
                 the best edge, as the JAX tests hold them);
               * a batch of reads shorter than k and a batch with a 65,536 bp
                 read (the host tokenizer) against the oracle;
               * the fused kernel at B = 30,000, and past its shared-memory
                 limit at B = 40,000 (the gather and the finish apart), and
                 ``finish_topk`` at B = 70,000 (ids in the global workspace),
                 against their plain versions.

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

import contextlib
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
N_READS = 65536
PARITY_READS = 256
TIMING_REPS = 20

#: the big-tree phase (BASELINE.md config 4, tools/bench_bigtree.py:30,47-55)
BT_BATCH = 4096
BT_READS = 32768
BT_LONG = 4096  # one batch of 400 bp reads: past the packed gate, all on CSR
BT_IUPAC = 6  # spread over the first batches, so they split tiles + CSR
#: the sharded phase's 1x4 mesh places this many clean big-tree reads
SH_READS = 8192

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
          nbytes: float, ops: float, library_ms: float | None) -> dict:
    """One kernel's entry of the ``{"kernels": [...]}`` line."""
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": KERNEL_META[name][0],
            "replaces": KERNEL_META[name][1], "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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
def recording(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as a step module imported it) while passing each call through."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
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
    from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
    from epik_tpu_torch.ops import csr as csr_mod
    from epik_tpu_torch.tools.jplace_diff import parse_jplace
    from torch_fixtures import packed_rows

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
    with recording(step_mod, "accumulate_packed_topk", packed_calls):
        placer.place(clean)
    with recording(csr_mod, "accumulate_sums_counts", counts_calls):
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
        need = (["accumulate_packed_topk", "accumulate_sums_counts"] if payload == "packed"
                else ["accumulate_sums", "finish_topk", "accumulate_sums_counts"])
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
    from epik_tpu_torch.cli.main import _open_reader
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.pipeline import run_pipeline
    from epik_tpu_torch.io.jplace import jplace_writer
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.accumulate_packed import accumulate_packed_sums, packed_sums_plain
    from epik_tpu_torch.parallel import sharding as sharding_mod
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
    from epik_tpu_torch.tools.jplace_diff import parse_jplace
    from torch_fixtures import packed_cells

    db, tree, reads, records = fx["db"], fx["tree"], fx["reads"], fx["records"]
    B = tree.get_node_count()
    summary = {}

    def run(placer, fasta: str, name: str):
        """The placer through run_pipeline with the port's reader and writer;
        the launch counts zeroed just before and read just after."""
        out = os.path.join(fx["work"], name)
        writer = jplace_writer(out, "chip_smoke.py", fx["newick"], resume=False)
        writer.start()
        reader = _open_reader(fasta, BT_BATCH)
        reset_launch_counts()
        stats = run_pipeline(placer, reader, writer, inflight=3)
        torch.cuda.synchronize()
        counts = launch_counts()
        writer.end()
        return stats, counts, parse_jplace(out)

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
    summary["column_finish_ms"] = cuda_ms(
        torch, lambda: sharding_mod.finish_scores_cols_shifted(Sps, m_f32, **kw_f))
    seqs = list(dict.fromkeys(s for _, s in clean))
    _, OV, rerun = placer._place_async_tiles({s: ["x"] for s in seqs}, seqs).budget
    summary["sharded_tile_step_ms"] = cuda_ms(torch, lambda: rerun(OV))
    log(f"accumulate_packed_sums {tuple(p.shape)} B={bwl}: bit-equal on the path's and "
        f"engineered cells; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_add "
        f"{lib_ms:.4f} ms, bound {bound(*io)[0]:.4f} ms; column finish (stable sort over "
        f"{bwl} columns) {summary['column_finish_ms']:.4f} ms; sharded device step "
        f"(tokenize + gathers + kernel 3 + finish) at R={len(seqs)}, OV={OV}: "
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
    stats, counts, rows = run(placer, fx["fasta"], "placements_sharded.jplace")
    missing = [n for n in ("accumulate_packed_sums", "accumulate_sums_counts")
               if counts[n] <= 0]
    if missing:
        raise AssertionError(f"sharded pass: kernels never launched: {missing}")
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
    if counts4["accumulate_packed_sums"] <= 0:
        raise AssertionError("1x4: kernel 3's sums never launched")
    worst4 = compare_rows(rows4, rows, [name for name, _ in sub], "1x4 vs 1x1")
    summary["sharded_1x4_reads_per_s"] = stats4.num_seq_placed / stats4.wall_seconds
    log(f"sharded 1x4 on one card (shard width {placer4._bwl}, built in {build4_s:.1f} s): "
        f"{stats4.summary()}; launches {counts4}; {len(sub)} reads within "
        f"{worst4:.3g} of the 1x1 jplace [{card}]")
    del placer4
    torch.cuda.empty_cache()
    kernel = entry("accumulate_packed_sums", counts["accumulate_packed_sums"], err, ms,
                   plain_ms, *io, lib_ms)
    return [kernel], summary


#: phase 9's D652 configs: name, CLI flags (None: the library, with these
#: PlacerConfig fields), and the kernel its dense step ends in
DENSE_CONFIGS = [
    ("pair_off", ["--pair-plane", "off"], None, "rowgather_sum_topk"),
    ("classic", ["--plane-mode", "classic"], None, "rowgather_sum_counts"),
    ("int16", ["--precision", "int16"], None, "rowgather_sum_topk_int16"),
    ("bf16", ["--precision", "bf16"], None, "rowgather_sum_counts_bf16"),
    ("lookup_device", None, {"lookup_where": "device"}, "rowgather_sum_counts"),
    ("tokenize_host", None, {"tokenize_where": "host"}, "rowgather_sum_topk"),
]


def check_dense_kernel(torch, np, name: str, call, what: str):
    """The dense kernel ``name`` against its plain version on a recorded call
    of a path: bit-equal (the fused finish: check_finish), two launches
    alike; CUDA-event times of both and, for the sums with counts, of one
    ``embedding_bag`` (the sums alone). Returns (err, ms, plain_ms, io,
    library_ms, shape)."""
    from epik_tpu_torch.kernels import KERNELS
    from epik_tpu_torch.kernels.rowgather import (
        rowgather_sum_counts_plain,
        rowgather_sum_topk_plain,
    )

    fn = KERNELS[name]
    args, kw = call
    plane, rows = args[0], args[1]
    bw = plane.shape[1]
    cell = plane.element_size()
    n_distinct = int(torch.unique(rows).numel())
    if name.startswith("rowgather_sum_topk"):
        m, amb_read, delta = args[2:5]
        K, B = kw["K"], kw["B"]
        got, again = fn(*args, **kw), fn(*args, **kw)
        want = rowgather_sum_topk_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} ({what}): two launches differ")
        err = check_finish(np, got.cpu().numpy(), want.cpu().numpy(), K, B, f"{name} ({what})")
        ms = cuda_ms(torch, lambda: fn(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: rowgather_sum_topk_plain(*args, **kw), reps=3,
                           warmup=1)
        amb = nbytes(amb_read, delta) if amb_read is not None else 0
        io = (n_distinct * bw * cell + nbytes(rows, m) + amb + rows.shape[0] * (2 * K + 3) * 4,
              rows.numel() * bw + FINISH_OPS * rows.shape[0] * B)
        return err, ms, plain_ms, io, None, tuple(rows.shape)
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
    rows_long = rows.long()
    lib_ms = cuda_ms(torch, lambda: torch.nn.functional.embedding_bag(rows_long, plane,
                                                                      mode="sum"))
    # the distinct rows read once, the row ids, S and C written once; an add
    # and a compare per gathered cell
    io = (n_distinct * bw * cell + nbytes(rows, S, C), 2 * rows.numel() * bw)
    return err, ms, plain_ms, io, lib_ms, tuple(rows.shape)


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


def wide_tree_checks(torch, np, card: str, dev) -> dict:
    """The kernels at the widths of the big trees, against their plain
    versions: the fused kernel at B = 30,000 (inside its limit); at B =
    40,000, past it, the wrapper refusing and the dense step running
    rowgather_sum + finish_topk (the launches counted); finish_topk at B =
    70,000, its ids in the global workspace. Returns each kernel's largest
    difference."""
    from epik_tpu_torch.engine.step import _shifted_finish
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
    from epik_tpu_torch.kernels.rowgather import (
        rowgather_sum_topk,
        rowgather_sum_topk_plain,
        topk_fits,
        topk_smem,
    )
    from epik_tpu_torch.ops.dense import amb_deltas
    from torch_fixtures import finish_rows

    rng = np.random.default_rng(30)
    kw = dict(K=7, k=10, log_eps=-4.2597)
    errs = {}
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
    return errs


def dense_phase(torch, np, card: str, dev, fx: dict, d652: dict) -> tuple[list, dict, dict]:
    """Phase 9 (see the module docstring). Returns the kernel entries of the
    new variants, the phase's summary numbers and each older kernel's largest
    difference at the wide-tree widths."""
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
    out_dir = os.path.join(fx["work"], "dense_cli")
    os.makedirs(out_dir)
    argv = ["place", "-i", c4_path, "-o", out_dir, "--batch-size", str(BT_BATCH), fx["fasta"]]
    step_calls, fused_calls = [], []
    reset_launch_counts()
    with recording(placer_mod, "place_batch_dense_bytes", step_calls), \
            recording(step_mod, "rowgather_sum_topk", fused_calls):
        rc, cli_out, cli_s = run_cli(torch, argv)
    counts = launch_counts()
    log("cli: python -m epik_tpu_torch " + " ".join(argv))
    for line in cli_out.splitlines():
        log("  | " + line)
    if rc != 0 or "(1 device(s), dense)" not in cli_out:
        raise AssertionError(f"config 4 CLI: rc {rc}, not on the dense route")
    if counts["rowgather_sum_topk"] <= 0 or counts["rowgather_sum"] or counts["finish_topk"]:
        raise AssertionError(f"config 4 CLI: launches {counts}")
    rows_by_name = parse_jplace(os.path.join(out_dir, "placements_q.fasta.jplace"))
    if set(rows_by_name) != {name for name, _ in fx["records"]}:
        raise AssertionError("config 4 CLI: jplace names differ")
    worst = check_parity(oracle_c4, rows_by_name, "config 4 dense")
    pl_ms = placement_ms(cli_out)
    n_reads = len(fx["records"])
    summary.update(config4_cli_s=cli_s, config4_dense_pipeline_reads_per_s=n_reads / pl_ms * 1e3,
                   config4_fused_launches=counts["rowgather_sum_topk"])
    (plane, direct, buf, arows), kw_s = step_calls[0][0][:4], step_calls[0][1]
    log(f"config 4 dense (unpaired shifted plane {tuple(plane.shape)} f32 = "
        f"{plane.numel() * 4} bytes, {len(step_calls)} steps): {n_reads} reads, pipeline "
        f"{pl_ms} ms = {n_reads / pl_ms * 1e3:.0f} reads/s, whole CLI {cli_s:.1f} s [{card}]; "
        f"launches {counts}; parity on {len(fx['parity_records'])} reads (IUPAC, short, "
        f"400 bp): largest score difference {worst:.3g}")
    err_c4, ms_c4, plain_c4, io_c4, _, shape_c4 = check_dense_kernel(
        torch, np, "rowgather_sum_topk", fused_calls[0], "config 4, first batch")
    summary.update(config4_fused_ms=ms_c4, config4_fused_plain_ms=plain_c4,
                   config4_fused_bound_ms=bound(*io_c4)[0])
    step_ms = cuda_ms(torch, lambda: step_mod.place_batch_dense_bytes(
        plane, direct, buf, arows, **kw_s), reps=5)
    summary["config4_dense_step_ms"] = step_ms
    log(f"rowgather_sum_topk {shape_c4} bw={plane.shape[1]} B={kw_s['B']} (config 4, unpaired): "
        f"bit-equal but log_sum, two launches alike; kernel {ms_c4:.4f} ms, plain "
        f"{plain_c4:.4f} ms, bound {bound(*io_c4)[0]:.4f} ms ({io_c4[0]} bytes); device step "
        f"(tokenize + amb delta rows + fused kernel) at R={buf.shape[0]}: {step_ms:.4f} ms "
        f"[{card}]")
    del plane, direct, buf, arows, step_calls, fused_calls
    torch.cuda.empty_cache()

    # ---- 9b. D652 under the six configs ---------------------------------------------------
    db = d652["db"]
    tree = parse_newick(db.tree())
    newick = to_newick(tree, jplace_edges=True)
    oracle_out = d652["oracle_out"]
    kernels, seen = [], set()
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
        if counts[kernel] <= 0 or counts["rowgather_sum"] or counts["finish_topk"]:
            raise AssertionError(f"D652 {name}: launches {counts}")
        rows_by_name = parse_jplace(jplace)
        if set(rows_by_name) != {n for n, _ in d652["records"]}:
            raise AssertionError(f"D652 {name}: jplace names differ")
        rule = {"int16": "jplace_diff", "bf16": "top_edge"}.get(name, "sets")
        worst = check_parity(oracle_out, rows_by_name, f"D652 {name}", rule)
        err, ms, plain_ms, io_k, lib_ms, shape = check_dense_kernel(
            torch, np, kernel, calls[0], f"D652 {name}")
        del calls
        torch.cuda.empty_cache()
        summary[f"d652_{name}_reads_per_s"] = rate
        summary[f"d652_{name}_kernel_ms"] = ms
        log(f"D652 {name} ({how}): {rate:.0f} reads/s through the pipeline [{card}]; "
            f"launches { {n: c for n, c in counts.items() if c} }; parity on "
            f"{PARITY_READS} reads by {rule}: "
            f"{'best edge agrees on a share of ' if rule == 'top_edge' else 'largest score difference '}"
            f"{worst:.4g}; {kernel} {shape}: bit-equal to its plain version"
            f"{' but log_sum' if 'topk' in kernel else ''}, two launches alike; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{'embedding_bag (sums only) ' + format(lib_ms, '.4f') + ' ms, ' if lib_ms else ''}"
            f"bound {bound(*io_k)[0]:.4f} ms")
        if kernel not in seen and kernel != "rowgather_sum_topk":
            seen.add(kernel)
            kernels.append(entry(kernel, counts[kernel], err, ms, plain_ms, *io_k, lib_ms))

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
    errs = wide_tree_checks(torch, np, card, dev)
    return kernels, summary, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
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

    sp_k = rowgather_sum(st.plane, rows)
    sp_p = rowgather_sum_plain(st.plane, rows)
    torch.cuda.synchronize()
    if not torch.equal(sp_k, sp_p):
        raise AssertionError("rowgather_sum: not bit-equal to the plain version")
    err1 = float((sp_k - sp_p).abs().max())
    ms1 = cuda_ms(torch, lambda: rowgather_sum(st.plane, rows))
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
    def check_fused(plane, rows_, m_, amb_read, delta, B_, K_, what):
        """The fused kernel against its plain version, two launches alike."""
        fkw = dict(B=B_, K=K_, k=placer.k, log_eps=float(placer.log_eps))
        want = rowgather_sum_topk_plain(plane, rows_, m_, amb_read, delta, **fkw)
        want = want.cpu().numpy()
        got = rowgather_sum_topk(plane, rows_, m_, amb_read, delta, **fkw)
        again = rowgather_sum_topk(plane, rows_, m_, amb_read, delta, **fkw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"rowgather_sum_topk ({what}): two launches differ")
        err = check_finish(np, got.cpu().numpy(), want, K_, B_, f"rowgather_sum_topk ({what})")
        return err, want

    step_kw = dict(k=placer.k, eps=float(placer.eps), log_eps=float(placer.log_eps))
    amb_read, delta = amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=B, **step_kw)
    if amb_read.numel() == 0:
        raise AssertionError("the first D652 batch holds no ambiguous read")
    err1f, want = check_fused(st.plane, rows, m_f32, amb_read, delta, B, K, "IUPAC batch")
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
                                   "clean batch")[0])
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
    fkw = dict(B=B, **kw)
    ms1f = cuda_ms(torch, lambda: rowgather_sum_topk(st.plane, rows, m_f32, amb_read, delta,
                                                      **fkw))
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
        f"on engineered rows, two launches alike; kernel {ms1f:.4f} ms, plain "
        f"{plain_ms1f:.4f} ms, bound {bound(*io1f)[0]:.4f} ms; the unfused pair "
        f"rowgather_sum + finish_topk {ms1 + ms2_d652:.4f} ms [{card}]")

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
            "oracle_out": oracle_d652, "work": work}
    dn_kernels, dn, extra_err = dense_phase(torch, np, card, dev, fx, d652)
    shutil.rmtree(fx["work"], ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    imported = [m for m in sys.modules
                if m in ("jax", "epik_tpu") or m.startswith(("jax.", "epik_tpu."))]
    if imported:
        raise AssertionError(f"imported {imported[:5]}")

    kernels = [
        # the gather alone is off the main path now (launches 0 there)
        entry("rowgather_sum", counts["rowgather_sum"], err1, ms1, plain_ms1, *io1, lib_ms1),
        # no one library call computes the gather with the finish
        entry("rowgather_sum_topk", counts["rowgather_sum_topk"], err1f, ms1f, plain_ms1f,
              *io1f, None),
        *bt_kernels,
        *sh_kernels,
        *dn_kernels,
    ]
    for e in kernels:  # the wide-tree checks of phase 9
        e["max_abs_err"] = max(e["max_abs_err"], extra_err.get(e["name"], 0.0))
    log(f"summary: plane_bytes={plane_bytes} step_ms={step_ms} "
        f"rowgather_sum_ms={ms1} finish_topk_d652_ms={ms2_d652} rowgather_sum_topk_ms={ms1f} "
        f"place_reads_per_s={place_rate} cli_reads_per_s={len(records) / cli_s}")
    log("summary big tree: " + " ".join(f"{k}={v}" for k, v in bt.items()))
    log("summary sharded: " + " ".join(f"{k}={v}" for k, v in sh.items()))
    log("summary dense engine: " + " ".join(f"{k}={v}" for k, v in dn.items()))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
