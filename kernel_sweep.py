#!/usr/bin/env python3
"""Layout variants of five of the port's kernels, timed in turns on one card:

    python3 kernel_sweep.py [--only gather|row_ptr|sum|cols|group|shifted|posted]
                            [--parent PATH]

* kernel 1d, the gather alone (``rowgather_sum``, f32 and int16), on
  ``chip_smoke.py``'s D652 pair rows (the first batch of 16,384 reads of the
  default step, recorded) and on its wide shifted tree's rows (4,096 reads
  of phase 15's first batch, f32 and int16 planes): 256-byte column slices
  of 16 reads in locality order (the shipped layout, which the paired steps
  run in read order), the same in read order, 8 and 32 reads a block, 64-,
  128- and 512-byte slices, and the slice kernel capped at 32 registers (8
  blocks an SM);
* kernel A's counts form (``finish_cols_partial_counts``) on D652's classic
  sums and counts (the first batch's, 16,381 x 1,408) and on synthetic
  (4,096 x 22,272) rows touching ~1,550 columns a read (the wide classic
  shard), and its shifted form on synthetic (4,096 x 20,096) rows touching
  ~1,540 (config 4's sharded tiles): the shipped layout (128 threads a read
  and 16 blocks an SM up to 4,096 columns, 512 threads and 4 blocks an SM
  past it, each at 32 registers, the score cache taking what is left of the
  blocks an SM the card gives), the wide block without its register cap (2
  blocks an SM, a larger cache), 512 threads at every width, and the small
  block without its register cap;
* kernel 1c, the gather with counts (``rowgather_sum_counts`` and ``_bf16``),
  on ``chip_smoke.py``'s D652 classic rows (the first batch of 16,384 reads
  of the classic step, recorded): 256-byte column slices (the shipped
  layout), 128- and 512-byte slices, and 256-byte slices in read order (no
  locality order);
* #5's row-pointer form (``accumulate_sums_counts_csr``) on 4,096 reads of
  flat cells shaped like the 400 bp CSR batch (a Poisson number of cells a
  read, mean 4,433, 2% of them on the trash column), at B = 19,999 (config
  4) and B = 22,199 (the wide classic tree): the shipped sorted block, the
  same with one block a (read, tile) item instead of a block an SM taking
  items in turn, its chunk at 4,096 and 6,144 cells, its passes at 4 bits
  only and at 5 bits only; and the owner-warp block of ``kernel_variants/accumulate_sums_tiles.cu``
  at 1 tile of 32 warps (the layout the sorted block replaced) and at 2 and 4
  tiles of 8 warps, several blocks an SM, with the cp.async.bulk write-out
  and with a thread block cluster a read.

* the fused counts kernels in the group layout, 1b (``rowgather_sum_counts_topk``
  and ``_bf16``) and 1f (``rowgather_sum_counts_cols``), on ``chip_smoke.py``'s
  D652 classic rows with their first hits (the first batch of 16,384 reads of
  the classic and the bf16 step, recorded; 1f on the f32 rows as one shard,
  B = bwl = 1,408): G reads a block (a launch argument; the shipped choice,
  G = 4 at D652, and G = 2, 8) against blocks an SM (``-D
  EPIK_GROUP_MIN_BLOCKS``, the register budget), threads a block
  (``EPIK_GROUP_THREADS``) and loads in flight a thread
  (``EPIK_GROUP_UNROLL``), and the shipped layout in read order; with
  ``--parent``, the parent checkout's kernels (its ``rowgather_sum.cu``
  built the same way, called through its own entry points) in the same
  turns. Each variant's blocks an SM, from the occupancy calculator, is
  written beside its time.

* the fused shifted kernels in the group layout's shifted form, #1 / 1a
  (``rowgather_sum_topk`` and ``_int16``) and 1e (``rowgather_sum_cols``),
  each on the rows its path gives it (the first batch of ``chip_smoke.py``'s
  fixtures, recorded at the step's router, so whichever route it takes):
  D652's pair rows (16,381 x 72; 1e on them as the 1x1 shard), D652's
  unpaired rows in f32 and int16 (16,378 x 143), the 1x4 and 1x2 meshes'
  first shards (bwl 384, 768), config 2's codes rows (4,096 x 137) and
  config 4's rows at bw
  20,096 (#1 and 1e): G reads a block (a launch argument; the shipped choice
  and G = 2, 4, 16), blocks an SM (``-D EPIK_GROUP_MIN_BLOCKS``), loads in
  flight (``EPIK_GROUP_UNROLL``), 256- and 1,024-byte slices (the shipped
  512, ``EPIK_SHIFTED_LANES``) and the other read order; beside them, in the
  same turns, the shipped kernel through its public wrapper ("fused"), the
  unfused pair through this checkout's wrappers (``rowgather_sum`` in the
  step's order, the delta add, ``finish_topk`` / ``finish_cols_partial``)
  and, with ``--parent``, the parent checkout's fused kernels (its
  ``rowgather_sum.cu`` built the same way, called through its own entry
  points); then the wrapper and the pair in turns again with the card kept
  busy ahead of them (``queued``: their device time, and the host's time in
  each call); then the shipped kernel, the wrapper, the pair and the parent
  over D652's unpaired rows on its plane's columns cut or repeated to widths
  of 1,024 to 19,712, around and between the paths' widths, which set the
  crossover (``kernels/rowgather.py::shifted_fused``).

* the gather over a shifted f32 plane's posted cells
  (``rowgather_sum_posted``) against 1d (``rowgather_sum``), both through
  their wrappers, in turns, at the ``wol10k.illumina150`` cell's shapes
  (``chip_smoke.wol10k_shaped``: 644,814 rows x 21,248 columns, ~12 posted
  cells a key, 2,000 reads of 141 windows) and at config 4's (644,814 x
  20,096, 4,096 reads of 143 windows); beside them the posted kernel's
  variants (``-D EPIK_POSTED_THREADS / _CELLS / _MIN_BLOCKS``): 128 and 512
  threads, 512 and 2,048 cells a tile, and no register budget. Then, at the
  same shapes, the posted gather with the finish fused in
  (``rowgather_sum_posted_topk``, the route where it fits) against the pair
  it stands for (the posted gather and ``finish_topk``), both through their
  wrappers, with the same variants of the fused kernel, each held to the
  pair's pack first (log_sum within rtol 1e-6), and each variant's blocks an
  SM.

Each variant is built by ``nvcc`` from this checkout's sources (the shipped
ones with ``-D`` overrides of their layout macros, or the variant source)
into ``build/sweep/``, loaded with ``ctypes`` and held bit-equal to the plain
version before it is timed. Prints the card line and one JSON object of
CUDA-event medians, each variant once and the first again last. Needs a CUDA
device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import chip_smoke
from chip_smoke import (
    AA_BATCH,
    BATCH,
    BT_BATCH,
    TIMING_REPS,
    card_line,
    check_finish,
    check_partial,
    cuda_ms,
    d652_fixture,
    fused_call,
    recording,
    unfused_pair,
)

CSRC = os.path.join("epik_tpu_torch", "kernels", "csrc")
TILES_SRC = os.path.join("kernel_variants", "accumulate_sums_tiles.cu")
#: the 1c variants: name -> (nvcc -D flags, locality order)
GATHER = {
    "slice256": ([], True),
    "slice128": (["-DEPIK_SLICE_LANES=8", "-DEPIK_SLICE_READS=32"], True),
    "slice512": (["-DEPIK_SLICE_LANES=32", "-DEPIK_SLICE_READS=8"], True),
    "slice256_read_order": ([], False),
}
#: the sorted block's variants: name -> nvcc -D flags
SORTED = {
    "sorted": [],
    "sorted_per_item": ["-DEPIK_SORT_PERSISTENT=0"],
    "sorted_chunk4096": ["-DEPIK_SORT_ITEMS=4"],
    "sorted_chunk6144": ["-DEPIK_SORT_ITEMS=6"],
    "sorted_bits4": ["-DEPIK_SORT_BITS=4"],
    "sorted_bits5": ["-DEPIK_SORT_BITS_SMALL=5"],
}
#: the owner-warp layouts: name -> (n_tiles, warps, cluster, bulk)
OWNERS = {
    "owners_1x32": (1, 32, 0, 0),
    "owners_2x8": (2, 8, 0, 0),
    "owners_2x8_bulk": (2, 8, 0, 1),
    "owners_4x8": (4, 8, 0, 0),
    "owners_4x8_bulk": (4, 8, 0, 1),
    "owners_4x8_bulk_cluster": (4, 8, 1, 1),
}
#: the row-pointer form's widths: name -> B
WIDTHS = {"config4": 19999, "wide_classic": 22199}
#: the 1d variants: name -> (nvcc -D flags, locality order)
SUM = {
    "sum_slice256": ([], True),
    "sum_slice256_read_order": ([], False),
    "sum_slice256_reads8_read_order": (["-DEPIK_SLICE_READS=8"], False),
    "sum_slice256_reads8": (["-DEPIK_SLICE_READS=8"], True),
    "sum_slice256_reads32": (["-DEPIK_SLICE_READS=32"], True),
    "sum_slice64": (["-DEPIK_SLICE_LANES=4", "-DEPIK_SLICE_READS=64"], True),
    "sum_slice128": (["-DEPIK_SLICE_LANES=8", "-DEPIK_SLICE_READS=32"], True),
    "sum_slice512": (["-DEPIK_SLICE_LANES=32", "-DEPIK_SLICE_READS=8"], True),
    "sum_slice256_min_blocks8": (["-DEPIK_SLICE_MIN_BLOCKS=8"], True),
}
#: the group layout's variants: name -> (nvcc -D flags, G or None for the
#: wrapper's choice, locality order)
GROUP = {
    "group": ([], None, True),
    "group_read_order": ([], None, False),
    "group_unroll4": (["-DEPIK_GROUP_UNROLL=4"], None, True),
    "group_unroll12": (["-DEPIK_GROUP_UNROLL=12"], None, True),
    "group_unroll16": (["-DEPIK_GROUP_UNROLL=16"], None, True),
    "group_g4_min_blocks2": (["-DEPIK_GROUP_MIN_BLOCKS=2"], 4, True),
    "group_g4_min_blocks4": (["-DEPIK_GROUP_MIN_BLOCKS=4"], 4, True),
    "group_g8_min_blocks2": (["-DEPIK_GROUP_MIN_BLOCKS=2"], 8, True),
    "group_g2_threads128_min_blocks6": (["-DEPIK_GROUP_THREADS=128",
                                         "-DEPIK_GROUP_MIN_BLOCKS=6"], 2, True),
}
#: the shifted group's variants: name -> (nvcc -D flags, G or None for the
#: wrapper's choice, the read order: "step" the step's (read order on pair
#: rows, else the locality order) or "other" the other of the two)
SHIFTED = {
    "shifted": ([], None, "step"),
    "shifted_other_order": ([], None, "other"),
    "shifted_g2": ([], 2, "step"),
    "shifted_g4": ([], 4, "step"),
    "shifted_g16_min_blocks2": (["-DEPIK_GROUP_MIN_BLOCKS=2"], 16, "step"),
    "shifted_min_blocks4": (["-DEPIK_GROUP_MIN_BLOCKS=4"], None, "step"),
    "shifted_min_blocks6": (["-DEPIK_GROUP_MIN_BLOCKS=6"], 4, "step"),
    "shifted_unroll4": (["-DEPIK_GROUP_UNROLL=4"], None, "step"),
    "shifted_unroll16": (["-DEPIK_GROUP_UNROLL=16"], None, "step"),
    "shifted_lanes16": (["-DEPIK_SHIFTED_LANES=16"], None, "step"),
    "shifted_lanes64": (["-DEPIK_SHIFTED_LANES=64"], None, "step"),
}
#: the width sweep: D652's plane columns cut or repeated to these widths
SHIFTED_WIDTHS = (1024, 1216, 1536, 1664, 1792, 1920, 2112, 2816, 5632, 11264, 19712)
#: cycles of ``torch.cuda._sleep`` queued ahead of a queued timing (~1 ms on
#: an H100, several times the host's work before a wrapper's launches)
AHEAD_CYCLES = 2_000_000
#: kernel A's variants: name -> nvcc -D flags
#: the posted gather's variants: name -> nvcc -D flags
POSTED = {
    "posted_256x1024": [],
    "posted_128_threads": ["-DEPIK_POSTED_THREADS=128"],
    "posted_512_threads": ["-DEPIK_POSTED_THREADS=512"],
    "posted_512_cells": ["-DEPIK_POSTED_CELLS=512"],
    "posted_2048_cells": ["-DEPIK_POSTED_CELLS=2048"],
    "posted_no_register_budget": ["-DEPIK_POSTED_MIN_BLOCKS=1"],
}
COLS = {
    "cols": [],
    "cols_wide_no_register_cap": ["-DEPIK_COLS_WIDE_MIN_BLOCKS=1"],
    "cols_512_threads": ["-DEPIK_COLS_SMALL=0"],
    "cols_small_no_register_cap": ["-DEPIK_COLS_SMALL_MIN_BLOCKS=1"],
}


def build(jobs: dict, out_dir: str) -> dict:
    """``jobs``: name -> (source, -D flags). One ``nvcc`` each, all at
    once, the source's own directory on the include path: name -> loaded
    library."""
    from epik_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, defines) in jobs.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *defines, "-shared", "-I", os.path.dirname(src), "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        with open(os.path.join(out_dir, f"{name}.ptxas.txt"), "w") as f:
            f.write(log)
        libs[name] = ctypes.CDLL(so)
    return libs


def queued_times(torch, fn, reps: int = TIMING_REPS, warmup: int = 3) -> tuple[float, float]:
    """(median device ms, median host us) of ``fn`` with the card kept busy
    ahead of it (``torch.cuda._sleep``): the start event runs when the queue
    ahead drains, by which time the host has enqueued ``fn``'s launches, so
    the events time the device's work alone, while the host's clock times
    the work in ``fn`` before it returns (its checks, its small PyTorch
    calls, the launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(AHEAD_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6)
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b))
    return statistics.median(device), statistics.median(host)


def parent_slots(torch, amb_read, R: int, dev):
    """The slot map the parent's group entry points take made by the caller,
    as its wrappers made it (inside the timed call, as this checkout's entry
    points make theirs): int32 (R,), each ambiguous read's row of the delta
    rows, else -1; None when no read has one."""
    if amb_read is None or amb_read.numel() == 0:
        return None
    slot = torch.full((R,), -1, dtype=torch.int32, device=dev)
    slot[amb_read] = torch.arange(amb_read.numel(), dtype=torch.int32, device=dev)
    return slot


def in_turns(torch, names, call, check) -> dict:
    """Each variant's CUDA-event median, the first one again last; ``check``
    (name) raises where a variant differs from the plain version."""
    times = {}
    for name in [*names, names[0]]:
        if name not in times:
            check(name)
        times.setdefault(name, []).append(cuda_ms(torch, lambda: call(name)))
    return times


def gather_times(torch, dev, out: dict) -> None:
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.kernels.rowgather import locality_order, rowgather_sum_counts_plain

    src = os.path.join(CSRC, "rowgather_sum.cu")
    builds = {n: (src, d) for n, (d, _) in GATHER.items() if n != "slice256_read_order"}
    libs = build(builds, os.path.join("build", "sweep", "gather"))
    libs["slice256_read_order"] = libs["slice256"]
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.epik_rowgather_sum_counts.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, vp]
    db, records = d652_fixture()
    tree = parse_newick(db.tree())
    for cell, fields, fused in (("f32", {"plane_mode": "classic"}, "rowgather_sum_counts_topk"),
                                ("bf16", {"precision": "bf16"},
                                 "rowgather_sum_counts_topk_bf16")):
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        calls = []
        with recording(step_mod, fused, calls, limit=1):
            placer.place(records[:BATCH])
        plane, rows = calls[0][0][:2]
        R, W = rows.shape
        bw = plane.shape[1]
        S = torch.empty((R, bw), device=dev)
        C = torch.empty((R, bw), dtype=torch.int32, device=dev)
        orders = {True: locality_order(rows),
                  False: torch.arange(R, dtype=torch.int32, device=dev)}
        S_p, C_p = rowgather_sum_counts_plain(plane, rows)
        code = 0 if cell == "f32" else 2

        def call(name):
            err = libs[name].epik_rowgather_sum_counts(
                plane.data_ptr(), code, rows.data_ptr(), orders[GATHER[name][1]].data_ptr(),
                S.data_ptr(), C.data_ptr(), R, W, bw, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def check(name):
            S.zero_()
            C.zero_()
            call(name)
            torch.cuda.synchronize()
            if not (torch.equal(S.view(torch.int32), S_p.view(torch.int32))
                    and torch.equal(C, C_p)):
                raise AssertionError(f"1c {name} ({cell}): not bit-equal")

        out[f"gather_{cell}"] = {"shape": [R, W, bw],
                                 "ms": in_turns(torch, list(GATHER), call, check)}
        del placer, calls, plane, rows, S, C, S_p, C_p
        torch.cuda.empty_cache()


def flat_batch(torch, np, dev, B: int, R: int = 4096):
    """Flat cells of R reads like the 400 bp batch's: b, s, ptr on ``dev``."""
    rng = np.random.default_rng(B)
    ptr = np.concatenate([[0], np.cumsum(rng.poisson(4433, R))]).astype(np.int64)
    n = int(ptr[-1])
    b = rng.integers(0, B, n).astype(np.int32)
    b[rng.random(n) < 0.02] = -(-B // 128) * 128 - 1  # the trash column
    s = rng.uniform(-4.0, -0.1, n).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (b, s, ptr))


def row_ptr_times(torch, np, dev, out: dict) -> None:
    from epik_tpu_torch.kernels.accumulate_sums import accumulate_sums_counts_csr_plain

    src = os.path.join(CSRC, "accumulate_sums.cu")
    jobs = {n: (src, d) for n, d in SORTED.items()}
    jobs["owners"] = (TILES_SRC, [])
    libs = build(jobs, os.path.join("build", "sweep", "row_ptr"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name in SORTED:
        libs[name].epik_accumulate_sums_csr.argtypes = [vp, vp, vp, vp, vp, i, i, vp]
    for name in SORTED:
        libs[name].epik_accumulate_sums_layout.argtypes = [i, i, i, ctypes.POINTER(i)]
    owners = libs["owners"].epik_accumulate_sums_csr_tiles
    owners.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
    for width, B in WIDTHS.items():
        b, s, ptr = flat_batch(torch, np, dev, B)
        R = ptr.numel() - 1
        S = torch.empty((R, B), device=dev)
        C = torch.empty((R, B), dtype=torch.int32, device=dev)
        S_p, C_p = accumulate_sums_counts_csr_plain(b, s, ptr, R=R, B=B)

        def call(name):
            head = (b.data_ptr(), s.data_ptr(), ptr.data_ptr(), S.data_ptr(), C.data_ptr(), R, B)
            stream = torch.cuda.current_stream().cuda_stream
            if name in SORTED:
                err = libs[name].epik_accumulate_sums_csr(*head, stream)
            else:
                err = owners(*head, *OWNERS[name], stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def check(name):
            S.zero_()
            C.zero_()
            call(name)
            torch.cuda.synchronize()
            if not (torch.equal(S.view(torch.int32), S_p.view(torch.int32))
                    and torch.equal(C, C_p)):
                raise AssertionError(f"row pointer {name} at B = {B}: not bit-equal")

        layouts = {}
        for name in SORTED:
            lay = (ctypes.c_int * 5)()
            if libs[name].epik_accumulate_sums_layout(B, 1, 1, lay):
                raise RuntimeError(f"{name}: no layout at B = {B}")
            layouts[name] = dict(zip(("tile_w", "n_tiles", "threads", "smem", "radix_bits"),
                                     lay))
        out[f"row_ptr_{width}"] = {
            "reads": R, "cells": int(ptr[-1]), "B": B, "sorted_layouts": layouts,
            "ms": in_turns(torch, [*SORTED, *OWNERS], call, check)}
        del b, s, ptr, S, C, S_p, C_p
        torch.cuda.empty_cache()


def sum_times(torch, dev, out: dict) -> None:
    """1d's variants on D652's pair rows and the wide shifted tree's rows."""
    import gc

    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.kernels.rowgather import locality_order, rowgather_sum_plain

    src = os.path.join(CSRC, "rowgather_sum.cu")
    builds = {}
    for name, (defines, _) in SUM.items():
        builds.setdefault(" ".join(defines), (name, (src, defines)))
    libs = build(dict(builds.values()), os.path.join("build", "sweep", "sum"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.epik_rowgather_sum.argtypes = [vp, i, vp, vp, vp, i, i, i, ctypes.c_float, vp]
    lib_of = {name: libs[builds[" ".join(d)][0]] for name, (d, _) in SUM.items()}

    def sweep(key, plane, rows, scale):
        R, W = rows.shape
        bw = plane.shape[1]
        S = torch.empty((R, bw), device=dev)
        perm = locality_order(rows)
        orders = {True: perm.data_ptr(), False: None}
        want = rowgather_sum_plain(plane, rows, scale)
        code = 0 if plane.dtype == torch.float32 else 1

        def call(name):
            err = lib_of[name].epik_rowgather_sum(
                plane.data_ptr(), code, rows.data_ptr(), orders[SUM[name][1]], S.data_ptr(),
                R, W, bw, float(scale or 1.0), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def check(name):
            S.zero_()
            call(name)
            torch.cuda.synchronize()
            if not torch.equal(S.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"1d {name} ({key}): not bit-equal")

        out[f"sum_{key}"] = {"shape": [R, W, bw], "distinct_rows": int(torch.unique(rows).numel()),
                             "ms": in_turns(torch, list(SUM), call, check)}

    db, records = d652_fixture()
    tree = parse_newick(db.tree())
    placer = TorchPlacer(db, tree, device=dev)
    calls = []
    with recording(step_mod, "rowgather_sum_topk", calls, limit=1):
        placer.place(records[:BATCH])
    sweep("d652_pair", *calls[0][0][:2], None)
    del placer, calls
    gc.collect()
    torch.cuda.empty_cache()
    db, ref = chip_smoke.wide_shifted_db()
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, chip_smoke.WS_BATCH, length=150, mutation_rate=0.02,
                                 seed=17)
    for cell, fields in (("f32", {}), ("int16", {"precision": "int16"})):
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        calls = []
        # the router's call: the f32 plane's step gathers its posted cells
        with recording(step_mod, "_shifted_finish", calls, limit=1):
            placer.place(reads)
        (plane, rows), kw = calls[0][0][:2], calls[0][1]
        sweep(f"wide_shifted_{cell}", plane, rows,
              kw["plane_scale"] if cell == "int16" else None)
        del placer, calls, plane, rows
        gc.collect()
        torch.cuda.empty_cache()


def cols_times(torch, np, dev, out: dict) -> None:
    """Kernel A's variants on D652's classic sums and counts and on synthetic
    rows at the wide classic and config 4's sharded widths."""
    import gc

    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.kernels.finish_cols import (
        finish_cols_partial_counts_plain,
        finish_cols_partial_plain,
    )
    from epik_tpu_torch.kernels.rowgather import rowgather_sum_counts
    from torch_fixtures import counts_rows, finish_rows

    src = os.path.join(CSRC, "finish_cols.cu")
    libs = build({n: (src, d) for n, d in COLS.items()}, os.path.join("build", "sweep", "cols"))
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for lib in libs.values():
        lib.epik_finish_cols_layout.argtypes = [i, i, i, ctypes.POINTER(i64)]
        lib.epik_finish_cols_partial.argtypes = [vp, i64, vp, i64, vp, vp, vp, i, i, i, i, i,
                                                 ctypes.c_float, vp, i, i, i64, vp]
    kw = dict(K=7, k=10, log_eps=-4.2597, col0=0)

    def sweep(key, S, C, m):
        R, bwl = S.shape
        out_t = torch.empty((R, 2 * kw["K"] + 3), device=dev)
        cnt = torch.empty((R, kw["K"]), dtype=torch.int32, device=dev)
        if C is None:
            want, want_c = finish_cols_partial_plain(S, m, **kw), None
        else:
            want, want_c = finish_cols_partial_counts_plain(S, C, m, **kw)
        layouts = {}
        for name, lib in libs.items():
            lay = (ctypes.c_int64 * 6)()
            if lib.epik_finish_cols_layout(bwl, kw["K"], int(C is not None), lay):
                raise RuntimeError(f"{name}: no layout at bwl = {bwl}")
            if lay[0]:
                raise ValueError(f"bwl = {bwl}: the sweep takes 16-bit ids only")
            layouts[name] = dict(zip(("global_ids", "threads", "cache", "smem", "limit",
                                      "blocks_per_sm"), lay))

        def call(name):
            lay = layouts[name]
            err = libs[name].epik_finish_cols_partial(
                S.data_ptr(), S.stride(0), C.data_ptr() if C is not None else None,
                C.stride(0) if C is not None else 0, m.data_ptr(), out_t.data_ptr(),
                cnt.data_ptr() if C is not None else None, R, bwl, kw["K"], 0, kw["k"],
                kw["log_eps"], None, R, lay["cache"], lay["smem"],
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def check(name):
            out_t.zero_()
            call(name)
            torch.cuda.synchronize()
            got, exp = out_t.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(got[:, :-1], exp[:, :-1], err_msg=f"{name} ({key})")
            np.testing.assert_allclose(got[:, -1], exp[:, -1], rtol=1e-6, atol=0.0,
                                       err_msg=f"{name} ({key})")
            if C is not None and not torch.equal(cnt, want_c):
                raise AssertionError(f"kernel A {name} ({key}): counts differ")

        touched = (C > 0) if C is not None else (S > 0)
        out[f"cols_{key}"] = {"shape": [R, bwl], "counts": C is not None,
                              "touched_mean": float(touched.sum(dim=1).float().mean()),
                              "layouts": layouts,
                              "ms": in_turns(torch, list(COLS), call, check)}

    db, records = d652_fixture()
    placer = TorchPlacer(db, parse_newick(db.tree()), config=PlacerConfig(plane_mode="classic"),
                         device=dev)
    calls = []
    with recording(step_mod, "rowgather_sum_counts_topk", calls, limit=1):
        placer.place(records[:BATCH])
    plane, rows, m = calls[0][0][:3]
    S, C = rowgather_sum_counts(plane, rows)
    sweep("d652_classic", S, C, m)
    del placer, calls, plane, rows, S, C
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(22272)
    S_b, C_b, m_b = counts_rows(rng, 4096, 22199, density=0.07)
    S = np.zeros((4096, 22272), np.float32)
    C = np.zeros((4096, 22272), np.int32)
    S[:, :22199], C[:, :22199] = S_b, C_b
    sweep("wide_classic_synthetic", *(torch.from_numpy(x).to(dev) for x in (S, C, m_b)))
    Sp, m_b = finish_rows(rng, 4096, 20096, density=0.077)
    sweep("config4_shifted_synthetic", torch.from_numpy(Sp).to(dev), None,
          torch.from_numpy(m_b).to(dev))


def group_times(torch, np, dev, out: dict, parent: str | None) -> None:
    """The group layout's variants (and the parent's fused counts kernels) on
    D652's classic rows with their first hits: 1b in f32 and bf16, 1f on the
    f32 rows as one shard."""
    import gc

    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.kernels import rowgather as rg
    from epik_tpu_torch.kernels._build import _PROTOTYPES

    src = os.path.join(CSRC, "rowgather_sum.cu")
    builds = {}
    for name, (defines, _, _) in GROUP.items():
        builds.setdefault(" ".join(defines), (name, (src, defines)))
    jobs = dict(builds.values())
    if parent is not None:
        jobs["parent"] = (os.path.join(parent, CSRC, "rowgather_sum.cu"), [])
    libs = build(jobs, os.path.join("build", "sweep", "group"))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in jobs:
        lib = libs[name]
        if name == "parent":  # the parent's entry points: the slot map made by the caller
            lib.epik_rowgather_sum_counts_topk.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, i,
                                                           i, i, i, i, i, f, i, vp]
            lib.epik_rowgather_sum_counts_cols.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i,
                                                           i, i, i, i, i, f, i, vp]
            continue
        for fn_name in ("epik_rowgather_sum_counts_topk", "epik_rowgather_sum_counts_cols"):
            getattr(lib, fn_name).argtypes = _PROTOTYPES[fn_name]
        lib.epik_rowgather_counts_group_smem.argtypes = [i, i, i, i]
        lib.epik_rowgather_counts_group_smem.restype = ctypes.c_longlong
        lib.epik_rowgather_group_smem_limit.restype = ctypes.c_longlong
        lib.epik_rowgather_counts_group_blocks_per_sm.argtypes = [i] * 6
    lib_of = {name: libs[builds[" ".join(d)][0]] for name, (d, _, _) in GROUP.items()}
    if parent is not None:
        lib_of["parent"] = libs["parent"]
    db, records = d652_fixture()
    tree = parse_newick(db.tree())
    for cell, fields, fused in (("f32", {"plane_mode": "classic"}, "rowgather_sum_counts_topk"),
                                ("bf16", {"precision": "bf16"},
                                 "rowgather_sum_counts_topk_bf16")):
        placer = TorchPlacer(db, tree, config=PlacerConfig(**fields), device=dev)
        calls = []
        with recording(step_mod, fused, calls, limit=1):
            placer.place(records[:BATCH])
        (plane, rows, m, reads, dS, hit), kw = calls[0]
        if reads is None:
            raise AssertionError(f"D652 {cell}: the first batch has no first hits")
        R, W = rows.shape
        bw, B, K = plane.shape[1], kw["B"], kw["K"]
        orders = {True: rg.locality_order(rows),
                  False: torch.arange(R, dtype=torch.int32, device=dev)}
        code = 0 if cell == "f32" else 2
        forms = {"topk": (B, K, rg.rowgather_sum_counts_topk_plain(plane, rows, m, reads, dS, hit,
                                                                  **kw))}
        if cell == "f32":
            dS_w = torch.zeros((dS.shape[0], bw), device=dev)
            hit_w = torch.zeros((dS.shape[0], bw), dtype=torch.bool, device=dev)
            dS_w[:, :B], hit_w[:, :B] = dS, hit
            ckw = dict(K=K, k=kw["k"], log_eps=kw["log_eps"], col0=0)
            forms["cols"] = (bw, min(K, bw), rg.rowgather_sum_counts_cols_plain(
                plane, rows, m, reads, dS_w, hit_w, **ckw))
        for form, (Bf, Kf, want) in forms.items():
            limit = lib_of["group"].epik_rowgather_group_smem_limit()
            G_of = {name: (g or rg.counts_group(bw, Bf, Kf, limit))
                    for name, (_, g, _) in GROUP.items()}
            out_t = torch.empty((R, 4 * Kf + 2 if form == "topk" else 2 * Kf + 3), device=dev)
            cnt = torch.empty((R, Kf), dtype=torch.int32, device=dev)
            dS_f, hit_f = (dS, hit) if form == "topk" else (dS_w, hit_w)
            amb, held = rg._amb_args(reads, dS_f, R, dev)  # held: the kernels read them
            stream = torch.cuda.current_stream().cuda_stream

            def call(name):
                lib = lib_of[name]
                # the parent's kernels take the shipped variant's order and G
                perm = orders[GROUP["group" if name == "parent" else name][2]].data_ptr()
                G = G_of["group" if name == "parent" else name]
                if name == "parent":  # its entry points take the slot map made by the caller
                    slot = parent_slots(torch, reads, R, dev)
                    ambs = (slot.data_ptr(), dS_f.data_ptr(), hit_f.data_ptr())
                else:
                    ambs = (*amb, hit_f.data_ptr())
                err = (lib.epik_rowgather_sum_counts_topk(
                    plane.data_ptr(), code, rows.data_ptr(), perm, m.data_ptr(), *ambs,
                    out_t.data_ptr(), R, W, bw, Bf, Kf, kw["k"], kw["log_eps"], G, stream)
                    if form == "topk" else lib.epik_rowgather_sum_counts_cols(
                    plane.data_ptr(), rows.data_ptr(), perm, m.data_ptr(), *ambs,
                    out_t.data_ptr(), cnt.data_ptr(), R, W, bw, Kf, 0, kw["k"],
                    kw["log_eps"], G, stream))
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            def check(name):
                out_t.zero_()
                call(name)
                torch.cuda.synchronize()
                got = out_t.cpu().numpy()
                if form == "topk":
                    w = want.cpu().numpy()
                    np.testing.assert_array_equal(got[:, :Kf], w[:, :Kf], err_msg=name)
                    np.testing.assert_array_equal(got[:, 2 * Kf:], w[:, 2 * Kf:], err_msg=name)
                    np.testing.assert_allclose(got[:, Kf:2 * Kf], w[:, Kf:2 * Kf], rtol=1e-4,
                                               atol=1e-30, err_msg=name)
                else:
                    w = want[0].cpu().numpy()
                    np.testing.assert_array_equal(got[:, :-1], w[:, :-1], err_msg=name)
                    np.testing.assert_allclose(got[:, -1], w[:, -1], rtol=1e-6, atol=0.0,
                                               err_msg=name)
                    if not torch.equal(cnt, want[1]):
                        raise AssertionError(f"1f {name}: counts differ")

            names = [*GROUP, *(["parent"] if parent is not None else [])]
            layouts = {}
            for name in GROUP:
                lib, G = lib_of[name], G_of[name]
                layouts[name] = {
                    "G": G, "smem": lib.epik_rowgather_counts_group_smem(G, bw, Bf, Kf),
                    "blocks_per_sm": lib.epik_rowgather_counts_group_blocks_per_sm(
                        G, bw, Bf, Kf, code, int(form == "cols"))}
            out[f"group_{form}_{cell}"] = {"shape": [R, W, bw], "B": Bf, "layouts": layouts,
                                           "ms": in_turns(torch, names, call, check)}
        del placer, calls, plane, rows, m, reads, dS, hit, forms
        gc.collect()
        torch.cuda.empty_cache()


def _cols_call(torch, call, B: int):
    """A recorded fused shifted call (:func:`chip_smoke.fused_call`) as the
    call of the column kernel on the same plane as one shard (col0 = 0, B =
    bwl): the delta rows padded to the plane's width."""
    (plane, rows, m, amb_read, delta), kw = call
    if delta is not None:
        wide = torch.zeros((delta.shape[0], plane.shape[1]), device=delta.device)
        wide[:, :B] = delta
        delta = wide
    ckw = {n: kw[n] for n in ("K", "k", "log_eps", "pair_rows")}
    return (plane, rows, m, amb_read, delta), dict(ckw, col0=0)


def _widened(torch, call, bw: int):
    """D652's unpaired call over its plane's columns cut to ``bw`` columns,
    or repeated and cut, B = bw - 105 (each whole copy's 105 padding columns
    but the last's fall inside B), the delta rows cut or repeated likewise."""
    (plane, rows, m, amb_read, delta), kw = call
    bw0, B0 = plane.shape[1], kw["B"]
    r = -(-bw // bw0)
    wide = plane.repeat(1, r)[:, :bw].contiguous()
    B = bw - (bw0 - B0)
    d = None
    if delta is not None:
        d = torch.zeros((delta.shape[0], B), device=delta.device)
        for c in range(r):
            lo, hi = bw0 * c, min(bw0 * c + B0, B)
            if hi > lo:
                d[:, lo:hi] = delta[:, :hi - lo]
    return (wide, rows, m, amb_read, d), dict(kw, B=B)


def shifted_times(torch, np, dev, out: dict, parent: str | None) -> None:
    """The fused shifted kernels' variants, their unfused pairs and the
    parent's kernels on the paths' rows, then over D652's widened plane."""
    import gc

    from epik_tpu_torch import kernels as kernels_mod
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference
    from epik_tpu_torch.kernels import rowgather as rg
    from epik_tpu_torch.kernels._build import _PROTOTYPES
    from epik_tpu_torch.parallel import sharding as sh_mod
    from epik_tpu_torch.parallel.mesh import make_mesh

    src = os.path.join(CSRC, "rowgather_sum.cu")
    builds = {}
    for name, (defines, _, _) in SHIFTED.items():
        builds.setdefault(" ".join(defines), (name, (src, defines)))
    jobs = dict(builds.values())
    if parent is not None:
        jobs["parent"] = (os.path.join(parent, CSRC, "rowgather_sum.cu"), [])
    libs = build(jobs, os.path.join("build", "sweep", "shifted"))
    vp, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    for name, lib in libs.items():
        if name == "parent":  # the parent's entry points: the slot map made by the caller
            lib.epik_rowgather_sum_topk.argtypes = [vp, i, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                                    f, f, vp]
            lib.epik_rowgather_sum_cols.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, f,
                                                    vp]
            continue
        for fn_name in ("epik_rowgather_sum_topk", "epik_rowgather_sum_cols",
                        "epik_rowgather_shifted_group_smem", "epik_rowgather_group_smem_limit",
                        "epik_rowgather_shifted_group_blocks_per_sm"):
            getattr(lib, fn_name).argtypes = _PROTOTYPES[fn_name]
        lib.epik_rowgather_shifted_group_smem.restype = ll
        lib.epik_rowgather_group_smem_limit.restype = ll
    lib_of = {name: libs[builds[" ".join(d)][0]] for name, (d, _, _) in SHIFTED.items()}
    if parent is not None:
        lib_of["parent"] = libs["parent"]
    limit = lib_of["shifted"].epik_rowgather_group_smem_limit()
    every = [*SHIFTED, "fused", "pair", *(["parent"] if parent is not None else [])]

    def sweep(key, call, cols, names=every):
        """Each of ``names`` on a fused shifted call ((plane, rows, m, amb_read,
        delta), keywords), the column form where ``cols``, held against the
        plain version, then timed in turns; then the shipped wrapper
        ("fused") and the unfused pair in turns again with the card busy
        ahead of them (:func:`queued_times`)."""
        (plane, rows, m, amb_read, delta), kw = call
        R, W = rows.shape
        bw = plane.shape[1]
        B = bw if cols else kw["B"]
        K = min(kw["K"], bw)
        pair_rows = kw.get("pair_rows", False)
        scale = float(kw.get("scale") or 1.0)
        code = 0 if plane.dtype == torch.float32 else 1
        amb, held = rg._amb_args(amb_read, delta, R, dev)  # held: the kernels read them
        order = rg.locality_order(rows)  # held: the kernels read it
        perm_of = {"step": None if pair_rows else order.data_ptr(),
                   "other": order.data_ptr() if pair_rows else None}
        pkw = {n: v for n, v in kw.items() if n != "pair_rows"}
        plain = rg.rowgather_sum_cols_plain if cols else rg.rowgather_sum_topk_plain
        want = plain(plane, rows, m, amb_read, delta, **pkw)
        out_t = torch.empty((R, 2 * K + 3), device=dev)
        G_of = {name: g or rg.shifted_group(bw, B, K, limit)
                for name, (_, g, _) in SHIFTED.items()}
        pair = unfused_pair(kernels_mod, call, cols)
        wrapper = (rg.rowgather_sum_cols if cols else rg.rowgather_sum_topk_int16 if code
                   else rg.rowgather_sum_topk)
        wkw = {n: v for n, v in kw.items() if cols or code or n != "scale"}
        stream = torch.cuda.current_stream().cuda_stream
        head = (plane.data_ptr(), rows.data_ptr())
        tail = (out_t.data_ptr(), R, W, bw)

        def run(name):
            if name == "pair":
                return pair()
            if name == "fused":
                return wrapper(plane, rows, m, amb_read, delta, **wkw)
            lib = lib_of[name]
            if name == "parent":
                slot = parent_slots(torch, amb_read, R, dev)  # its entry points take the map
                amb_p = (m.data_ptr(), *((slot.data_ptr(), delta.data_ptr()) if slot is not None
                                         else (None, None)), *tail)
                err = (lib.epik_rowgather_sum_cols(*head, *amb_p, K, kw["col0"], kw["k"],
                                                   kw["log_eps"], stream) if cols else
                       lib.epik_rowgather_sum_topk(head[0], code, head[1], *amb_p, B, K, kw["k"],
                                                   kw["log_eps"], scale, stream))
            else:
                perm = perm_of[SHIFTED[name][2]]
                err = (lib.epik_rowgather_sum_cols(*head, perm, m.data_ptr(), *amb, *tail, K,
                                                   kw["col0"], kw["k"], kw["log_eps"],
                                                   G_of[name], stream) if cols
                       else lib.epik_rowgather_sum_topk(head[0], code, head[1], perm,
                                                        m.data_ptr(), *amb, *tail, B, K,
                                                        kw["k"], kw["log_eps"], scale,
                                                        G_of[name], stream))
            if err:
                raise RuntimeError(f"{name} ({key}): CUDA error {err}")
            return out_t

        def check(name):
            out_t.zero_()
            got = run(name)
            torch.cuda.synchronize()
            what = f"{name} ({key})"
            if cols:
                check_partial(np, got, want, what)
            else:
                check_finish(np, got.cpu().numpy(), want.cpu().numpy(), K, B, what)

        layouts = {name: {"G": G_of[name],
                          "smem": lib_of[name].epik_rowgather_shifted_group_smem(G_of[name], bw,
                                                                               B, K),
                          "blocks_per_sm": lib_of[name].epik_rowgather_shifted_group_blocks_per_sm(
                              G_of[name], bw, B, K, code, int(cols))}
                   for name in SHIFTED if name in names}
        queued = {}
        for name in ("fused", "pair", "pair", "fused"):
            dev_ms, host_us = queued_times(torch, lambda: run(name))
            queued.setdefault(name, {"device_ms": [], "host_us": []})
            queued[name]["device_ms"].append(dev_ms)
            queued[name]["host_us"].append(host_us)
        out[f"shifted_{key}"] = {
            "shape": [R, W, bw], "B": B, "cols": cols, "pair_rows": pair_rows,
            "amb_reads": 0 if amb_read is None else int(amb_read.numel()),
            "distinct_rows": int(torch.unique(rows).numel()), "layouts": layouts,
            "ms": in_turns(torch, list(names), run, check), "queued": queued}
        log_line = {n: min(t) for n, t in out[f"shifted_{key}"]["ms"].items()}
        log_line.update({f"{n}_queued": min(q["device_ms"]) for n, q in queued.items()})
        log_line.update({f"{n}_host_us": min(q["host_us"]) for n, q in queued.items()})
        print(f"shifted {key}: {log_line}", flush=True)
        del held

    def recorded(placer, records, module=step_mod, name="_shifted_finish"):
        calls = []
        with recording(module, name, calls, limit=1):
            placer.place(records)
        return calls[0]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    few = ["shifted", "fused", "pair", *(["parent"] if parent is not None else [])]
    db, records = d652_fixture()
    tree = parse_newick(db.tree())
    placer = TorchPlacer(db, tree, device=dev)
    call = fused_call(torch, recorded(placer, records[:BATCH]))
    sweep("d652_pair", call, False)
    sweep("d652_sharded_1x1", _cols_call(torch, call, call[1]["B"]), True)
    del placer, call
    free()
    for n_model in (4, 2):  # shards of 384 and 768 columns
        placer = sh_mod.ShardedTorchPlacer(db, tree, make_mesh(n_data=1, n_model=n_model,
                                                               devices=[dev] * n_model))
        call = recorded(placer, records[:BATCH], sh_mod, "_shifted_cols")
        sweep(f"d652_sharded_1x{n_model}", call, True)
        del placer, call
        free()
    placer = TorchPlacer(db, tree, config=PlacerConfig(precision="int16"), device=dev)
    call = fused_call(torch, recorded(placer, records[:BATCH]))
    sweep("d652_unpaired_int16", call, False)
    del placer, call
    free()
    placer = TorchPlacer(db, tree, config=PlacerConfig(pair_plane="off"), device=dev)
    call = fused_call(torch, recorded(placer, records[:BATCH]))
    del placer
    sweep("d652_unpaired_f32", call, False)
    for bw in SHIFTED_WIDTHS:
        wide = _widened(torch, call, bw)
        sweep(f"d652_bw{bw}", wide, False, few)
        sweep(f"d652_bw{bw}_cols", _cols_call(torch, wide, wide[1]["B"]), True, few)
        del wide
        free()
    del call
    free()
    db, aa_records = chip_smoke.config2_fixture()
    placer = TorchPlacer(db, parse_newick(db.tree()), device=dev)
    call = fused_call(torch, recorded(placer, aa_records[:AA_BATCH]))
    sweep("config2", call, False)
    del placer, call
    free()
    db, ref = chip_smoke.bigtree_db()
    placer = TorchPlacer(db, parse_newick(db.tree()), device=dev)
    reads = reads_from_reference(ref, BT_BATCH, length=150, mutation_rate=0.02, seed=11)
    call = fused_call(torch, recorded(placer, reads))
    del placer
    sweep("config4", call, False, few + ["shifted_other_order"])
    sweep("config4_cols", _cols_call(torch, call, call[1]["B"]), True,
          few + ["shifted_other_order"])
    del call
    free()


def posted_times(torch, np, dev, out: dict) -> None:
    """The posted gather and 1d through their wrappers and the posted
    kernel's variants, in turns, at the wol10k cell's and config 4's
    shapes; then the fused posted gather and the pair through their wrappers
    and the fused kernel's variants, in turns, at the same shapes."""
    import gc

    from epik_tpu_torch.kernels._build import library
    from epik_tpu_torch.kernels.finish import finish_topk
    from epik_tpu_torch.kernels.rowgather import (
        rowgather_sum,
        rowgather_sum_posted,
        rowgather_sum_posted_topk,
    )

    src = os.path.join(CSRC, "rowgather_posted.cu")
    libs = build({n: (src, d) for n, d in POSTED.items()}, os.path.join("build", "sweep",
                                                                          "posted"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.epik_rowgather_sum_posted.argtypes = [vp, vp, vp, vp, i, i, i, vp]
        lib.epik_rowgather_posted_blocks_per_sm.argtypes = [i]
        lib.epik_rowgather_sum_posted_topk.argtypes = [vp, vp, vp, vp, vp, i, i, vp, vp, vp, i,
                                                       i, i, i, i, i, ctypes.c_float, vp]
        lib.epik_rowgather_posted_topk_blocks_per_sm.argtypes = [i, i]
    for key, shape in (("wol10k", dict(bw=21_248, B=21_149, R=2000, W=141)),
                       ("config4", dict(bw=20_096, B=19_999, R=4096, W=143))):
        plane, posted, rows, build_s = chip_smoke.wol10k_shaped(torch, np, dev, **shape)
        R, W = rows.shape
        bw = plane.shape[1]
        S = torch.empty((R, bw), device=dev)
        want = rowgather_sum(plane, rows)

        def call(name):
            if name == "1d":
                return rowgather_sum(plane, rows)
            if name == "posted":
                return rowgather_sum_posted(posted.off, posted.cells, rows, bw=bw)
            err = libs[name].epik_rowgather_sum_posted(
                posted.off.data_ptr(), posted.cells.data_ptr(), rows.data_ptr(), S.data_ptr(),
                R, W, bw, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return S

        def check(name):
            S.zero_()
            got = call(name)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} ({key}): not bit-equal to 1d")

        names = ["1d", "posted", *POSTED, "posted", "1d"]
        times = {}
        for name in names:
            if name not in times:
                check(name)
            times.setdefault(name, []).append(cuda_ms(torch, lambda: call(name)))
        out[f"posted_{key}"] = {
            "shape": [R, W, bw], "nnz": posted.nnz, "index_bytes": posted.nbytes,
            "build_s": build_s, "ms": times,
            "blocks_per_sm": {n: lib.epik_rowgather_posted_blocks_per_sm(bw)
                              for n, lib in libs.items()},
            "shipped_blocks_per_sm": library().epik_rowgather_posted_blocks_per_sm(bw)}
        del S, want
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the finish fused in, against the pair ---------------------------------
        B, K = shape["B"], 7
        m = torch.full((R,), float(W), device=dev)
        fkw = dict(K=K, k=10, log_eps=-4.2597)
        pack = torch.empty((R, 2 * K + 3), device=dev)

        def pair():
            return finish_topk(rowgather_sum_posted(posted.off, posted.cells, rows,
                                                    bw=bw)[:, :B], m, **fkw)

        want = pair().cpu().numpy()

        def fused(name):
            if name == "pair":
                return pair()
            if name == "posted_topk":
                return rowgather_sum_posted_topk(posted.off, posted.cells, rows, m, None, None,
                                                 bw=bw, B=B, **fkw)
            err = libs[name].epik_rowgather_sum_posted_topk(
                posted.off.data_ptr(), posted.cells.data_ptr(), rows.data_ptr(), m.data_ptr(),
                None, 0, 0, None, None, pack.data_ptr(), R, W, bw, B, K, 10, -4.2597,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return pack

        names = ["pair", "posted_topk", *POSTED, "posted_topk", "pair"]
        times = {}
        for name in names:
            if name not in times:
                pack.zero_()
                got = fused(name).cpu().numpy()
                check_finish(np, got, want, K, B, f"{name} ({key}) against the pair")
            times.setdefault(name, []).append(cuda_ms(torch, lambda: fused(name)))
        out[f"posted_topk_{key}"] = {
            "shape": [R, W, bw, B], "ms": times,
            "blocks_per_sm": {n: lib.epik_rowgather_posted_topk_blocks_per_sm(bw, B)
                              for n, lib in libs.items()},
            "shipped_blocks_per_sm": library().epik_rowgather_posted_topk_blocks_per_sm(bw, B)}
        del plane, posted, rows, m, pack
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("gather", "row_ptr", "sum", "cols", "group", "shifted",
                                       "posted"),
                    default=None, help="sweep one kernel only")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: its fused kernels join the group "
                         "and the shifted sweeps' turns")
    args = ap.parse_args(argv)
    sys.path.insert(0, chip_smoke.REPO)
    sys.path.insert(0, os.path.join(chip_smoke.REPO, "tests"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    os.chdir(chip_smoke.REPO)
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0)}
    if args.only in (None, "row_ptr"):
        row_ptr_times(torch, np, dev, out)
    if args.only in (None, "gather"):
        gather_times(torch, dev, out)
    if args.only in (None, "cols"):
        cols_times(torch, np, dev, out)
    if args.only in (None, "sum"):
        sum_times(torch, dev, out)
    if args.only in (None, "group"):
        group_times(torch, np, dev, out, args.parent)
    if args.only in (None, "shifted"):
        shifted_times(torch, np, dev, out, args.parent)
    if args.only in (None, "posted"):
        posted_times(torch, np, dev, out)
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
