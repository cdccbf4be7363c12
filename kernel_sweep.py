#!/usr/bin/env python3
"""Layout variants of two of the port's kernels, timed in turns on one card:

    python3 kernel_sweep.py [--only gather|row_ptr]

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
import subprocess
import sys

import chip_smoke
from chip_smoke import BATCH, card_line, cuda_ms, d652_fixture, recording

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


def build(jobs: dict, out_dir: str) -> dict:
    """``jobs``: name -> (source, -D flags). One ``nvcc`` each, all at
    once: name -> loaded library."""
    from epik_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, defines) in jobs.items():
        so = os.path.join(out_dir, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *defines, "-shared", "-I", CSRC, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(so)
    return libs


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("gather", "row_ptr"), default=None,
                    help="sweep one kernel only")
    args = ap.parse_args(argv)
    sys.path.insert(0, chip_smoke.REPO)
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
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
