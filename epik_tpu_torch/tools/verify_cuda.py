"""One-shot parity verification of the port on the card.

Ports ``epik_tpu/tools/verify_tpu.py``: runs the built-in ppdiff cases
(``tools/ppdiff.py``), then a 300-read mixed workload through every engine
of the port against the scalar oracle, jplace_diff at 1e-4 in probability
space (the reference's semantic diff), and prints exactly ONE JSON line on
stdout:

    {"verify": "cuda", "backend": "cuda"|"cpu", "cases_passed": N,
     "cases_total": N, "reads_matched": M, "reads_total": T, "mixed": {...},
     "ok": bool}

The engines, each the port's counterpart of the JAX tool's (:98-110,
:143-146): the torch placer on the shifted plane (its default), the classic
plane and the int16 plane; the posting tiles; the sharded placer on a 1x1
mesh, dense and on the tiles; amino through the codes tokenizer and the
radix lookup, unpaired and on the pair plane. Every device engine runs on
``--platform`` (``cuda`` unless ``cpu`` is asked for); without a card,
``cuda`` raises rather than falls back.

Usage: python -m epik_tpu_torch.tools.verify_cuda [--workdir DIR] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _mixed_case_reads(db, n=300):
    """Mixed workload: db-derived reads, mutations, ambiguity, quirk cases."""
    import numpy as np

    from ..core.alphabet import get_alphabet
    from ..io.build import random_reads

    alphabet = get_alphabet(db.sequence_type)
    rng = np.random.default_rng(99)
    reads = []
    for i in range(n - 20):
        parts = [
            alphabet.decode_key(int(db.keys[rng.integers(db.num_kmers)]), db.kmer_size)
            for _ in range(int(rng.integers(2, 16)))
        ]
        reads.append((f"q{i}", "".join(parts).encode()))
    reads += random_reads(10, length=80, seed=101, ambig_rate=0.1)
    # quirk cases: short reads (Q1), duplicates (Q8), no-hit (Q2/Q3)
    reads += [("short_a", b"AC"), ("short_b", b"A"),
              ("dup_1", b"ACGTACGTACGTACGT"), ("dup_2", b"ACGTACGTACGTACGT"),
              ("nohit", b"T" * 40)]
    return reads


def _place_and_diff(engines, reads, nwk, workdir: str, prefix: str, mixed: dict) -> bool:
    """Each engine's jplace of ``reads`` against the first (the oracle's);
    fills ``mixed`` and returns whether every diff is clean."""
    from ..io.jplace import jplace_writer
    from .jplace_diff import jplace_diff

    paths = {}
    for name, engine in engines:
        out = engine.place(reads)
        path = os.path.join(workdir, f"{prefix}_{name}.jplace")
        w = jplace_writer(path, f"verify_cuda {prefix} {name} ", nwk)
        w.start()
        w << out
        w.end()
        paths[name] = path
    clean = True
    for name in list(paths)[1:]:
        res = jplace_diff(paths["oracle"], paths[name])
        print(f"{prefix} {name}: {res.num_matches}/{res.num_seqs} match", file=sys.stderr)
        mixed[name] = {"matched": res.num_matches, "total": res.num_seqs}
        clean &= res.clean
    return clean


def main(argv=None) -> int:
    from .ppdiff import default_workdir

    ap = argparse.ArgumentParser(description="on-card parity verification")
    ap.add_argument("--workdir", default=default_workdir("epik_tpu_torch_verify"))
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="device of every engine but the oracle [default: cuda]")
    args = ap.parse_args(argv)

    import copy

    import torch

    from ..core.tree import parse_newick, to_newick
    from ..engine.config import PlacerConfig
    from ..engine.placer import TorchPlacer
    from ..engine.reference import ReferencePlacer
    from ..io.build import random_db
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import ShardedTorchPlacer
    from .ppdiff import DEFAULT_CONFIG, run_case

    platform = args.platform
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("verify_cuda: no CUDA device (ask for --platform cpu)")
    dev = torch.device(platform)
    os.makedirs(args.workdir, exist_ok=True)

    # --- built-in ppdiff cases (sharded-4x2's slots laid on the platform) ----
    cases_passed = 0
    cases = copy.deepcopy(DEFAULT_CONFIG["cases"])
    for case in cases:
        clean, msg = run_case(case, args.workdir, platform)
        print(("PASS " if clean else "FAIL ") + msg, file=sys.stderr)
        cases_passed += int(clean)

    # --- 300-read mixed case vs the scalar oracle ----------------------------
    db = random_db(num_leaves=128, kmer_size=8, num_kmers=30000, seed=77)
    tree = parse_newick(db.tree())
    reads = _mixed_case_reads(db)
    nwk = to_newick(tree, jplace_edges=True)
    mesh11 = make_mesh(n_data=1, n_model=1, devices=[dev])
    tiles = PlacerConfig(dense_db="off", accumulate="matmul")
    engines = [
        ("oracle", ReferencePlacer(db, tree)),
        ("torch", TorchPlacer(db, tree, device=dev)),
        ("torch_classic", TorchPlacer(db, tree, config=PlacerConfig(plane_mode="classic"),
                                      device=dev)),
        ("torch_int16", TorchPlacer(db, tree, config=PlacerConfig(precision="int16"),
                                    device=dev)),
        ("torch_tiles", TorchPlacer(db, tree, config=tiles, device=dev)),
        ("sharded_1x1", ShardedTorchPlacer(db, tree, mesh11)),
        ("sharded_tiles_1x1", ShardedTorchPlacer(db, tree, mesh11, config=tiles)),
    ]
    mixed = {}
    all_clean = _place_and_diff(engines, reads, nwk, args.workdir, "mixed", mixed)
    del engines

    # --- amino mixed case: the codes tokenizer and radix lookup vs the oracle --
    amb_db = random_db(num_leaves=64, kmer_size=6, num_kmers=12000, seed=88,
                       sequence_type="amino")
    amb_tree = parse_newick(amb_db.tree())
    amb_engines = [
        ("oracle", ReferencePlacer(amb_db, amb_tree)),
        ("torch_amino", TorchPlacer(amb_db, amb_tree, device=dev)),
        ("torch_amino_pair", TorchPlacer(amb_db, amb_tree,
                                         config=PlacerConfig(pair_plane="on"), device=dev)),
    ]
    all_clean &= _place_and_diff(amb_engines, _mixed_case_reads(amb_db, n=300),
                                 to_newick(amb_tree, jplace_edges=True), args.workdir,
                                 "amino", mixed)

    ok = cases_passed == len(cases) and all_clean
    print(json.dumps({
        "verify": "cuda",
        "backend": platform,
        "cases_passed": cases_passed,
        "cases_total": len(cases),
        "reads_matched": sum(m["matched"] for m in mixed.values()),
        "reads_total": sum(m["total"] for m in mixed.values()),
        "mixed": mixed,
        "ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
