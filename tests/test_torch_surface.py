"""The place surface that ``TorchPlacer`` and ``ShardedTorchPlacer`` share
(``engine/surface.py::PlacerSurface``), held alike for both engines on the
CPU, the sharded one on a 1x1 mesh: an empty batch, one read under several
names, a CSR budget retry, a two-level tiles OV retry and the ``place.*``
spans, each batch against the scalar oracle (score sets within 1e-4).
"""

import numpy as np
import pytest
import torch

from epik_tpu_torch.core.alphabet import DNA
from epik_tpu_torch.core.tree import parse_newick
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.reference import ReferencePlacer
from epik_tpu_torch.io.build import build_db, reads_from_reference, reference_like_db
from epik_tpu_torch.io.db import PhyloKmerDB
from epik_tpu_torch.parallel.mesh import make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from epik_tpu_torch.utils import spans
from test_torch_placer import assert_jplace_close

ENGINES = ["single", "sharded"]
CASES = ["empty", "duplicates", "csr_retry", "tiles_retry", "spans"]


def _placer(engine, db, tree, **cfg):
    config = PlacerConfig(**cfg)
    if engine == "single":
        return TorchPlacer(db, tree, config=config, device="cpu")
    mesh = make_mesh(1, 1, devices=[torch.device("cpu")])
    return ShardedTorchPlacer(db, tree, mesh, config=config)


@pytest.fixture(scope="module")
def small():
    """48 leaves, k=8, 101 bp reads, a short read and a read with no hit."""
    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=91)
    reads = reads_from_reference(ref, 20, length=101, mutation_rate=0.05, seed=92)
    reads += [("short", b"AC"), ("nohit", b"T" * 30)]
    return db, parse_newick(db.tree()), reads


def _hot_db(base):
    """``base``'s keys, each with one posting but one with a posting on
    every branch: a read of ten copies of that key holds more postings than
    the CSR steps' first budget of 512."""
    rng = np.random.default_rng(93)
    B = parse_newick(base.tree()).get_node_count()
    lens = np.ones(base.keys.shape[0], np.int64)
    lens[0] = B
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(row_off[-1])
    db = PhyloKmerDB(sequence_type="nucl", kmer_size=base.kmer_size, omega=base.omega,
                     tree_newick=base.tree_newick, keys=base.keys, row_off=row_off,
                     branches=np.concatenate([rng.permutation(B)[:n].astype(np.uint32)
                                              for n in lens]),
                     scores=rng.uniform(-3.5, -0.5, size=total).astype(np.float32),
                     version=base.version, num_entries_total=total,
                     num_entries_loaded=total)
    db.validate()
    hot = DNA.decode_key(int(base.keys[0]), base.kmer_size)
    reads = [(f"hot{i}", (hot * 10 + DNA.decode_key(i, base.kmer_size)).encode())
             for i in range(6)]
    return db, reads


def _overflow_db():
    """Keys of a 80 bp read with 17 postings each among 2,000 keys of one:
    the tiles take the two-level split, and that read's overflow windows
    outgrow the static OV budget."""
    rng = np.random.default_rng(201)
    k = 6
    hot = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
    entries = {}
    for w in range(len(hot) - k + 1):
        entries.setdefault(hot[w:w + k], [
            (int(b), float(s)) for b, s in zip(rng.permutation(60)[:17],
                                               rng.uniform(-2.4, -0.5, 17))])
    filler = set()
    while len(filler) < 2000:
        filler.add(DNA.decode_key(int(rng.integers(0, 4**k)), k))
    for f in filler:
        if f not in entries:
            entries[f] = [(int(rng.integers(0, 60)), -1.0)]
    db = build_db(entries, "(" + ",".join(f"L{i}:0.1" for i in range(60)) + ");", kmer_size=k)
    return db, [("hot", hot.encode()), ("cold", DNA.decode_key(3, k).encode() * 10)]


def _retry_placer(engine, small):
    """A placer on the CSR route over the hot database, and its batch."""
    db, reads = _hot_db(small[0])
    placer = _placer(engine, db, parse_newick(db.tree()), dense_db="off",
                     tokenize_where="host", budget_headroom=0.5)
    assert placer.route == "csr"
    return placer, reads


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("engine", ENGINES)
def test_place_surface(small, engine, case):
    db, tree, reads = small
    if case == "empty":
        placer = _placer(engine, db, tree)
        pending = placer.place_async([])
        assert pending.out is None
        out = placer.place_wait(pending)
        assert out.placed_seqs == [] and out.sequence_map == {}
        return
    if case == "duplicates":
        placer = _placer(engine, db, tree)
        named = reads + [(f"again{i}", seq) for i, (_, seq) in enumerate(reads[:5])]
        named += [("thrice", reads[0][1])]
        out = placer.place(named)
        assert [q.sequence for q in out.placed_seqs] == list(dict.fromkeys(s for _, s in reads))
        assert out.sequence_map[reads[0][1]] == [reads[0][0], "again0", "thrice"]
        assert out.sequence_map[reads[7][1]] == [reads[7][0]]
        assert_jplace_close(ReferencePlacer(db, tree).place(named), out)
        return
    if case == "csr_retry":
        placer, batch = _retry_placer(engine, small)
        out = placer.place(batch)
        assert placer.overflow_retries > 0
    elif case == "tiles_retry":
        db, batch = _overflow_db()
        tree = parse_newick(db.tree())
        placer = _placer(engine, db, tree, dense_db="off")
        assert placer.route == "tiles"
        pending = placer.place_async(batch)
        assert pending.budget[0] == "tiles_ov"
        out = placer.place_wait(pending)
        assert placer.overflow_retries > 0
    else:
        placer, batch = _retry_placer(engine, small)
        spans.drain()
        spans.enable()
        try:
            with spans.span("place"):
                out = placer.place(batch)
        finally:
            spans.disable()
        recorded = spans.drain()
        assert sorted({s.name for s in recorded if s.name != "gc"}) == [
            "place", "place.assemble", "place.launch", "place.retry", "place.stage",
            "place.sync"]
        (place,) = [s for s in recorded if s.name == "place"]
        assert place.attrs["reads"] == place.attrs["distinct"] == len(batch)
        assert place.attrs["route"].startswith("csr")
        retries = [s for s in recorded if s.name == "place.retry"]
        assert len(retries) == placer.overflow_retries and retries[0].attrs["budget"] > 512
    db = placer.db
    assert_jplace_close(ReferencePlacer(db, parse_newick(db.tree())).place(batch), out)
