"""The frozen generator against the port's, and the read generator."""

import numpy as np
import pytest

from placebench import gen


@pytest.mark.parametrize("args", [
    dict(num_leaves=40, kmer_size=8, ref_length=15_000, seed=3),
    dict(num_leaves=300, kmer_size=10, ref_length=60_000, seed=10),
    dict(num_leaves=7, kmer_size=6, ref_length=3_000, mean_posting_len=5.0, seed=2**40 + 1),
])
def test_frozen_db_equals_the_ports(args):
    from epik_tpu_torch.io.build import reference_like_db

    db, ref = reference_like_db(**args)
    ours = gen.reference_like_db(**args)
    for name in ("keys", "row_off", "branches", "scores"):
        got, want = ours[name], getattr(db, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert ours["newick"] == db.tree_newick and ours["ref"] == ref
    assert ours["num_branches"] == 2 * args["num_leaves"] - 1


def test_db_postings_hold_distinct_branches():
    db = gen.reference_like_db(30, 8, 20_000, seed=5)
    rows = np.repeat(np.arange(db["keys"].size), np.diff(db["row_off"]))
    pairs = rows * db["num_branches"] + db["branches"]
    assert np.unique(pairs).size == pairs.size
    assert db["scores"].max() < -0.05 + 1e-6
    assert db["scores"].min() >= gen.log10_score_threshold(1.5, 8) - 1e-6


def test_reads_share_lengths_across_seeds():
    db = gen.reference_like_db(20, 8, 10_000, seed=1)
    a = gen.make_reads(db["ref"], 500, (100, 200), 0.02, 0.01, (1, 2),
                       np.random.default_rng(1), chunk=64)
    b = gen.make_reads(db["ref"], 500, (100, 200), 0.02, 0.01, (1, 2),
                       np.random.default_rng(2), chunk=64)
    assert sorted(np.diff(a[1])) == sorted(np.diff(b[1]))
    assert not np.array_equal(a[0][:100], b[0][:100])
    for buf, off, iupac in (a, b):
        assert iupac.size == 5
        has_n = [bool((buf[off[i]:off[i + 1]] == ord("N")).any()) for i in range(500)]
        assert set(np.flatnonzero(has_n)) == set(iupac.tolist())
        assert set(np.unique(buf).tolist()) <= set(b"ACGTN")


def test_reads_same_seed_same_reads():
    db = gen.reference_like_db(20, 8, 10_000, seed=1)
    a = gen.make_reads(db["ref"], 300, (50, 80), 0.05, 0.0, (1, 2), np.random.default_rng(9))
    b = gen.make_reads(db["ref"], 300, (50, 80), 0.05, 0.0, (1, 2), np.random.default_rng(9))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_fasta_bytes():
    buf = np.frombuffer(b"ACGTTT", np.uint8)
    off = np.array([0, 4, 6])
    assert gen.fasta_bytes(buf, off) == b">r0\nACGT\n>r1\nTT\n"
