"""The NumPy reference on a case worked by hand, and against the port's
scalar oracle."""

import math

import numpy as np
import pytest

from placebench import gen
from placebench.reference import ReferencePlacer, Tree, tokenize

THR = 0.140625  # (1.5 / 4) ** 2
LOG_THR = math.log10(THR)


def tiny_db():
    # keys "AC" = 1 and "CG" = 6; tree A, B, root in post-order
    return {"keys": np.array([1, 6], np.uint64), "row_off": np.array([0, 2, 3]),
            "branches": np.array([0, 1, 1], np.uint32),
            "scores": np.array([-0.5, -0.75, -0.25], np.float32),
            "newick": "(A:0.1,B:0.3):0.2;", "kmer_size": 2, "omega": 1.5}


def test_tree_lengths_by_hand():
    t = Tree("(A:0.1,B:0.3):0.2;")
    assert t.n == 3
    assert np.allclose(t.distal, [0.05, 0.15, 0.1])
    assert np.allclose(t.pendant, [0.05, 0.15, 0.1 + 0.4 / 3])


def test_tokenize_by_hand():
    m, exact, ambs = tokenize(b"ACGNA", 2)
    assert m == 4 and exact.tolist() == [1, 6]
    # GN -> GA GC GG GT, NA -> AA CA GA TA
    assert [a.tolist() for a in ambs] == [[8, 9, 10, 11], [0, 4, 8, 12]]
    assert tokenize(b"A", 2)[0] == 0


def test_exact_read_by_hand():
    out = ReferencePlacer(tiny_db()).place(b"ACG")
    s0 = (-0.5 + LOG_THR) / 2  # branch 0: one hit of two windows
    s1 = (-0.75 - 0.25) / 2  # branch 1: both windows hit
    total = THR + 10 ** s0 + 10 ** s1  # branch 2 untouched: (3 - 2) * 10**(2 * log_thr / 2)
    want = [(1, s1, 10 ** s1 / total, 0.15, 0.15), (0, s0, 10 ** s0 / total, 0.05, 0.05)]
    assert [r[0] for r in out["rows"]] == [1, 0]
    for got, exp in zip(out["rows"], want):
        assert got == pytest.approx(exp, abs=1e-6)
    assert out["touched"].tolist() == [True, True, False]
    assert out["untouched"] == pytest.approx(LOG_THR, abs=1e-6)


def test_ambiguous_read_by_hand():
    # AN -> AA AC AG AT (AC hits branches 0, 1); NG -> AG CG GG TG (CG hits
    # branch 1 again, already first-hit in the read: no add)
    out = ReferencePlacer(tiny_db()).place(b"ANG")
    a0 = (10 ** -0.5 + THR) / 2
    a1 = (10 ** -0.75 + THR) / 2
    s0, s1 = (a0 + LOG_THR) / 2, (a1 + LOG_THR) / 2
    got = {r[0]: r[1] for r in out["rows"]}
    assert got[0] == pytest.approx(s0, abs=1e-6) and got[1] == pytest.approx(s1, abs=1e-6)


def test_no_hit_read_falls_back():
    out = ReferencePlacer(tiny_db(), keep_at_most=2).place(b"TTTT")
    assert [r[0] for r in out["rows"]] == [0, 1]
    assert all(r[3] == 0.0 and r[4] == 0.0 for r in out["rows"])


def test_equals_the_ports_scalar_oracle():
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.reference import ReferencePlacer as PortOracle
    from epik_tpu_torch.io.build import reference_like_db

    db = gen.reference_like_db(50, 8, 20_000, seed=4)
    pdb, _ = reference_like_db(num_leaves=50, kmer_size=8, ref_length=20_000, seed=4)
    buf, off, _ = gen.make_reads(db["ref"], 120, (60, 700), 0.03, 0.1, (1, 3),
                                 np.random.default_rng(8))
    seqs = [buf[off[i]:off[i + 1]].tobytes() for i in range(120)]
    seqs += [b"ACG", b"T" * 200, b"ACGTRACGTAYCGTTGCAATGCA" * 4, b"ACGTNNACGTAC" * 5]
    ours = ReferencePlacer(db)
    port = PortOracle(pdb, parse_newick(pdb.tree_newick)).place(
        [(f"q{i}", s) for i, s in enumerate(seqs)])
    for ps in port.placed_seqs:
        want = [(p.branch_id, p.score, p.weight_ratio, p.distal_length, p.pendant_length)
                for p in ps.placements]
        assert ours.place(ps.sequence)["rows"] == want
