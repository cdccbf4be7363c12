"""``TorchPlacer`` on the CPU against the JAX placer and the scalar oracle.

The fixture is ``tests/test_jax_engine.py::TestPairPlane``'s: 48 leaves, k=8,
reads sampled from the reference plus an ambiguous read, a read shorter than
k and a no-hit read. The port's device state must be bit-equal to the JAX
placer's; its device step, fed the JAX placer's own state and staged batch,
must match ``_place_batch_dense_paired``; its placements must match the
oracle (``assert_jplace_close``) and the JAX placer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db, reads_from_reference, reference_like_db

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.state import plane_state_from_numpy
from epik_tpu_torch.engine.step import dense_gather, place_batch_dense_paired

TREE = "((A:0.1,B:0.2):0.3,C:0.4):0.0;"


def assert_jplace_close(out_ref, out_port, eps=1e-4, per_edge=False):
    """Score SETS almost-equal per sequence (tools/jplace_diff.py semantics);
    with ``per_edge``, a read whose sets differ may still match edge by edge
    in probability space, as jplace_diff allows (a 65,536 bp read's scores
    near -27,000 keep f32's relative 1e-7 of each other, not 1e-4)."""
    ref_by = {q.sequence: q.placements for q in out_ref.placed_seqs}
    port_by = {q.sequence: q.placements for q in out_port.placed_seqs}
    assert set(ref_by) == set(port_by)
    for seq, rp in ref_by.items():
        sa = sorted(q.score for q in rp)
        sb = sorted(q.score for q in port_by[seq])
        if per_edge and not (len(sa) == len(sb)
                             and all(abs(x - y) <= eps for x, y in zip(sa, sb))):
            ea = {q.branch_id: q.score for q in rp}
            eb = {q.branch_id: q.score for q in port_by[seq]}
            assert set(ea) == set(eb), seq
            assert all(abs(10.0 ** ea[e] - 10.0 ** eb[e]) <= eps for e in ea), seq
            continue
        assert len(sa) == len(sb) and all(abs(x - y) <= eps for x, y in zip(sa, sb)), seq


@pytest.fixture(scope="module")
def fx():
    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=31)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=101, mutation_rate=0.05, seed=32)
    reads += reads_from_reference(ref, 10, length=80, mutation_rate=0.4, seed=33)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("short", b"AC"), ("nohit", b"T" * 30),
              ("odd", b"ACGTACGTACGTACGT")]  # k=8 -> W=9, a trailing single slot
    jax_p = JaxPlacer(db, tree)
    assert jax_p._paired
    port = TorchPlacer(db, tree, device="cpu")
    return db, tree, reads, jax_p, port


def test_state_bit_equal(fx):
    db, _, _, jax_p, port = fx
    np.testing.assert_array_equal(port.state.plane.numpy(), np.asarray(jax_p._plane_s))
    np.testing.assert_array_equal(port.state.combo.numpy(), np.asarray(jax_p._dev_combo))
    assert port.state.n_keys == db.num_kmers and port.state.n_pairs > 0
    assert not port.state.plane[db.num_kmers].any()  # the zero row stays at n_keys


def test_step_matches_jax(fx):
    """The whole device step on the JAX placer's state and staged batch."""
    db, _, reads, jax_p, _ = fx
    seqs = list(dict.fromkeys(s for _, s in reads))
    fn, arrays, _, R_true, K = jax_p._stage_bytes(seqs)
    kw = fn.keywords
    assert kw["Amax"] > 0  # the batch holds an ambiguous read
    want = np.asarray(fn(*arrays))
    plane_s, combo, buf, arows = (np.array(a) for a in arrays)  # writable copies
    st = plane_state_from_numpy(plane_s, combo, n_keys=db.num_kmers, device="cpu")
    got = place_batch_dense_paired(
        st.plane, st.combo, torch.from_numpy(buf), torch.from_numpy(arows),
        B=kw["B"], K=K, Amax=kw["Amax"], k=kw["k"], Lmax=kw["Lmax"],
        num_kmers=kw["num_kmers"], log_eps=kw["log_eps"], eps=kw["eps"],
        gather=dense_gather(st.plane, kw["B"], K, shifted=True)).numpy()
    assert got.shape == want.shape == (kw["R"], 2 * K + 3)
    n = want[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])  # n, zero_sum
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    np.testing.assert_array_equal(got[:, K:2 * K][live], want[:, K:2 * K][live])
    np.testing.assert_allclose(got[:, :K][live], want[:, :K][live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-5)


def test_step_is_tokenizer_deltas_and_fused_kernel(fx):
    """The dense step is the tokenizer, the ambiguous reads' delta rows and
    the fused kernel 1, nothing else: those three on the step's inputs give
    its pack bit for bit, ambiguous reads and all; so do the tokenizer
    kernel's wrapper (its rows, lengths and window counts those of the torch
    tokenizer and ``window_counts``) and ``_shifted_finish``. On the CPU no
    kernel launch is counted."""
    from epik_tpu_torch.engine.step import _shifted_finish, window_counts
    from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
    from epik_tpu_torch.kernels.rowgather import rowgather_sum_topk
    from epik_tpu_torch.kernels.tokenize import tokenize_combo_fused
    from epik_tpu_torch.ops.dense import amb_deltas
    from epik_tpu_torch.ops.tokenize import tokenize_combo

    db, _, reads, _, port = fx
    seqs = list(dict.fromkeys(s for _, s in reads))
    buf, arows, Amax, Lmax, _ = port._stage_bytes(seqs)
    assert Amax > 0
    st, k = port.state, port.k
    kw = dict(K=port._K(), k=k, log_eps=float(port.log_eps))
    buf_t, arows_t = torch.from_numpy(buf), torch.from_numpy(arows)
    reset_launch_counts()
    want = place_batch_dense_paired(st.plane, st.combo, buf_t, arows_t, B=port.B, Amax=Amax,
                                    Lmax=Lmax, num_kmers=st.n_keys, eps=float(port.eps),
                                    gather=port._gather, **kw)
    rows, lens = tokenize_combo(buf_t, st.combo, k=k, Lmax=Lmax)
    amb_read, delta = amb_deltas(st.plane, arows_t, zero_row=st.n_keys, B=port.B, k=k,
                                 eps=float(port.eps), log_eps=float(port.log_eps))
    assert amb_read.numel() > 0
    got = rowgather_sum_topk(st.plane, rows, window_counts(lens, k), amb_read, delta, B=port.B,
                             **kw)
    assert torch.equal(got, want)
    rows_f, lens_f, m_f = tokenize_combo_fused(buf_t, st.combo, k=k, Lmax=Lmax)
    assert torch.equal(rows_f, rows) and torch.equal(lens_f, lens)
    assert torch.equal(m_f.view(torch.int32), window_counts(lens, k).view(torch.int32))
    fin = _shifted_finish(st.plane, rows_f, m_f, arows_t, B=port.B, Amax=Amax,
                          zero_row=st.n_keys, eps=float(port.eps), pair_rows=True,
                          gather=port._gather, **kw)
    assert torch.equal(fin, want)
    assert not any(launch_counts().values())


def test_place_matches_oracle_and_jax(fx):
    db, tree, reads, jax_p, port = fx
    out = port.place(reads)
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    jax_by = {q.sequence: q.placements for q in jax_p.place(reads).placed_seqs}
    port_by = {q.sequence: q.placements for q in out.placed_seqs}
    assert set(jax_by) == set(port_by)
    for seq, pj in jax_by.items():
        pt = port_by[seq]
        assert {p.branch_id for p in pj} == {p.branch_id for p in pt}, seq
        sj = {p.branch_id: p.score for p in pj}
        for p in pt:
            assert abs(p.score - sj[p.branch_id]) <= 1e-5 + 1e-5 * abs(sj[p.branch_id])


def test_place_dedup_keep_and_empty(fx):
    db, tree, reads, _, port = fx
    recs = [("x", reads[0][1]), ("y", reads[0][1]), ("z", reads[1][1])]
    out = port.place(recs)
    assert out.sequence_map[reads[0][1]] == ["x", "y"]
    assert len(out.placed_seqs) == 2
    assert port.place([]).placed_seqs == []
    two = TorchPlacer(db, tree, keep_at_most=2, keep_factor=0.5, device="cpu",
                      state=port.state)
    ref = ReferencePlacer(db, tree, keep_at_most=2, keep_factor=0.5)
    assert_jplace_close(ref.place(reads), two.place(reads))


@pytest.mark.parametrize("field,value", [
    ("precision", "int16"), ("precision", "bf16"), ("plane_mode", "classic"),
    ("pair_plane", "off"), ("accumulate", "scatter"),
    ("lookup_where", "device"), ("tokenize_where", "host"),
])
def test_unported_config_raises(fx, field, value):
    """Every option places, as the JAX placer does under the same config:
    the dense options with the JAX placer's plane flags (bf16 within its
    precision: the best edge of nearly every read, as
    ``tests/test_jax_engine.py`` holds it), ``accumulate="scatter"`` on the
    CSR route with JAX's scatter engine (a flat posting budget), also
    against the oracle."""
    from epik_tpu.engine.placer import PlacerConfig as JaxConfig

    db, tree, reads, _, _ = fx
    cfg = dataclasses.replace(PlacerConfig(), **{field: value})
    port = TorchPlacer(db, tree, config=cfg, device="cpu")
    jax_p = JaxPlacer(db, tree, config=JaxConfig(**{field: value}))
    if value == "scatter":
        assert port.route == "csr" and not jax_p._dense_db and not jax_p._dense
        assert_jplace_close(ReferencePlacer(db, tree).place(reads), port.place(reads))
    else:
        assert port.route == "dense" and not port._paired and not jax_p._paired
        assert (port._shifted, port._plane_q) == (jax_p._shifted, jax_p._plane_q)
    jax_by = {q.sequence: q.placements for q in jax_p.place(reads).placed_seqs}
    port_by = {q.sequence: q.placements for q in port.place(reads).placed_seqs}
    assert set(jax_by) == set(port_by)
    if value == "bf16":
        agree = sum(pj[0].branch_id == port_by[s][0].branch_id
                    for s, pj in jax_by.items() if pj)
        assert agree >= 0.93 * sum(1 for pj in jax_by.values() if pj)
        return
    for seq, pj in jax_by.items():
        sj = {p.branch_id: p.score for p in pj}
        assert {p.branch_id for p in port_by[seq]} == set(sj), seq
        for p in port_by[seq]:
            assert abs(p.score - sj[p.branch_id]) <= 1e-5 + 1e-5 * abs(sj[p.branch_id])


def test_unknown_config_value_raises(fx):
    db, tree, _, _, port = fx
    with pytest.raises(ValueError):
        TorchPlacer(db, tree, config=PlacerConfig(precision="fp8"), device="cpu",
                    state=port.state)


def test_over_budget_raises_with_sizes(fx):
    """A dense plane over the budget routes to the posting tiles when the
    budget holds the tiles' bytes, and to CSR when it does not; a pair plane
    over its budget takes the unpaired plane and places as the oracle does,
    and raises with the sizes where ``pair_plane="on"`` asks for it."""
    from epik_tpu_torch.engine.tiles import tile_bytes

    db, tree, reads, _, _ = fx
    need = tile_bytes(db.num_kmers, int(np.diff(db.row_off).max()))
    routes = [TorchPlacer(db, tree, config=PlacerConfig(dense_db_budget=b),
                          device="cpu").route for b in (need, need - 1, 1)]
    assert routes == ["tiles", "csr", "csr"]
    with pytest.raises(ValueError, match="bytes"):
        TorchPlacer(db, tree, config=PlacerConfig(dense_db="on", dense_db_budget=1),
                    device="cpu")
    from epik_tpu.engine.placer import PlacerConfig as JaxConfig

    small = (db.num_kmers + 2) * 512
    unpaired = TorchPlacer(db, tree, config=PlacerConfig(pair_plane_budget=small), device="cpu")
    assert unpaired.route == "dense" and not unpaired._paired
    assert unpaired.state.direct is not None
    out = unpaired.place(reads)
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    jax_p = JaxPlacer(db, tree, config=JaxConfig(pair_plane_budget=small))
    assert not jax_p._paired  # JAX takes the unpaired plane too
    assert_jplace_close(jax_p.place(reads), out, eps=1e-5)
    with pytest.raises(ValueError, match="bytes"):
        TorchPlacer(db, tree, config=PlacerConfig(pair_plane="on", pair_plane_budget=small),
                    device="cpu")


def test_unported_databases_raise():
    """No database raises any more: amino and DNA k = 14 place on the shifted
    dense plane through the codes tokenizer and the radix lookup, as the
    oracle does; scores below log10(eps) (the classic plane) and k = 13 (the
    unpaired plane) place as the oracle does."""
    amino = random_db(num_leaves=8, kmer_size=3, num_kmers=200, seed=1,
                      sequence_type="amino")
    k14 = random_db(num_leaves=8, kmer_size=14, num_kmers=50, seed=4)
    for db, recs in ((amino, [("r", b"ACDEFGHIKLMNPQ"), ("x", b"ACDXFG"), ("s", b"AC")]),
                     (k14, [("r", b"ACGTACGTACGTACGTACGT"), ("s", b"ACG")])):
        tree = parse_newick(db.tree())
        port = TorchPlacer(db, tree, device="cpu")
        assert port.route == "dense" and port._shifted and port._fast_codes
        assert_jplace_close(ReferencePlacer(db, tree).place(recs), port.place(recs))
    below = build_db({"ACG": [(0, 0.0), (2, -2.0)], "CGT": [(1, -0.5)]}, TREE, kmer_size=3)
    port = TorchPlacer(below, parse_newick(TREE), device="cpu")
    assert port.route == "dense" and not port._shifted
    recs = [("r", b"ACGT"), ("s", b"TACGTT")]
    assert_jplace_close(ReferencePlacer(below, parse_newick(TREE)).place(recs), port.place(recs))
    big_k = random_db(num_leaves=8, kmer_size=13, num_kmers=50, seed=2)
    tree = parse_newick(big_k.tree())
    port = TorchPlacer(big_k, tree, device="cpu")
    assert port.route == "dense" and port._shifted and not port._paired
    recs = [("r", b"ACGTACGTACGTACGTAC")]
    assert_jplace_close(ReferencePlacer(big_k, tree).place(recs), port.place(recs))


def test_unported_batches_raise(fx):
    """A batch of reads all shorter than k and a read of 65,536 bp (past the
    packed format's uint16 length) take the host tokenizer, as in JAX, and
    place as the oracle does."""
    db, tree, reads, _, port = fx
    ref = ReferencePlacer(db, tree)
    short = [("a", b"ACG"), ("b", b"")]
    assert_jplace_close(ref.place(short), port.place(short))
    long = [("long", (reads[0][1] * 700)[:65536]), ("r", reads[1][1])]
    assert_jplace_close(ref.place(long), port.place(long), per_edge=True)


def test_cuda_without_cuda_raises(fx, monkeypatch):
    db, tree, _, _, _ = fx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPlacer(db, tree, device="cuda")


def test_placer_defaults_to_the_card(fx, monkeypatch):
    """No device named: the placer and the mesh ask for the card, and
    without one raise rather than place on the CPU."""
    from epik_tpu_torch.parallel.mesh import make_mesh

    db, tree, _, _, _ = fx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPlacer(db, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
