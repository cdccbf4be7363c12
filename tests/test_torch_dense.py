"""The rest of the single-device dense engine on the CPU, held to the JAX package.

Every plane and step ``JaxPlacer`` takes besides the pair plane: the unpaired
shifted plane (``pair_plane="off"``), the classic plane
(``plane_mode="classic"``), the int16 and bf16 planes, the device-lookup
classic step (``lookup_where="device"``) and the host-rows step
(``tokenize_where="host"``), plus the batches and databases that route there
(short reads, a 65,536 bp read, scores below log10(eps), an empty database,
k = 13, k = 14 on the classic plane).

* Each plane is bit-equal to ``JaxPlacer._plane_s`` (dtype included).
* Each step, fed the JAX placer's own state and staged batch, matches its JAX
  function: scores within 1e-5 (the port sums rows in window order, XLA in
  chunks of 16 windows), n and zero_sum exact, indices where no near-tie
  hides them; counts exact; int16 sums exact.
* Kernel 1's classic (counts) and int16 plain versions match
  ``dense_sums_from_rows`` and ``dense_sums_shifted``.
* ``TorchPlacer`` matches ``JaxPlacer`` under the same config and the scalar
  oracle by the jplace_diff rule (1e-4); bf16 by the JAX test's top-edge rule
  (``tests/test_jax_engine.py::TestBf16FastMode``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.placer import (
    _apply_amb,
    _bucket,
    _pack_outputs_slim,
    _place_batch_dense_rows,
    _place_batch_device_densedb,
    dense_sums_from_rows,
    dense_sums_shifted,
    finish_scores_shifted,
)
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db, reads_from_reference, reference_like_db

from epik_tpu_torch.engine import step as step_mod
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.state import build_csr_state, plane_state_from_numpy
from epik_tpu_torch.engine.step import (
    dense_gather,
    place_batch_dense_bytes,
    place_batch_dense_rows,
    place_batch_device_densedb,
)
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.rowgather import (
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_counts_plain,
    rowgather_sum_plain,
    rowgather_sum_topk_int16,
    rowgather_sum_topk_plain,
)
from epik_tpu_torch.ops.dense import amb_deltas

TREE = "((A:0.1,B:0.2):0.3,C:0.4):0.0;"

#: the configs this engine adds, by the JAX placer's flags they set
CONFIGS = {
    "pair_off": dict(pair_plane="off"),
    "classic": dict(plane_mode="classic"),
    "int16": dict(precision="int16"),
    "bf16": dict(precision="bf16"),
    "lookup_device": dict(lookup_where="device"),
    "tokenize_host": dict(tokenize_where="host"),
}


@pytest.fixture(scope="module")
def fx():
    db, ref = reference_like_db(num_leaves=24, kmer_size=6, ref_length=8_000,
                                mean_posting_len=6.0, seed=61)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=80, mutation_rate=0.05, seed=62)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
              ("amb2", b"R" + reads[1][1][1:50] + b"Y" + reads[1][1][51:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    return db, tree, reads, ReferencePlacer(db, tree).place(reads)


@pytest.fixture(scope="module")
def placers(fx):
    """name -> (JaxPlacer, TorchPlacer) under the same config."""
    db, tree, _, _ = fx
    return {name: (JaxPlacer(db, tree, config=JaxConfig(**kw)),
                   TorchPlacer(db, tree, config=PlacerConfig(**kw), device="cpu"))
            for name, kw in CONFIGS.items()}


def _by_seq(out):
    return {q.sequence: q.placements for q in out.placed_seqs}


def jplace_close(want, got, eps=1e-4):
    """The jplace_diff rule (``tools/jplace_diff.py``) on two collections:
    per read, the score sets within ``eps``, else every edge of either within
    ``eps`` in probability space."""
    a, b = _by_seq(want), _by_seq(got)
    assert set(a) == set(b)
    for seq, pa in a.items():
        pb = b[seq]
        sa, sb = sorted(p.score for p in pa), sorted(p.score for p in pb)
        if len(sa) == len(sb) and all(abs(x - y) <= eps for x, y in zip(sa, sb)):
            continue
        ea = {p.branch_id: p.score for p in pa}
        eb = {p.branch_id: p.score for p in pb}
        assert set(ea) == set(eb), seq
        for e in ea:
            assert abs(10.0 ** ea[e] - 10.0 ** eb[e]) <= eps, (seq, e)


def same_placements(want, got, tol=1e-5):
    """The same edges, scores within f32 reordering of the row sums."""
    a, b = _by_seq(want), _by_seq(got)
    assert set(a) == set(b)
    for seq, pa in a.items():
        ea = {p.branch_id: p.score for p in pa}
        eb = {p.branch_id: p.score for p in b[seq]}
        assert set(ea) == set(eb), seq
        for e, s in ea.items():
            assert abs(eb[e] - s) <= tol + tol * abs(s), (seq, e)


def top_edges_close(want, got, R):
    """``TestBf16FastMode``'s rule: the best edge the same for nearly every
    read (28 of 30 there) and its score within 2e-2."""
    a, b = _by_seq(want), _by_seq(got)
    agree = 0
    for seq, pa in a.items():
        pb = b[seq]
        if pa and pb:
            agree += pa[0].branch_id == pb[0].branch_id
            assert pb[0].score == pytest.approx(pa[0].score, rel=2e-2, abs=2e-2)
    assert agree >= math.ceil(R * 28 / 30)


def assert_pack_close(got, want, K, slim):
    """Two step outputs: n and zero_sum exact, the live scores within 1e-5,
    the indices (and the full pack's counts) where no near-tie hides them."""
    if slim:
        sc, ix, n_col = slice(0, K), slice(K, 2 * K), 2 * K + 1
    else:
        np.testing.assert_array_equal(got[-1], want[-1])  # the totals row
        got, want = got[:-1], want[:-1]
        sc, ix, n_col = slice(0, K), slice(2 * K, 3 * K), 4 * K
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, n_col:], want[:, n_col:])  # n, zero_sum
    n = want[:, n_col].astype(int)
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    np.testing.assert_allclose(got[:, sc][live], want[:, sc][live], rtol=1e-5, atol=1e-5)
    step = np.abs(np.diff(np.where(live, want[:, sc], 0.0), axis=1))
    gap = np.full(live.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    clear = live & (gap > 1e-4)
    assert clear.sum() > live.shape[0]
    np.testing.assert_array_equal(got[:, ix][clear], want[:, ix][clear])
    if not slim:
        np.testing.assert_array_equal(got[:, 3 * K:4 * K][clear], want[:, 3 * K:4 * K][clear])
        np.testing.assert_allclose(got[:, K:2 * K][live], want[:, K:2 * K][live],
                                   rtol=1e-4, atol=1e-6)  # wr


def _carried(jax_p, n_keys):
    """The JAX placer's plane (and direct table, scale) as a torch state."""
    direct = None if jax_p._dev_direct is None else np.asarray(jax_p._dev_direct)
    return plane_state_from_numpy(np.asarray(jax_p._plane_s), n_keys=n_keys, device="cpu",
                                  direct=direct, scale=float(jax_p._plane_scale))


# ---- the planes -------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plane_bit_equal_to_jax(fx, placers, name):
    db = fx[0]
    jax_p, port = placers[name]
    want = np.asarray(jax_p._plane_s)
    got = port.state.plane
    assert str(got.dtype).split(".")[1] == want.dtype.name
    assert not jax_p._paired and not port._paired and port.state.combo is None
    assert (port._shifted, port._plane_q, port._fast_bytes) == (
        jax_p._shifted, jax_p._plane_q, jax_p._fast_bytes)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(np.int16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port.state.scale == jax_p._plane_scale
    if jax_p._fast_bytes:
        np.testing.assert_array_equal(port.state.direct.numpy(), np.asarray(jax_p._dev_direct))
    assert not port.state.plane[db.num_kmers].any()  # the zero row at n_keys


# ---- the steps on the JAX placer's state ---------------------------------------------


@pytest.mark.parametrize("name", ["pair_off", "classic", "int16", "bf16"])
def test_dense_bytes_step_matches_jax(fx, placers, name):
    """``place_batch_dense_bytes`` against ``_place_batch_dense_bytes`` on the
    JAX placer's plane, direct table and staged (R-padded) batch."""
    db, _, reads, _ = fx
    jax_p, _ = placers[name]
    seqs = list(dict.fromkeys(s for _, s in reads))
    fn, arrays, _, _, K = jax_p._stage_bytes(seqs)
    kw = fn.keywords
    assert kw["Amax"] > 0 and fn.func.__name__ == "_place_batch_dense_bytes"
    want = np.asarray(fn(*arrays))
    st = _carried(jax_p, db.num_kmers)
    _, _, buf, arows = (np.array(a) for a in arrays)
    reset_launch_counts()
    got = place_batch_dense_bytes(
        st.plane, st.direct, torch.from_numpy(buf), torch.from_numpy(arows), B=kw["B"],
        K=K, Amax=kw["Amax"], k=kw["k"], Lmax=kw["Lmax"], num_kmers=kw["num_kmers"],
        log_eps=kw["log_eps"], eps=kw["eps"], shifted=kw["shifted"],
        gather=dense_gather(st.plane, kw["B"], K, shifted=kw["shifted"]),
        plane_scale=kw["plane_scale"]).numpy()
    assert not any(launch_counts().values())
    assert_pack_close(got, want, K, slim=kw["shifted"])


def test_dense_rows_step_matches_jax(fx, placers):
    """``place_batch_dense_rows`` against ``_place_batch_dense_rows`` on host
    rows (``tokenize_where="host"``: the shifted unpaired plane), and on the
    classic plane (``plane_mode="classic"``) with the same rows."""
    db, _, reads, _ = fx
    seqs = list(dict.fromkeys(s for _, s in reads))
    for name in ("tokenize_host", "classic"):
        jax_p, _ = placers[name]
        tok = jax_p._tokenize(seqs)
        R = len(seqs)
        m_signed = tok.seq_lengths - jax_p.k + 1
        m_f32 = np.where(m_signed >= 0, m_signed.astype(np.float32),
                         np.float32(2.0**64) + m_signed.astype(np.float32)).astype(np.float32)
        Wmax = -(-int(np.bincount(tok.exact_read, minlength=R).max()) // 16) * 16
        Amax = _bucket(int(np.bincount(tok.amb_read, minlength=R).max()), 8)
        rows = jax_p._rows_matrix(tok.exact_keys, tok.exact_read, R, Wmax)
        arows = jax_p._rows_matrix(tok.amb_keys, tok.amb_read, R, Amax)
        K = min(7, jax_p.B)
        kw = dict(B=jax_p.B, K=K, Amax=Amax, k=jax_p.k, log_eps=float(jax_p.log_eps),
                  eps=float(jax_p.eps))
        want = np.asarray(_place_batch_dense_rows(
            jax_p._plane_s, jnp.asarray(rows), jnp.asarray(arows), jnp.asarray(m_f32),
            R=R, Wmax=Wmax, shifted=jax_p._shifted, plane_scale=float(jax_p._plane_scale),
            interpret=True, **kw))
        st = _carried(jax_p, db.num_kmers)
        got = place_batch_dense_rows(st.plane, torch.from_numpy(rows), torch.from_numpy(arows),
                                     torch.from_numpy(m_f32), zero_row=db.num_kmers,
                                     shifted=jax_p._shifted, plane_scale=st.scale,
                                     gather=dense_gather(st.plane, jax_p.B, K,
                                                         shifted=jax_p._shifted),
                                     **kw).numpy()
        assert_pack_close(got, want, K, slim=jax_p._shifted)


def test_device_densedb_step_matches_jax(fx, placers):
    """``place_batch_device_densedb`` (the port's cuckoo table, built from the
    same keys and seed) against ``_place_batch_device_densedb`` on the JAX
    placer's table and classic plane, keys in processing order."""
    db, _, reads, _ = fx
    jax_p, _ = placers["lookup_device"]
    seqs = list(dict.fromkeys(s for _, s in reads))
    tok = jax_p._tokenize(seqs)
    R = len(seqs)
    m_signed = tok.seq_lengths - jax_p.k + 1
    m_f32 = np.where(m_signed >= 0, m_signed.astype(np.float32),
                     np.float32(2.0**64) + m_signed.astype(np.float32)).astype(np.float32)
    Wmax = -(-int(np.bincount(tok.exact_read, minlength=R).max()) // 16) * 16
    Amax = _bucket(int(np.bincount(tok.amb_read, minlength=R).max()), 8)
    e_hi, e_lo = jax_p._key_matrix(tok.exact_keys, tok.exact_read, R, Wmax)
    a_hi, a_lo = jax_p._key_matrix(tok.amb_keys, tok.amb_read, R, Amax)
    K = min(7, jax_p.B)
    kw = dict(B=jax_p.B, K=K, k=jax_p.k, log_eps=float(jax_p.log_eps), eps=float(jax_p.eps))
    want = np.asarray(_place_batch_device_densedb(
        jax_p._dev_table, jax_p._plane_s, *(jnp.asarray(a) for a in (e_hi, e_lo, a_hi, a_lo)),
        jnp.asarray(m_f32), R=R, Wmax=Wmax, Amax=Amax, seed1=jax_p.table.seed1,
        seed2=jax_p.table.seed2, interpret=True, **kw))
    cs = build_csr_state(db, device="cpu")
    assert (cs.seed1, cs.seed2) == (jax_p.table.seed1, jax_p.table.seed2)
    st = _carried(jax_p, db.num_kmers)
    got = place_batch_device_densedb(
        cs.table, cs.seed1, cs.seed2, st.plane,
        *(torch.from_numpy(a.astype(np.int64)) for a in (e_hi, e_lo, a_hi, a_lo)),
        torch.from_numpy(m_f32), zero_row=db.num_kmers,
        gather=dense_gather(st.plane, jax_p.B, K, shifted=False), **kw).numpy()
    assert_pack_close(got, want, K, slim=False)


# ---- kernel 1's variants, plain versions against JAX ----------------------------------


@pytest.mark.parametrize("cell", ["f32", "bf16"])
def test_rowgather_sum_counts_plain_matches_jax(cell):
    """The classic sums with counts against ``dense_sums_from_rows``: S
    within 1e-5 (XLA adds each chunk of 16 windows first), C exact; the
    wrappers take the plain version on CPU tensors and count nothing."""
    rng = np.random.default_rng(7 if cell == "f32" else 8)
    n_rows, bw, B, R, W = 60, 256, 200, 24, 32
    p = rng.uniform(-6.0, -0.01, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[:, B:] = 0.0
    p[-1] = 0.0
    p[0, :5] = np.float32(-1e-37)  # the exact-0.0 score's nudge
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = n_rows - 1
    plane_j = jnp.asarray(p) if cell == "f32" else jnp.asarray(p).astype(jnp.bfloat16)
    S_j, C_j = dense_sums_from_rows(plane_j, jnp.asarray(rows), R=R, B=B, Wmax=W)
    plane_t = torch.from_numpy(p)
    if cell == "bf16":
        plane_t = plane_t.to(torch.bfloat16)
        np.testing.assert_array_equal(plane_t.view(torch.int16).numpy(),
                                      np.asarray(plane_j).view(np.int16))
    rows_t = torch.from_numpy(rows)
    S, C = rowgather_sum_counts_plain(plane_t, rows_t)
    np.testing.assert_allclose(S[:, :B].numpy(), np.asarray(S_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(C[:, :B].numpy(), np.asarray(C_j))
    assert int(C[:, :5].sum()) > 0  # the nudged cells count
    wrapper = rowgather_sum_counts if cell == "f32" else rowgather_sum_counts_bf16
    reset_launch_counts()
    S2, C2 = wrapper(plane_t, rows_t)
    assert torch.equal(S2, S) and torch.equal(C2, C) and not any(launch_counts().values())
    with pytest.raises(ValueError):
        (rowgather_sum_counts_bf16 if cell == "f32" else rowgather_sum_counts)(plane_t, rows_t)


def test_int16_sums_exact_and_fused_plain_matches_jax(fx, placers):
    """Over JAX's own int16 plane: the int32 row sums are exact (the plain
    dequantized sums are bit-equal to ``dense_sums_shifted``'s int32 sums /
    f32(scale)), and the int16 fused plain version matches the JAX chain
    ``dense_sums_shifted`` -> ``/ plane_scale`` -> ``_apply_amb`` ->
    ``finish_scores_shifted``."""
    db = fx[0]
    jax_p, _ = placers["int16"]
    plane = np.asarray(jax_p._plane_s)
    assert plane.dtype == np.int16
    scale = float(jax_p._plane_scale)
    rng = np.random.default_rng(11)
    R, W, Amax, B, K, k = 64, 32, 4, jax_p.B, 7, jax_p.k
    zero = db.num_kmers
    rows = rng.integers(0, zero, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.2] = zero
    rows[0] = zero
    arows = np.full((R, Amax), zero, np.int32)
    arows[5:15] = rng.integers(0, zero, (10, Amax))
    m = rng.integers(W, W + 20, R).astype(np.float32)
    m[3] = np.float32(2.0**64)
    Sq = dense_sums_shifted(jnp.asarray(plane), jnp.asarray(rows), R=R, B=B, Wmax=W)
    assert Sq.dtype == jnp.int32
    Sp = Sq.astype(jnp.float32) / jnp.float32(scale)
    plane_t, rows_t = torch.from_numpy(plane.copy()), torch.from_numpy(rows)
    np.testing.assert_array_equal(rowgather_sum_plain(plane_t, rows_t, scale)[:, :B].numpy(),
                                  np.asarray(Sp))
    log_eps, eps = float(jax_p.log_eps), float(jax_p.eps)
    Sp, _ = _apply_amb(Sp, None, jnp.asarray(plane), jnp.asarray(arows), R=R, B=B, Amax=Amax,
                       k=k, eps=eps, log_eps=log_eps, shifted=True, plane_scale=scale)
    want = np.asarray(_pack_outputs_slim(finish_scores_shifted(
        Sp, jnp.asarray(m), B=B, K=K, k=k, log_eps=log_eps)))
    reads, delta = amb_deltas(plane_t, torch.from_numpy(arows), zero_row=zero, B=B, k=k,
                              eps=eps, log_eps=log_eps, plane_scale=scale)
    assert reads.numel() == 10
    kw = dict(B=B, K=K, k=k, log_eps=log_eps)
    got = rowgather_sum_topk_int16(plane_t, rows_t, torch.from_numpy(m), reads, delta,
                                   scale=scale, **kw).numpy()
    np.testing.assert_array_equal(
        got, rowgather_sum_topk_plain(plane_t, rows_t, torch.from_numpy(m), reads, delta,
                                      scale=scale, **kw).numpy())
    assert_pack_close(got, want, K, slim=True)


def test_fused_fallback_is_bit_equal(fx, placers, monkeypatch):
    """Past the fused kernel's limit the shifted steps run the gather, the
    delta add and the finish apart: the same pack, bit for bit, on the f32
    and the int16 plane, ambiguous reads and all."""
    _, _, reads, _ = fx
    seqs = list(dict.fromkeys(s for _, s in reads))
    for name in ("pair_off", "int16"):
        _, port = placers[name]
        st = port.state
        buf, arows, Amax, Lmax, _ = port._stage_bytes(seqs)
        kw = dict(B=port.B, K=port._K(), Amax=Amax, k=port.k, Lmax=Lmax,
                  num_kmers=st.n_keys, log_eps=float(port.log_eps), eps=float(port.eps),
                  shifted=True, plane_scale=st.scale)
        args = (st.plane, st.direct, torch.from_numpy(buf), torch.from_numpy(arows))

        def gather():
            return dense_gather(st.plane, kw["B"], kw["K"], shifted=True)

        fused = place_batch_dense_bytes(*args, gather=gather(), **kw)
        with monkeypatch.context() as mp:
            mp.setattr(step_mod, "topk_fits", lambda plane, B, K: False)
            assert gather() == "rows"
            apart = place_batch_dense_bytes(*args, gather=gather(), **kw)
        assert torch.equal(apart, fused)


# ---- the placer: routing, parity with JAX and the oracle --------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_placer_matches_jax_and_oracle(fx, placers, name):
    _, _, reads, oracle = fx
    jax_p, port = placers[name]
    assert port.route == "dense"
    got = port.place(reads)
    if name == "bf16":  # outside the 1e-4 gate by design (docs/QUIRKS.md)
        top_edges_close(oracle, got, len(reads))
        top_edges_close(jax_p.place(reads), got, len(reads))
        return
    jplace_close(oracle, got)
    same_placements(jax_p.place(reads), got)


def test_state_from_the_jax_placer_places_the_same(fx, placers):
    """A state carried across from the JAX placer (the int16 plane) places
    as the port's own; a state that is not the config's plane raises."""
    db, tree, reads, _ = fx
    jax_p, port = placers["int16"]
    carried = TorchPlacer(db, tree, config=PlacerConfig(precision="int16"), device="cpu",
                          state=_carried(jax_p, db.num_kmers))
    want, got = port.place(reads), carried.place(reads)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)
    with pytest.raises(ValueError, match="not the plane"):
        TorchPlacer(db, tree, config=PlacerConfig(plane_mode="classic"), device="cpu",
                    state=port.state)


@pytest.mark.parametrize("name", ["pair_off", "classic", "lookup_device"])
def test_batches_the_device_tokenizer_cannot_take(fx, placers, name):
    """A batch of reads all shorter than k, and a batch holding a read of
    65,536 bp, go to the host tokenizer (JAX ``_stage_bytes`` returns None)
    and place as the oracle does, on the unpaired shifted plane (host rows),
    the classic plane (host rows) and the classic plane with the keys looked
    up on the device."""
    db, tree, reads, _ = fx
    port = placers[name][1]
    ref = ReferencePlacer(db, tree)
    short = [("a", b"ACG"), ("b", b""), ("c", b"ACGTA")]
    jplace_close(ref.place(short), port.place(short))
    long = [("long", (reads[0][1] * 820)[:65_536]), ("r1", reads[1][1]),
            ("amb", reads[-4][1])]
    assert len(long[0][1]) == 65_536
    jplace_close(ref.place(long), port.place(long))


def test_databases_that_take_the_other_planes():
    """Scores below log10(eps) take the classic plane; an empty database and
    k = 13 the unpaired shifted plane; each places as the oracle and the
    JAX placer do."""
    below = build_db({"ACG": [(0, 0.0), (2, -2.0)], "CGT": [(1, -0.5)]}, TREE, kmer_size=3)
    empty = build_db({}, TREE, kmer_size=5)
    big_k = random_db(num_leaves=8, kmer_size=13, num_kmers=50, seed=2)
    for db, reads, shifted in (
            (below, [("r", b"ACGT"), ("s", b"TTACGTT"), ("n", b"ANGT")], False),
            (empty, [("r", b"ACGTACGT"), ("s", b"AC")], True),
            (big_k, [("r", b"ACGTACGTACGTACGTAC"), ("s", b"AC")], True)):
        tree = parse_newick(db.tree())
        port = TorchPlacer(db, tree, device="cpu")
        assert port.route == "dense" and port._shifted == shifted and not port._paired
        got = port.place(reads)
        jplace_close(ReferencePlacer(db, tree).place(reads), got)
        if db is not big_k:  # the JAX placer's 4**13 direct table is 268 MB more
            same_placements(JaxPlacer(db, tree).place(reads), got)


def test_big_k_classic_plane_places():
    """DNA k = 14 has no direct table: on the shifted plane it takes the codes
    tokenizer (``tests/test_torch_amino.py``), on the classic plane the host
    tokenizer, as in JAX, and places as the oracle does."""
    db = random_db(num_leaves=8, kmer_size=14, num_kmers=40, seed=3)
    tree = parse_newick(db.tree())
    port = TorchPlacer(db, tree, config=PlacerConfig(plane_mode="classic"), device="cpu")
    assert port.route == "dense" and not port._fast_bytes and not port._shifted
    reads = [("r", b"ACGTACGTACGTACGTACGT"), ("s", b"ACG")]
    jplace_close(ReferencePlacer(db, tree).place(reads), port.place(reads))


@pytest.mark.parametrize("field,value", [("precision", "int16"), ("tokenize_where", "host")])
def test_tiles_need_exact_device_tokenized_configs(fx, field, value):
    """As in JAX (placer.py:1835-1846, parallel/sharding.py:980-988), the
    posting tiles take only ``precision="exact"`` with the device tokenizer:
    with ``dense_db="off"`` another value takes the CSR route, on one device
    and on a mesh, and places as the oracle does."""
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, tree, reads, oracle = fx
    cfg = PlacerConfig(dense_db="off", **{field: value})
    port = TorchPlacer(db, tree, config=cfg, device="cpu")
    assert port.route == "csr"
    jplace_close(oracle, port.place(reads))
    mesh = make_mesh(n_data=1, n_model=1, devices=[torch.device("cpu")])
    assert ShardedTorchPlacer(db, tree, mesh, config=cfg).route == "csr"
