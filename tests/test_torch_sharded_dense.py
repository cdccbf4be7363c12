"""The column-sharded dense engine of the port on the CPU, held to the JAX package.

* ``shard_db_columns`` and the placer's per-shard planes (``engine/state.py::
  build_plane_shard``), base and pair rows, bit-equal to the column blocks of
  ``ShardedJaxPlacer._plane_cols``.
* The column finish: the shifted one (the plain version of the per-shard
  kernel ``kernels/finish_cols.py`` and the merge) and the classic one with
  counts against JAX's ``finish_scores_cols_shifted`` / ``finish_scores_cols``
  under ``shard_map``, on engineered rows: ids, n and zero_sum equal, scores
  within 1 ulp (XLA contracts a multiply-add under jit), log_sum within rtol
  1e-6.
* Each dense step (bytes shifted and classic, paired, rows shifted and
  classic) on the JAX placer's planes against the JAX step: window-order sums
  differ from XLA's chunked sums by f32 reordering, so scores and log_sum
  within rtol 1e-6 + 1e-5; n and zero_sum equal; ids equal except at
  near-ties.
* ``ShardedTorchPlacer`` with the default config, and with the classic plane,
  ``precision="int16"`` (the classic f32 plane, as in JAX), the host
  tokenizer and a k = 14 database, against ``ShardedJaxPlacer`` and the
  scalar oracle (score sets within 1e-4), and through ``run_pipeline``.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's meshes
repeat the CPU device. Inputs come from seeded numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from epik_tpu.core.tree import parse_newick, to_newick
from epik_tpu.engine import placer as jax_placer_mod
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import reads_from_reference, reference_like_db
from epik_tpu.io.jplace import jplace_writer as jax_jplace_writer
from epik_tpu.parallel import sharding as jax_sharding
from epik_tpu.parallel.mesh import MODEL_AXIS as JAX_MODEL
from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.pipeline import run_pipeline
from epik_tpu_torch.io.jplace import jplace_writer
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.finish_cols import (
    finish_cols_partial,
    finish_cols_partial_plain,
    shifted_corrected,
)
from epik_tpu_torch.parallel import sharding
from epik_tpu_torch.parallel.mesh import make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from epik_tpu_torch.tools.jplace_diff import jplace_diff
from test_pipeline import _ListReader
from test_torch_placer import assert_jplace_close
from test_torch_sharding import _check_pack
from torch_fixtures import finish_rows

CPU8 = [torch.device("cpu")] * 8
LOG_EPS = -4.2597
F32 = np.float32


@pytest.fixture(scope="module")
def fx():
    """``tests/test_sharding.py::TestShardedPairPlane._fixture``: 48 leaves,
    k = 8, 101 bp reads, an IUPAC read, a read shorter than k, a no-hit read."""
    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=61)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 40, length=101, mutation_rate=0.05, seed=62)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    return db, ref, tree, reads


def _port(db, tree, n_data, n_model, **kw):
    return ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=CPU8),
                              config=PlacerConfig(**kw))


def _jax(db, tree, n_data, n_model, **kw):
    return jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(n_data, n_model),
                                         config=JaxConfig(**kw))


def _jax_blocks(jp) -> list[np.ndarray]:
    """The JAX placer's 2-D column-sharded plane cut into its shards' blocks."""
    plane = np.asarray(jp._plane_cols)
    bwl = jp._bwl
    return [np.ascontiguousarray(plane[:, m * bwl:(m + 1) * bwl]) for m in range(jp.n_model)]


# ---- database partitioning ----------------------------------------------------------


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("shifted", [True, False])
def test_shard_db_columns_matches_jax(fx, n_model, shifted):
    db, _, tree, _ = fx
    B = tree.get_node_count()
    mine, bwl = sharding.shard_db_columns(db, n_model, B, shifted=shifted, log_eps=LOG_EPS)
    want, bwl_j = jax_sharding.shard_db_columns(db, n_model, B, shifted=shifted,
                                                log_eps=LOG_EPS)
    assert bwl == bwl_j == -(-B // (128 * n_model)) * 128
    assert mine.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(mine.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("mode", ["shifted", "classic"])
def test_placer_planes_match_jax(fx, n_model, mode):
    """The placer's shards, built on their device, bit for bit the JAX
    placer's column blocks: the shifted pair plane (base and pair rows) and
    the classic unpaired plane."""
    db, _, tree, _ = fx
    port = _port(db, tree, 1, n_model, plane_mode=mode)
    jp = _jax(db, tree, 1, n_model, plane_mode=mode)
    assert port.route == "dense" and jp._dense_db
    assert port._paired == jp._paired == (mode == "shifted")
    assert port._shifted == jp._shifted == (mode == "shifted")
    assert port._bwl == jp._bwl
    for m, want in enumerate(_jax_blocks(jp)):
        got = port._planes[0][m]
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if port._paired:
        np.testing.assert_array_equal(port._table[0][0].numpy(), np.asarray(jp._dev_combo))


# ---- the column finish ----------------------------------------------------------------


def _finish_inputs(R=64, B=500, n_cols=512):
    """Engineered shifted sums (R, n_cols), the columns past B never touched:
    finish_rows' n = 0, n < K, ties at the K cut, Q1 and Q3 rows, then ties
    that cross the 128- and 256-column shard boundaries at the K cut, a read
    with nothing touched in columns [128, 256) and one touched only there."""
    rng = np.random.default_rng(17)
    Sp_b, m = finish_rows(rng, R, B)
    Sp = np.zeros((R, n_cols), F32)
    Sp[:, :B] = Sp_b
    Sp[6] = 0.0
    Sp[6, 120:136] = 7.5
    Sp[6, 250:262] = 7.5
    Sp[6, 300] = 9.0
    Sp[7, 128:256] = 0.0
    Sp[8] = 0.0
    Sp[8, 130:140] = np.arange(1, 11, dtype=F32)
    return Sp, m


def _jax_cols_finish(mesh, fn, arrays, pack):
    """``fn`` (JAX's column finish) under ``shard_map``: the (R, n_cols)
    arrays split by columns over the model axis, m replicated."""
    def block(*args):
        return pack(fn(*args))

    specs = tuple(P(None, JAX_MODEL) for _ in arrays[:-1]) + (P(),)
    f = jax.jit(jax.shard_map(block, mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False))
    return np.asarray(f(*(jnp.asarray(a) for a in arrays)))


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_column_finish_shifted_matches_jax(n_model):
    """The plain per-shard finish and the merge against JAX's
    ``finish_scores_cols_shifted``: every id (the -inf slots hold the lowest
    untouched columns), n and zero_sum equal, scores within 1 ulp, log_sum
    within rtol 1e-6; each shard's partial pack from the wrapper equal to the
    plain version (no launch on the CPU), its exp-sum e_s against a float64
    sum of 10**(corrected - max_s) over the shard's touched columns."""
    B, K, k = 500, 7, 10
    Sp, m = _finish_inputs(B=B)
    bwl = Sp.shape[1] // n_model
    kw = dict(B=B, K=K, k=k, log_eps=LOG_EPS)
    want = _jax_cols_finish(
        jax_make_mesh(1, n_model),
        lambda sp, mm: jax_sharding.finish_scores_cols_shifted(sp, mm, **kw),
        (Sp, m), jax_placer_mod._pack_outputs_slim)
    Sps = [torch.from_numpy(np.ascontiguousarray(Sp[:, s * bwl:(s + 1) * bwl]))
           for s in range(n_model)]
    m_t = torch.from_numpy(m)
    reset_launch_counts()
    got = sharding._pack_slim(sharding.finish_scores_cols_shifted(Sps, m_t, **kw)).numpy()
    assert not any(launch_counts().values())
    assert got.shape == want.shape == (Sp.shape[0], 2 * K + 3)
    # XLA contracts the correction's multiply-add into an FMA under jit: 1 ulp
    np.testing.assert_allclose(got[:, :K], want[:, :K], rtol=2.5e-7)
    np.testing.assert_array_equal(got[:, K:2 * K], want[:, K:2 * K])
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6)
    assert got[0, 2 * K + 1] == 0 and got[1, 2 * K + 1] == 2 and got[5, 2 * K + 2] == 1
    # the ties across the shard boundaries go to the lowest global column
    np.testing.assert_array_equal(got[6, K:2 * K], [300, 120, 121, 122, 123, 124, 125])
    Kl = min(K, bwl)
    for s, S_s in enumerate(Sps):
        part = finish_cols_partial(S_s, m_t, K=K, k=k, log_eps=LOG_EPS, col0=s * bwl)
        assert torch.equal(part, finish_cols_partial_plain(S_s, m_t, K=K, k=k, log_eps=LOG_EPS,
                                                           col0=s * bwl))
        assert part.shape == (Sp.shape[0], 2 * Kl + 3)
        c, touched = shifted_corrected(S_s, m_t, k=k, log_eps=LOG_EPS)  # the f32 scores
        c = c.numpy().astype(np.float64)
        max_s = part[:, 2 * Kl + 1].numpy().astype(np.float64)
        with np.errstate(invalid="ignore"):  # rows with nothing touched: max_s = -inf
            want_e = np.where(touched.numpy(), 10.0 ** (c - max_s[:, None]), 0.0).sum(axis=1)
        np.testing.assert_allclose(part[:, 2 * Kl + 2].numpy(), want_e, rtol=1e-6)
        assert (part[:, 2 * Kl] == 0).any() and (part[part[:, 2 * Kl] == 0, 2 * Kl + 2] == 0).all()


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_column_finish_classic_matches_jax(n_model):
    """The classic column finish with counts against JAX's
    ``finish_scores_cols`` (the full pack): ids, counts, n and zero_sum equal,
    scores within 1 ulp, wr within rtol 1e-4; counts above m take the Q1 wrap."""
    B, K, k = 500, 7, 10
    S, m = _finish_inputs(B=B)
    rng = np.random.default_rng(18)
    C = np.where(S > 0, rng.integers(1, 4, S.shape), 0).astype(np.int32)
    S = np.where(S > 0, S - 40.0, 0.0).astype(F32)  # classic sums are negative
    m[9] = 1.0  # C > m on touched columns: the size_t wrap
    C[9, :B] = np.where(S[9, :B] != 0, 3, 0)
    bwl = S.shape[1] // n_model
    kw = dict(B=B, K=K, k=k, log_eps=LOG_EPS)
    want = _jax_cols_finish(
        jax_make_mesh(1, n_model),
        lambda s_, c_, mm: jax_sharding.finish_scores_cols(s_, c_, mm, **kw),
        (S, C, m), lambda outs: jax_placer_mod._pack_outputs(outs, jnp.int32(0), jnp.int32(0)))
    cols = [slice(s * bwl, (s + 1) * bwl) for s in range(n_model)]
    got = sharding.pack_outputs(sharding.finish_scores_cols(
        [torch.from_numpy(np.ascontiguousarray(S[:, c])) for c in cols],
        [torch.from_numpy(np.ascontiguousarray(C[:, c])) for c in cols],
        torch.from_numpy(m), **kw), 0, 0).numpy()
    assert got.shape == want.shape == (S.shape[0] + 1, 4 * K + 2)
    # ids, counts, n, zero_sum equal; scores within 1 ulp (XLA's FMA under jit)
    np.testing.assert_array_equal(got[:-1, 2 * K:], want[:-1, 2 * K:])
    np.testing.assert_allclose(got[:-1, :K], want[:-1, :K], rtol=2.5e-7)
    # wr = 10**(score - log_sum): log_sum's rtol 1e-6 (another order of the
    # exp-sum's adds) at |log_sum| <= 40 moves wr by up to ln 10 * 4e-5
    np.testing.assert_allclose(got[:-1, K:2 * K], want[:-1, K:2 * K], rtol=1e-4, atol=1e-30)


# ---- the steps on the JAX placer's state ----------------------------------------------


def _check_full(got, want, K):
    """The classic full pack (rows without the totals row): n and zero_sum
    equal; scores and wr within rtol 1e-6 + 1e-5 (f32 sums in another order);
    ids and counts equal wherever the score is not within 1e-5 of another of
    the row's top K."""
    np.testing.assert_array_equal(got[:, 4 * K:], want[:, 4 * K:])
    n = want[:, 4 * K].astype(int)
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    assert live.any()
    for lo in (0, K):
        np.testing.assert_allclose(got[:, lo:lo + K][live], want[:, lo:lo + K][live],
                                   rtol=1e-6, atol=1e-5)
    s = want[:, :K]
    with np.errstate(invalid="ignore"):  # -inf - -inf in the dead slots
        tied = ((np.abs(s[:, :, None] - s[:, None, :]) <= 1e-5) & live[:, None, :]).sum(2) > 1
    untied = live & ~tied
    assert untied.any()
    for lo in (2 * K, 3 * K):
        np.testing.assert_array_equal(got[:, lo:lo + K][untied], want[:, lo:lo + K][untied])


STEPS = ["bytes_shifted", "bytes_classic", "paired", "rows_shifted", "rows_classic"]


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind", STEPS)
def test_dense_step_matches_jax(fx, kind, n_data, n_model):
    """Each column-sharded dense step on the JAX placer's own planes and
    tables and the port's staging of the batch, against the JAX step."""
    db, _, tree, reads = fx
    cfg = {"bytes_shifted": dict(pair_plane="off"), "bytes_classic": dict(plane_mode="classic"),
           "rows_shifted": dict(tokenize_where="host"),
           "rows_classic": dict(plane_mode="classic", tokenize_where="host")}.get(kind, {})
    jp = _jax(db, tree, n_data, n_model, **cfg)
    pp = _port(db, tree, n_data, n_model, **cfg)
    assert jp._paired == pp._paired == (kind == "paired")
    seqs = list(dict.fromkeys(s for _, s in reads))
    R_true = len(seqs)
    R = pp._padded_batch_geometry(R_true)
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=R_true)
    planes = [torch.from_numpy(b) for b in _jax_blocks(jp)]
    K = min(7, pp.B)
    kw = dict(B=pp.B, K=K, k=pp.k, log_eps=float(pp.log_eps), eps=float(pp.eps))
    jkw = dict(kw, mesh=jp.mesh, R=R, bwl=jp._bwl)
    shifted = jp._shifted
    if kind.startswith("rows"):
        tok = pp._tokenize(seqs)
        Wmax = -(-int(np.bincount(tok.exact_read).max()) // 16) * 16
        Amax = -(-int(np.bincount(tok.amb_read).max()) // 8) * 8
        rows = pp._rows_matrix(tok.exact_keys, tok.exact_read, n_data * R, Wmax)
        arows = pp._rows_matrix(tok.amb_keys, tok.amb_read, n_data * R, Amax)
        m_pad = np.zeros(n_data * R, F32)
        m_pad[:R_true] = np.where(lens >= pp.k, lens - pp.k + 1, 2.0**64).astype(F32)
        want = np.asarray(jax_sharding._sharded_dense_rows_step(
            jp._plane_cols, rows, arows, m_pad, Wmax=Wmax, Amax=Amax, shifted=shifted, **jkw))
        got = [sharding.sharded_dense_rows_step(
            planes, torch.from_numpy(rows[d * R:(d + 1) * R]),
            torch.from_numpy(arows[d * R:(d + 1) * R]), torch.from_numpy(m_pad[d * R:(d + 1) * R]),
            Amax=Amax, zero_row=db.num_kmers, shifted=shifted, **kw) for d in range(n_data)]
    else:
        Lmax = -(-int(lens.max()) // 8) * 8
        buf, amb_mask = pp._pack_reads_fast(seqs, lens, Lmax, n_data * R)
        arows, Amax = pp._amb_rows(seqs, amb_mask, n_data * R)
        assert Amax > 0
        step_kw = dict(Amax=Amax, Lmax=Lmax, num_kmers=db.num_kmers)
        if kind == "paired":
            table = np.asarray(jp._dev_combo)
            want = np.asarray(jax_sharding._sharded_dense_paired_step(
                jp._plane_cols, table, buf, arows, **step_kw, **jkw))
            step = sharding.sharded_dense_paired_step
        else:
            table = np.asarray(jp._dev_direct)
            want = np.asarray(jax_sharding._sharded_dense_bytes_step(
                jp._plane_cols, table, buf, arows, shifted=shifted, **step_kw, **jkw))
            step = lambda *a, **k_: sharding.sharded_dense_bytes_step(*a, shifted=shifted, **k_)
        tables = [torch.from_numpy(table)] * n_model
        got = [step(planes, tables, torch.from_numpy(buf[d * R:(d + 1) * R]),
                    torch.from_numpy(arows[d * R:(d + 1) * R]), **step_kw, **kw)
               for d in range(n_data)]
    got = np.stack([g.numpy() for g in got])
    assert got.shape == want.shape
    if shifted:
        assert got.shape[2] == 2 * K + 3
        _check_pack(got.reshape(-1, 2 * K + 3), want.reshape(-1, 2 * K + 3), K, atol=1e-5)
    else:
        assert got.shape == (n_data, R + 1, 4 * K + 2)
        _check_full(got[:, :-1].reshape(-1, 4 * K + 2), want[:, :-1].reshape(-1, 4 * K + 2), K)


# ---- the placer --------------------------------------------------------------------------


PLACER_CASES = [
    ((1, 1), {}), ((2, 2), {}), ((1, 4), {}), ((4, 2), {}),
    ((2, 2), {"plane_mode": "classic"}),
    ((1, 4), {"precision": "int16"}),
    ((2, 2), {"tokenize_where": "host"}),
]


@pytest.mark.parametrize("mesh,cfg", PLACER_CASES,
                         ids=[f"{a}x{b}-{'-'.join(c.values()) or 'default'}"
                              for (a, b), c in PLACER_CASES])
def test_sharded_dense_placer_matches_jax_and_oracle(fx, mesh, cfg):
    """The dense route places within 1e-4 (score sets) of ShardedJaxPlacer
    and of the oracle; the flags are JAX's (``precision="int16"`` gives the
    classic f32 plane in the sharded engine)."""
    db, _, tree, reads = fx
    port = _port(db, tree, *mesh, **cfg)
    jp = _jax(db, tree, *mesh, **cfg)
    assert port.route == "dense" and jp._dense_db
    assert (port._shifted, port._paired, port._fast_bytes) == (
        jp._shifted, jp._paired, jp._fast_bytes)
    assert port._planes[0][0].dtype == torch.float32
    if cfg.get("precision") == "int16":
        assert not port._shifted
    reset_launch_counts()
    out = port.place(reads)
    assert not any(launch_counts().values())  # the CPU runs the plain versions
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    assert_jplace_close(jp.place(reads), out)


def test_sharded_dense_placer_k14_host_rows():
    """A DNA k = 14 database has no direct table: every batch takes the rows
    step (the host tokenizer), on the shifted plane, as in JAX."""
    db, ref = reference_like_db(num_leaves=20, kmer_size=14, ref_length=6_000,
                                mean_posting_len=4.0, seed=71)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 12, length=90, mutation_rate=0.03, seed=72)
    reads += [("amb", reads[0][1][:20] + b"N" + reads[0][1][21:]), ("short", b"ACGT")]
    port = _port(db, tree, 2, 2)
    jp = _jax(db, tree, 2, 2)
    assert port.route == "dense" and not port._fast_bytes and not jp._fast_bytes
    assert port._shifted == jp._shifted
    out = port.place(reads)
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    assert_jplace_close(jp.place(reads), out)


def test_sharded_dense_reads_past_the_device_tokenizer(fx):
    """A batch of reads shorter than k and a batch with a 66,000 bp read (past
    the packed format's uint16 length) take the rows step."""
    db, ref, tree, reads = fx
    port = _port(db, tree, 1, 2)
    short = [("s1", b"AC"), ("s2", b"ACGTA")]
    long = [("long", (reads[3][1] * 700)[:66_000]), ("r", reads[4][1])]
    oracle = ReferencePlacer(db, tree)
    for batch in (short, long):
        assert_jplace_close(oracle.place(batch), port.place(batch), per_edge=True)


def test_dense_on_over_budget_raises(fx):
    db, _, tree, _ = fx
    with pytest.raises(ValueError, match="over the budget"):
        _port(db, tree, 1, 2, dense_db="on", dense_db_budget=1000)
    assert _port(db, tree, 1, 2, dense_db_budget=1000).route != "dense"


def test_sharded_dense_pipeline_matches_jax(fx, tmp_path):
    """run_pipeline (inflight 3) over a 2x2 mesh on the dense route with the
    port's jplace writer; ``tools/jplace_diff`` finds the file equal to the
    JAX sharded placer's at 1e-4, both ways."""
    db, _, tree, reads = fx
    batches = [reads[i:i + 16] for i in range(0, len(reads), 16)]
    nwk = to_newick(tree, jplace_edges=True)
    runs = ((_port(db, tree, 2, 2), jplace_writer, "port.jplace"),
            (_jax(db, tree, 2, 2), jax_jplace_writer, "jax.jplace"))
    for placer, writer_cls, name in runs:
        w = writer_cls(str(tmp_path / name), "inv ", nwk)
        w.start()
        stats = run_pipeline(placer, _ListReader(batches), w, inflight=3)
        w.end()
        assert stats.num_seq_placed == len(reads)
    a, b = str(tmp_path / "port.jplace"), str(tmp_path / "jax.jplace")
    for x, y in ((a, b), (b, a)):
        res = jplace_diff(x, y)
        assert res.clean, res.mismatches[:3]
