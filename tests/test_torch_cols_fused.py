"""The column finish in one launch per shard, and kernel 1 with it fused in, on the CPU.

* ``rowgather_sum_cols_plain`` / ``rowgather_sum_counts_cols_plain`` (the
  plain versions of kernel 1 with one shard's column finish in its epilogue)
  bit-equal to the gather (held to window-order numpy sums), the ambiguous
  adds and the plain column finish (``finish_cols_partial[_counts]_plain``),
  with and without ambiguous reads, at shard widths 128, 384 and 1,408; the
  wrappers take the plain versions on CPU tensors and count no launch.
* The partial pack's new column ``e_s`` (each shard's sum of
  ``10**(corrected - max_s)`` against its own maximum) against a float64 sum
  of the same f32 corrected scores, rtol 1e-6, 0 where nothing is touched.
* The rescaled merge (``parallel/sharding.py::_merge_cols``) against JAX's
  ``_lwr_topk_cols`` through ``finish_scores_cols[_shifted]`` under
  ``shard_map`` on the conftest's virtual CPU devices, at n_model 1, 2 and 4,
  on rows with a shard that touches nothing and a Q1-wrapped read: ids, n,
  counts and zero_sum equal, scores within 1 ulp (XLA contracts the
  correction into an FMA under jit), log_sum within rtol 1e-6, wr within rtol
  1e-4; on one shard the rescale multiplies by exactly 1.
* ``_dense_step``'s routing: within the limits one fused kernel per shard; with
  ``cols_fits`` / ``counts_cols_fits`` patched to refuse (as past the card's
  shared memory), the gather, the adds and the column finish apart, the same
  packs bit for bit, on every sharded dense step of the placer.

Inputs come from seeded numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.engine import placer as jax_placer_mod
from epik_tpu.parallel import sharding as jax_sharding
from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh

from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.finish_cols import (
    counts_corrected,
    finish_cols_partial,
    finish_cols_partial_counts,
    finish_cols_partial_counts_plain,
    finish_cols_partial_plain,
    shifted_corrected,
)
from epik_tpu_torch.kernels.rowgather import (
    add_first_hits,
    cols_fits,
    counts_cols_fits,
    rowgather_sum,
    rowgather_sum_cols,
    rowgather_sum_cols_plain,
    rowgather_sum_counts,
    rowgather_sum_counts_cols,
    rowgather_sum_counts_cols_plain,
)
from epik_tpu_torch.parallel import sharding
from test_torch_sharded_dense import _finish_inputs, _jax_cols_finish, _port
from torch_fixtures import counts_rows, finish_rows

LOG_EPS = -4.2597
KW = dict(K=7, k=10, log_eps=LOG_EPS)


def _shard_case(bwl: int, amb: bool, counts: bool, seed: int):
    """One shard's f32 plane (the last row the all-zero miss row, a few
    padded columns never touched), rows with misses and a read of misses
    only, m with a Q1-wrapped read, and the ambiguous first hits of a third
    of the reads: shifted, delta rows; classic, (dS, hit)."""
    rng = np.random.default_rng(seed)
    n_rows, R, W = 160, 48, 23
    if counts:  # the classic plane: log10 scores, negative
        plane = rng.uniform(-7.0, -0.01, (n_rows, bwl)).astype(np.float32)
    else:  # the shifted plane: score - log10(eps), positive
        plane = rng.uniform(0.0, 8.0, (n_rows, bwl)).astype(np.float32)
    plane[rng.random(plane.shape) > 0.3] = 0.0
    plane[:, bwl - 5:] = 0.0
    plane[-1] = 0.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = n_rows - 1
    rows[0] = n_rows - 1
    m = rng.integers(W, W + 40, R).astype(np.float32)
    m[1] = np.float32(2.0**64)
    m[2] = 1.0  # classic: counts above m wrap (quirk Q1)
    t = [torch.from_numpy(plane), torch.from_numpy(rows), torch.from_numpy(m)]
    if not amb:
        return (*t, None, None, None)
    reads = torch.from_numpy(np.sort(rng.choice(np.arange(1, R), R // 3, replace=False)))
    hit = rng.random((reads.numel(), bwl)) < 0.2
    hit[:, bwl - 5:] = False
    lo, hi = (-3.0, 0.0) if counts else (-2.0, 6.0)
    delta = np.where(hit, rng.uniform(lo, hi, hit.shape), 0.0).astype(np.float32)
    return (*t, reads, torch.from_numpy(delta), torch.from_numpy(hit))


def _window_sums(plane, rows):
    """S and C by numpy adds in window order, one row after another."""
    p, r = plane.numpy(), rows.numpy()
    S = np.zeros((r.shape[0], p.shape[1]), np.float32)
    C = np.zeros(S.shape, np.int32)
    for w in range(r.shape[1]):
        S += p[r[:, w]]
        C += p[r[:, w]] != 0
    return torch.from_numpy(S), torch.from_numpy(C)


# ---- kernel 1 with the column finish fused in: its plain version -------------------------


@pytest.mark.parametrize("bwl", [128, 384, 1408])
@pytest.mark.parametrize("amb", [True, False])
def test_rowgather_sum_cols_plain_is_the_composition(bwl, amb):
    """The shifted form: the gather, the delta rows added at the ambiguous
    reads, then the plain column finish, bit for bit (and the wrapper)."""
    plane, rows, m, reads, delta, _ = _shard_case(bwl, amb, False, bwl)
    col0 = 3 * bwl
    Sp = rowgather_sum(plane, rows)
    S_np, _ = _window_sums(plane, rows)
    assert torch.equal(Sp, S_np)
    if amb:
        Sp[reads] = Sp[reads] + delta
    want = finish_cols_partial(Sp, m, col0=col0, **KW)
    reset_launch_counts()
    got = rowgather_sum_cols(plane, rows, m, reads, delta, col0=col0, **KW)
    assert not any(launch_counts().values())
    assert got.shape == (rows.shape[0], 2 * 7 + 3)
    assert torch.equal(got, want)
    assert torch.equal(rowgather_sum_cols_plain(plane, rows, m, reads, delta, col0=col0, **KW),
                       want)
    n = got[:, 14]
    assert n[0] == 0 and (n > 0).sum() > rows.shape[0] // 2
    ids = got[:, 7:14]
    assert ((ids >= col0) & (ids < col0 + bwl)).all()
    if amb:  # the delta rows changed the ambiguous reads' packs
        plain = finish_cols_partial_plain(rowgather_sum(plane, rows), m, col0=col0, **KW)
        assert not torch.equal(plain[reads], got[reads])


@pytest.mark.parametrize("bwl", [128, 384, 1408])
@pytest.mark.parametrize("amb", [True, False])
def test_rowgather_sum_counts_cols_plain_is_the_composition(bwl, amb):
    """The counts form: the gather with counts, the first hits added (S + dS,
    C + hit), then the plain counts column finish, bit for bit, the
    candidates' counts equal C at their columns."""
    plane, rows, m, reads, dS, hit = _shard_case(bwl, amb, True, bwl + 1)
    col0 = bwl
    S, C = rowgather_sum_counts(plane, rows)
    S_np, C_np = _window_sums(plane, rows)
    assert torch.equal(S, S_np) and torch.equal(C, C_np)
    if amb:
        S, C = S.clone(), C.clone()
        S[reads] = S[reads] + dS
        C[reads] = C[reads] + hit.to(torch.int32)
    want, want_c = finish_cols_partial_counts(S, C, m, col0=col0, **KW)
    reset_launch_counts()
    got, got_c = rowgather_sum_counts_cols(plane, rows, m, reads, dS, hit, col0=col0, **KW)
    assert not any(launch_counts().values())
    assert torch.equal(got, want) and torch.equal(got_c, want_c)
    plain, plain_c = rowgather_sum_counts_cols_plain(plane, rows, m, reads, dS, hit, col0=col0,
                                                     **KW)
    assert torch.equal(plain, want) and torch.equal(plain_c, want_c)
    assert got_c.dtype == torch.int32 and got_c.shape == (rows.shape[0], 7)
    local = got[:, 7:14].long() - col0
    assert torch.equal(got_c, torch.gather(C, 1, local))
    assert ((got_c > 0) == (torch.arange(7)[None, :] < got[:, 14:15])).all()


def test_cols_wrappers_check_inputs():
    plane, rows, m, reads, delta, hit = _shard_case(128, True, True, 5)
    with pytest.raises(ValueError, match="K="):
        rowgather_sum_cols(plane, rows, m, None, None, K=65, k=10, log_eps=LOG_EPS, col0=0)
    with pytest.raises(ValueError, match="col0"):
        rowgather_sum_cols(plane, rows, m, None, None, col0=-1, **KW)
    with pytest.raises(ValueError, match="together"):
        rowgather_sum_counts_cols(plane, rows, m, reads, delta, None, col0=0, **KW)
    with pytest.raises(ValueError, match="amb_delta"):
        rowgather_sum_cols(plane, rows, m, reads, delta[:, :64].contiguous(), col0=0, **KW)
    with pytest.raises(ValueError, match="m_f32"):
        rowgather_sum_cols(plane, rows, m[:-1], None, None, col0=0, **KW)
    with pytest.raises(ValueError):
        rowgather_sum_cols(plane.to(torch.bfloat16), rows, m, None, None, col0=0, **KW)
    S, C = rowgather_sum_counts(plane, rows)
    with pytest.raises(ValueError, match="C must be int32"):
        finish_cols_partial_counts(S, C.long(), m, col0=0, **KW)
    assert cols_fits(plane, 7) and counts_cols_fits(plane, 7)  # no limit on the CPU


# ---- the partial pack's exp-sum ------------------------------------------------------------


@pytest.mark.parametrize("form", ["shifted", "counts"])
@pytest.mark.parametrize("B", [300, 1303])
def test_partial_expsum_against_float64(form, B):
    """e_s = sum over the touched columns of 10**(corrected - max_s), the
    corrected scores as the finish rounds them in f32, against a float64 sum
    (rtol 1e-6); max_s the largest corrected score; n_s = 0 gives e_s = 0
    and max_s = -inf."""
    rng = np.random.default_rng(B)
    if form == "shifted":
        Sp, m = (torch.from_numpy(x) for x in finish_rows(rng, 40, B))
        part = finish_cols_partial(Sp, m, col0=0, **KW)
        c, touched = shifted_corrected(Sp, m, k=10, log_eps=LOG_EPS)
    else:
        S, C, m = (torch.from_numpy(x) for x in counts_rows(rng, 40, B))
        part, _ = finish_cols_partial_counts(S, C, m, col0=0, **KW)
        c, touched = counts_corrected(S, C, m, k=10, log_eps=LOG_EPS)
    assert part.shape == (40, 2 * 7 + 3)
    n_s, max_s, e_s = part[:, 14], part[:, 15], part[:, 16]
    assert torch.equal(n_s, touched.sum(dim=1).to(torch.float32))
    assert torch.equal(max_s, c.max(dim=1).values)
    c64 = c.numpy().astype(np.float64)
    with np.errstate(invalid="ignore"):
        want = np.where(touched.numpy(), 10.0 ** (c64 - max_s.numpy()[:, None]), 0.0).sum(1)
    np.testing.assert_allclose(e_s.numpy(), want, rtol=1e-6)
    empty = n_s == 0
    assert empty.any() and (e_s[empty] == 0).all() and (max_s[empty] == -np.inf).all()
    assert (e_s[~empty] >= 1.0).all()  # the maximum's own term is 1


# ---- the rescaled merge against JAX ---------------------------------------------------------


def _classic_inputs(B):
    """The classic sums and counts of ``_finish_inputs``' rows: a shard that
    touches nothing, reads touched in one shard only, C > m (the Q1 wrap)."""
    S, m = _finish_inputs(B=B)
    rng = np.random.default_rng(18)
    C = np.where(S > 0, rng.integers(1, 4, S.shape), 0).astype(np.int32)
    S = np.where(S > 0, S - 40.0, 0.0).astype(np.float32)
    m[9] = 1.0
    C[9, :B] = np.where(S[9, :B] != 0, 3, 0)
    return S, C, m


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("form", ["shifted", "counts"])
def test_rescaled_merge_matches_jax(n_model, form):
    """One launch per shard, then the merge rescaling each e_s by 10**(max_s
    - max_t), against JAX's column finish (each term taken against the global
    max_t) under shard_map."""
    B = 500
    K, kw = 7, dict(B=500, K=7, k=10, log_eps=LOG_EPS)
    mesh = jax_make_mesh(1, n_model)
    if form == "shifted":
        Sp, m = _finish_inputs(B=B)
        want = _jax_cols_finish(
            mesh, lambda sp, mm: jax_sharding.finish_scores_cols_shifted(sp, mm, **kw),
            (Sp, m), jax_placer_mod._pack_outputs_slim)
        bwl = Sp.shape[1] // n_model
        parts = [torch.from_numpy(np.ascontiguousarray(Sp[:, s * bwl:(s + 1) * bwl]))
                 for s in range(n_model)]
        got = sharding._pack_slim(sharding.finish_scores_cols_shifted(
            parts, torch.from_numpy(m), **kw)).numpy()
        np.testing.assert_allclose(got[:, :K], want[:, :K], rtol=2.5e-7)
        np.testing.assert_array_equal(got[:, K:2 * K], want[:, K:2 * K])
        np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
        np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6)
        n_s = [finish_cols_partial(p, torch.from_numpy(m), col0=0, **KW)[:, -3] for p in parts]
    else:
        S, C, m = _classic_inputs(B)
        want = _jax_cols_finish(
            mesh, lambda s_, c_, mm: jax_sharding.finish_scores_cols(s_, c_, mm, **kw),
            (S, C, m),
            lambda outs: jax_placer_mod._pack_outputs(outs, jnp.int32(0), jnp.int32(0)))
        bwl = S.shape[1] // n_model
        cols = [slice(s * bwl, (s + 1) * bwl) for s in range(n_model)]
        S_t = [torch.from_numpy(np.ascontiguousarray(S[:, c])) for c in cols]
        C_t = [torch.from_numpy(np.ascontiguousarray(C[:, c])) for c in cols]
        got = sharding.pack_outputs(sharding.finish_scores_cols(S_t, C_t, torch.from_numpy(m),
                                                                **kw), 0, 0).numpy()
        np.testing.assert_array_equal(got[:-1, 2 * K:], want[:-1, 2 * K:])
        np.testing.assert_allclose(got[:-1, :K], want[:-1, :K], rtol=2.5e-7)
        np.testing.assert_allclose(got[:-1, K:2 * K], want[:-1, K:2 * K], rtol=1e-4, atol=1e-30)
        n_s = [finish_cols_partial_counts(a, b, torch.from_numpy(m), col0=0, **KW)[0][:, -3]
               for a, b in zip(S_t, C_t)]
    assert np.isfinite(got[:, :K][got[:, :K] > -np.inf]).all()
    if n_model > 1:  # a read whose shard touches nothing, another shard touched
        assert any(bool(((n == 0) & (sum(n_s) > 0)).any()) for n in n_s)


def test_merge_on_one_shard_multiplies_by_one():
    """On one shard of the shifted plane every read with a touched branch has
    max_t = max_s (Sp > 0 puts every corrected score at or above npl_exp), so the
    merged log-sum is e_s plus the untouched term, bit for bit."""
    Sp, m = (torch.from_numpy(x) for x in finish_rows(np.random.default_rng(3), 64, 700))
    part = finish_cols_partial(Sp, m, col0=0, **KW)
    outs = sharding._merge_cols([part], m, B=700, **KW)
    log_sum = outs[6]
    n, max_s, e_s = part[:, 14], part[:, 15], part[:, 16]
    f32 = torch.float32
    ln10 = torch.tensor(np.log(10.0), dtype=f32)
    npl = m * torch.tensor(LOG_EPS, dtype=f32) / torch.tensor(10.0, dtype=f32)
    n_not = 700.0 - n
    live = n > 0
    assert (max_s[live] >= npl[live]).all()
    want = max_s + torch.log(e_s + n_not * torch.exp((npl - max_s) * ln10)) / ln10
    assert torch.equal(log_sum[live], want[live])


# ---- _dense_step's routing past the fused kernels' limits ----------------------------------


ROUTED = ("rowgather_sum_cols", "rowgather_sum_counts_cols", "rowgather_sum",
          "rowgather_sum_counts", "finish_cols_partial", "finish_cols_partial_counts")


@pytest.fixture(scope="module")
def small_db():
    from epik_tpu.core.tree import parse_newick
    from epik_tpu.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=40, kmer_size=8, ref_length=20_000,
                                mean_posting_len=6.0, seed=71)
    reads = reads_from_reference(ref, 30, length=101, mutation_rate=0.05, seed=72)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("amb2", b"R" + reads[1][1][1:60] + b"Y" + reads[1][1][61:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    return db, parse_newick(db.tree()), reads


@pytest.mark.parametrize("n_model", [1, 2])
@pytest.mark.parametrize("cfg", [{}, {"plane_mode": "classic"}, {"pair_plane": "off"},
                                 {"tokenize_where": "host"},
                                 {"plane_mode": "classic", "tokenize_where": "host"}],
                         ids=["paired", "classic", "bytes", "rows", "rows-classic"])
def test_dense_step_routes_past_the_limit(small_db, monkeypatch, n_model, cfg):
    """Every sharded dense step: within the limits, one fused kernel per
    shard per step and nothing apart; with the limits patched to refuse, the
    gather, the adds and the column finish apart, per shard, the gather in
    read order over pair rows only; the placements equal bit for bit."""
    db, tree, reads = small_db
    placer = _port(db, tree, 1, n_model, **cfg)
    assert placer.route == "dense"
    calls = dict.fromkeys(ROUTED, 0)
    orders = set()
    for name in ROUTED:
        fn = getattr(sharding, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            if _name == "rowgather_sum":
                orders.add(k.get("pair_rows", False))
            return _fn(*a, **k)

        monkeypatch.setattr(sharding, name, counted)
    fused = placer.place(reads)
    fused_calls = dict(calls)
    fused_kernel = "rowgather_sum_cols" if placer._shifted else "rowgather_sum_counts_cols"
    assert fused_calls[fused_kernel] >= n_model
    assert fused_calls[fused_kernel] % n_model == 0
    assert sum(fused_calls.values()) == fused_calls[fused_kernel]
    calls.update(dict.fromkeys(ROUTED, 0))
    monkeypatch.setattr(sharding, "cols_fits", lambda plane, K: False)
    monkeypatch.setattr(sharding, "counts_cols_fits", lambda plane, K: False)
    apart = placer.place(reads)
    steps = fused_calls[fused_kernel]
    if placer._shifted:
        assert calls["rowgather_sum"] == calls["finish_cols_partial"] == steps
        assert orders == {placer._paired}
    else:
        assert calls["rowgather_sum_counts"] == calls["finish_cols_partial_counts"] == steps
    assert calls["rowgather_sum_cols"] == calls["rowgather_sum_counts_cols"] == 0
    np.testing.assert_array_equal(apart.ids, fused.ids)
    np.testing.assert_array_equal(apart.scores.view(np.int32), fused.scores.view(np.int32))
    np.testing.assert_array_equal(apart.keep, fused.keep)


def test_classic_cols_past_the_limit_is_bit_equal(monkeypatch):
    """``_classic_cols`` apart (the gather with counts, ``add_first_hits``,
    the counts finish) against the fused plain version: pack and counts bit
    for bit, ambiguous reads included."""
    plane, rows, m, reads, dS, hit = _shard_case(384, True, True, 9)
    fused = sharding._classic_cols(plane, rows, m, reads, dS, hit, col0=384, **KW)
    monkeypatch.setattr(sharding, "counts_cols_fits", lambda plane, K: False)
    apart = sharding._classic_cols(plane, rows, m, reads, dS, hit, col0=384, **KW)
    S, C = add_first_hits(*rowgather_sum_counts(plane, rows), reads, dS, hit)
    want = finish_cols_partial_counts_plain(S, C, m, col0=384, **KW)
    for a, b in zip((fused, apart), (want, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
