"""The counts finish and kernel 1 with counts and the finish fused in, on the CPU.

* ``finish_topk_counts_plain`` (the plain version of the counts finish kernel)
  against JAX ``finish_scores`` + ``_pack_outputs`` (the full pack's body) and
  ``_pack_outputs_slim`` (the slim pack of the sharded CSR steps), on rows
  with every quirk the finish carries (C > m, reads shorter than k, n = 0,
  n < K, exact ties, a Q3 row, touched cells whose sum is not negative), at
  B = 1,303 and 19,999 (neither a multiple of 32);
* ``rowgather_sum_counts_topk_plain`` (f32 and bf16) against JAX
  ``dense_sums_from_rows`` + ``_apply_amb(shifted=False)`` + ``finish_scores``
  + ``_pack_outputs`` on the JAX placer's classic plane, with and without
  ambiguous reads;
* both bit-equal to the torch composition the steps ran before
  (``rowgather_sum_counts_plain`` + ``amb_classic`` + ``ops/csr.py::
  finish_scores`` + ``pack_outputs``), and the classic step past the fused
  kernel's limit (the gather with counts and the finish apart) bit-equal to
  the fused one;
* the wrappers take the plain version on CPU tensors, count no launch, and
  raise on arguments their kernels do not take.

Tolerances are ``test_torch_dense.py::assert_pack_close``'s: scores within
1e-5, ids and counts equal where no near-tie (1e-4) hides them, wr within
rtol 1e-4, n and zero_sum exact; the slim pack's log_sum within rtol 1e-5.
"""

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
    _pack_outputs,
    _pack_outputs_slim,
    dense_sums_from_rows,
    finish_scores,
)
from epik_tpu.io.build import reads_from_reference, reference_like_db

from epik_tpu_torch.engine import step as step_mod
from epik_tpu_torch.engine.step import dense_gather, place_batch_dense_rows
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.finish import finish_topk_counts, finish_topk_counts_plain
from epik_tpu_torch.kernels.rowgather import (
    counts_topk_fits,
    rowgather_sum_counts_plain,
    rowgather_sum_counts_topk,
    rowgather_sum_counts_topk_bf16,
    rowgather_sum_counts_topk_plain,
)
from epik_tpu_torch.ops import csr as csr_mod
from epik_tpu_torch.ops.dense import amb_classic, amb_classic_deltas
from epik_tpu_torch.parallel.sharding import _pack_slim
from test_torch_dense import assert_pack_close
from torch_fixtures import counts_rows

KW = dict(k=10, log_eps=-4.2597)


def _jax_finish(S, C, m, K):
    return finish_scores(jnp.asarray(S), jnp.asarray(C), jnp.asarray(m), B=S.shape[1], K=K,
                         **KW)


# ---- the counts finish alone ------------------------------------------------------------


@pytest.mark.parametrize("R,B,K", [(40, 1303, 7), (12, 19999, 7), (9, 40, 40)])
@pytest.mark.parametrize("full", [True, False])
def test_finish_counts_plain_matches_jax(R, B, K, full):
    S, C, m = counts_rows(np.random.default_rng(B + R), R, B)
    outs = _jax_finish(S, C, m, K)
    zero = jnp.int32(0)
    want = np.asarray(_pack_outputs(outs, zero, zero))[:-1] if full else np.asarray(
        _pack_outputs_slim(outs))
    got = finish_topk_counts_plain(torch.from_numpy(S), torch.from_numpy(C),
                                   torch.from_numpy(m), K=K, full=full, **KW).numpy()
    assert got.shape == (S.shape[0], 4 * K + 2 if full else 2 * K + 3)
    if full:  # the totals row the steps append
        got, want = np.vstack([got, np.zeros_like(got[:1])]), np.vstack(
            [want, np.zeros_like(want[:1])])
    assert_pack_close(got, want, K, slim=not full)
    n_col = 4 * K if full else 2 * K + 1
    n = got[:, n_col]
    assert n[0] == 0 and n[1] == 2 and n[6] == 5  # untouched: C = 0, whatever S
    assert got[5, n_col + 1] == 1  # quirk Q3
    if full:
        wr = got[:-1, K:2 * K]
        assert (wr[5] == 0).all() and (wr[0] == 0).all()
        counts = got[:-1, 3 * K:4 * K]
        assert (counts[0] == 0).all() and (counts[1, 2:] == 0).all()  # slots past n
        assert (counts[3, :3] == 2).all() and (counts[3, 3:] == 9).all()  # C > m: wrapped
    else:
        np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-5)
    ix = slice(2 * K, 3 * K) if full else slice(K, 2 * K)
    kk = min(K, 20)  # the exact ties go to the lowest branch index
    np.testing.assert_array_equal(got[2, ix][:kk], np.arange(10, 10 + kk))


@pytest.mark.parametrize("B", [1303, 19999])
def test_finish_counts_plain_is_the_step_composition(B):
    """Bit for bit what the CSR steps built before: ``finish_scores`` +
    ``pack_outputs`` (its body) and the sharded steps' ``_pack_slim``; strided
    rows give the same bits; the wrapper on CPU tensors is the plain version
    and counts no launch."""
    S, C, m = (torch.from_numpy(x) for x in counts_rows(np.random.default_rng(B), 24, B))
    outs = csr_mod.finish_scores(S, C, m, K=7, **KW)
    full = finish_topk_counts_plain(S, C, m, K=7, **KW)
    assert torch.equal(full, csr_mod.pack_outputs(outs, 0, 0)[:-1])
    assert torch.equal(finish_topk_counts_plain(S, C, m, K=7, full=False, **KW),
                       _pack_slim(outs))
    wide_S = torch.zeros((24, B + 97))
    wide_C = torch.zeros((24, B + 97), dtype=torch.int32)
    wide_S[:, :B], wide_C[:, :B] = S, C
    reset_launch_counts()
    assert torch.equal(finish_topk_counts(wide_S[:, :B], wide_C[:, :B], m, K=7, **KW), full)
    assert not any(launch_counts().values())


def test_finish_counts_raises_on_bad_input():
    S, C, m = (torch.from_numpy(x) for x in counts_rows(np.random.default_rng(3), 8, 100))
    for bad in (dict(C=C.long()), dict(C=C[:, :50]), dict(C=C.t().contiguous().t()),
                dict(S=S.double()), dict(m=m[:4]), dict(K=65), dict(K=0)):
        args = dict(S=S, C=C, m=m, K=7) | bad
        with pytest.raises(ValueError):
            finish_topk_counts(args["S"], args["C"], args["m"], K=args["K"], **KW)


# ---- kernel 1 with counts and the finish fused in ---------------------------------------


@pytest.fixture(scope="module")
def classic():
    """name -> (JaxPlacer on the classic plane, its staged batch): f32
    (``plane_mode="classic"``) and bf16 (``precision="bf16"``)."""
    db, ref = reference_like_db(num_leaves=24, kmer_size=6, ref_length=8_000,
                                mean_posting_len=6.0, seed=91)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 50, length=80, mutation_rate=0.05, seed=92)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
              ("amb2", b"R" + reads[1][1][1:50] + b"Y" + reads[1][1][51:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    seqs = list(dict.fromkeys(s for _, s in reads))
    out = {}
    for name, cfg in (("f32", dict(plane_mode="classic")), ("bf16", dict(precision="bf16"))):
        jp = JaxPlacer(db, tree, config=JaxConfig(**cfg))
        assert not jp._shifted
        tok = jp._tokenize(seqs)
        R = len(seqs)
        m_signed = tok.seq_lengths - jp.k + 1
        m = np.where(m_signed >= 0, m_signed.astype(np.float32),
                     np.float32(2.0**64) + m_signed.astype(np.float32)).astype(np.float32)
        Wmax = -(-int(np.bincount(tok.exact_read, minlength=R).max()) // 16) * 16
        Amax = _bucket(int(np.bincount(tok.amb_read, minlength=R).max()), 8)
        rows = jp._rows_matrix(tok.exact_keys, tok.exact_read, R, Wmax)
        arows = jp._rows_matrix(tok.amb_keys, tok.amb_read, R, Amax)
        out[name] = (jp, rows, arows, m)
    return db, out


def _torch_plane(jp):
    plane = np.asarray(jp._plane_s)
    if plane.dtype == np.float32:
        return torch.from_numpy(plane.copy())
    return torch.from_numpy(plane.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("cell", ["f32", "bf16"])
@pytest.mark.parametrize("amb", [True, False])
def test_rowgather_counts_topk_plain_matches_jax(classic, cell, amb):
    db, placers = classic
    jp, rows, arows, m = placers[cell]
    R, Wmax = rows.shape
    B, K = jp.B, min(7, jp.B)
    plane = jp._plane_s
    S, C = dense_sums_from_rows(plane, jnp.asarray(rows), R=R, B=B, Wmax=Wmax)
    if amb:
        S, C = _apply_amb(S, C, plane, jnp.asarray(arows), R=R, B=B, Amax=arows.shape[1],
                          k=jp.k, eps=float(jp.eps), log_eps=float(jp.log_eps),
                          shifted=False)
    kw = dict(K=K, k=jp.k, log_eps=float(jp.log_eps))
    zero = jnp.int32(0)
    want = np.asarray(_pack_outputs(finish_scores(S, C, jnp.asarray(m), B=B, **kw), zero,
                                    zero))
    plane_t, rows_t, m_t = _torch_plane(jp), torch.from_numpy(rows), torch.from_numpy(m)
    read = dS = hit = None
    if amb:
        read, dS, hit = amb_classic_deltas(plane_t, torch.from_numpy(arows),
                                           zero_row=db.num_kmers, B=B, k=jp.k,
                                           eps=float(jp.eps))
        assert read.numel() >= 2 and hit.any()
    wrapper = rowgather_sum_counts_topk if cell == "f32" else rowgather_sum_counts_topk_bf16
    reset_launch_counts()
    got = wrapper(plane_t, rows_t, m_t, read, dS, hit, B=B, **kw)
    assert not any(launch_counts().values())
    assert torch.equal(got, rowgather_sum_counts_topk_plain(plane_t, rows_t, m_t, read, dS,
                                                            hit, B=B, **kw))
    got = got.numpy()
    assert_pack_close(np.vstack([got, np.zeros_like(got[:1])]), want, K, slim=False)
    # today's composition, bit for bit
    S_t, C_t = rowgather_sum_counts_plain(plane_t, rows_t)
    S_t, C_t = S_t[:, :B], C_t[:, :B]
    if amb:
        S_t, C_t = amb_classic(S_t, C_t, plane_t, torch.from_numpy(arows),
                               zero_row=db.num_kmers, B=B, k=jp.k, eps=float(jp.eps))
    before = csr_mod.pack_outputs(csr_mod.finish_scores(S_t, C_t, m_t, **kw), 0, 0)[:-1]
    np.testing.assert_array_equal(got.view(np.int32), before.numpy().view(np.int32))


@pytest.mark.parametrize("cell", ["f32", "bf16"])
def test_classic_step_past_the_fused_limit_is_bit_equal(classic, cell, monkeypatch):
    """Past the fused kernel's shared-memory limit the classic steps run the
    gather with counts, the first hit's adds and ``finish_topk_counts``
    apart: the same pack, bit for bit, as the fused path (and on the CPU the
    fused path is taken whatever the width)."""
    db, placers = classic
    jp, rows, arows, m = placers[cell]
    plane_t = _torch_plane(jp)
    assert counts_topk_fits(plane_t, 10**6, 7)
    args = (plane_t, torch.from_numpy(rows), torch.from_numpy(arows), torch.from_numpy(m))
    kw = dict(B=jp.B, K=min(7, jp.B), Amax=arows.shape[1], k=jp.k, zero_row=db.num_kmers,
              log_eps=float(jp.log_eps), eps=float(jp.eps), shifted=False)
    fused = place_batch_dense_rows(*args, gather=dense_gather(plane_t, jp.B, kw["K"],
                                                              shifted=False), **kw)
    with monkeypatch.context() as mp:
        mp.setattr(step_mod, "counts_topk_fits", lambda plane, B, K: False)
        gather = dense_gather(plane_t, jp.B, kw["K"], shifted=False)
        assert gather == "rows"
        apart = place_batch_dense_rows(*args, gather=gather, **kw)
    assert torch.equal(apart, fused)
    assert fused.shape == (rows.shape[0] + 1, 4 * kw["K"] + 2) and not fused[-1].any()


def test_rowgather_counts_topk_raises_on_bad_input(classic):
    db, placers = classic
    jp, rows, arows, m = placers["f32"]
    plane_t, rows_t, m_t = _torch_plane(jp), torch.from_numpy(rows), torch.from_numpy(m)
    read, dS, hit = amb_classic_deltas(plane_t, torch.from_numpy(arows), zero_row=db.num_kmers,
                                       B=jp.B, k=jp.k, eps=float(jp.eps))
    kw = dict(B=jp.B, K=7, k=jp.k, log_eps=float(jp.log_eps))
    good = (plane_t, rows_t, m_t, read, dS, hit)
    bad_cases = [
        (0, plane_t.to(torch.bfloat16)),  # the f32 wrapper takes no bf16 plane
        (1, rows_t.long()),
        (2, m_t[:-1]),
        (4, None),  # dS without its read
        (5, hit.to(torch.uint8)),
        (4, dS[:, :-1].contiguous()),
    ]
    for i, value in bad_cases:
        args = list(good)
        args[i] = value
        with pytest.raises(ValueError):
            rowgather_sum_counts_topk(*args, **kw)
    for bad_kw in (dict(B=plane_t.shape[1] + 1), dict(K=0), dict(K=65)):
        with pytest.raises(ValueError):
            rowgather_sum_counts_topk(*good, **(kw | bad_kw))
    with pytest.raises(ValueError):
        rowgather_sum_counts_topk_bf16(*good, **kw)  # an f32 plane
