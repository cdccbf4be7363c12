"""The port's kernel modules on the CPU, held to the JAX package.

Kernel 1 (row gather + sum): its plain version is bit-equal to the Pallas
kernel it replaces, ``rowgather_sum_mq`` in interpret mode (both add rows in
window order), and within f32 reordering of ``dense_sums_shifted`` (XLA sums
each chunk of 16 windows first).

Kernel 2 (finish): its plain version matches ``finish_scores_shifted`` +
``_pack_outputs_slim``: scores within 1e-5, live top-K indices, n and
zero_sum exact.

Kernel 1 with the finish fused in (``rowgather_sum_topk``): on the CPU it
equals the JAX chain ``dense_sums_shifted`` -> ``_apply_amb(shifted=True)`` ->
``finish_scores_shifted`` -> ``_pack_outputs_slim`` on a batch with ambiguous
reads, within the f32 reordering of the row sums.

On CPU tensors the wrappers run the plain versions and count no launch.
"""

import math


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.engine.placer import (
    _apply_amb,
    _pack_outputs_slim,
    dense_sums_shifted,
    finish_scores_shifted,
)
from epik_tpu.ops.pallas.rowgather_mq import rowgather_sum_mq, stage_plane

from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
from epik_tpu_torch.kernels.rowgather import (
    rowgather_sum,
    rowgather_sum_plain,
    rowgather_sum_topk,
    rowgather_sum_topk_plain,
)
from epik_tpu_torch.ops.dense import amb_deltas
from torch_fixtures import finish_rows

LOG_EPS = -4.2597  # log10 of the k=10, omega=1.5 DNA threshold, rounded


def _plane(rng, n_rows, bw, B):
    """Shifted-plane-like rows: positive cells in the first B columns, the
    padding columns and the last (miss) row all zero."""
    p = rng.uniform(1e-3, 8.5, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[:, B:] = 0.0
    p[-1] = 0.0
    return p


@pytest.mark.parametrize("n_rows,bw,B,R,W", [
    (50, 256, 200, 16, 16),   # a 50 x 256 plane, 16 x 16 rows
    (37, 128, 100, 8, 5),     # odd W, bw = 128
    (64, 256, 256, 24, 11),   # odd W, bw = 256, full-width B
])
def test_rowgather_plain_bit_equal_to_pallas(n_rows, bw, B, R, W):
    rng = np.random.default_rng(n_rows * 100 + W)
    plane = _plane(rng, n_rows, bw, B)
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = n_rows - 1  # misses -> the zero row
    mine = rowgather_sum_plain(torch.from_numpy(plane), torch.from_numpy(rows)).numpy()
    pallas = np.asarray(rowgather_sum_mq(stage_plane(jnp.asarray(plane)),
                                         jnp.asarray(rows), bw=bw, interpret=True))
    np.testing.assert_array_equal(mine, pallas)
    Wp = -(-W // 16) * 16  # dense_sums_shifted takes whole chunks of 16 windows
    rows_p = np.pad(rows, ((0, 0), (0, Wp - W)), constant_values=n_rows - 1)
    xla = np.asarray(dense_sums_shifted(jnp.asarray(plane), jnp.asarray(rows_p),
                                        R=R, B=B, Wmax=Wp))
    # f32 sums in another order (XLA reduces each 16-window chunk first)
    np.testing.assert_allclose(mine[:, :B], xla, rtol=1e-5, atol=1e-5)


def test_rowgather_wrapper_cpu_uses_plain_and_counts_nothing():
    rng = np.random.default_rng(3)
    plane = torch.from_numpy(_plane(rng, 20, 128, 128))
    rows = torch.from_numpy(rng.integers(0, 20, (6, 7)).astype(np.int32))
    reset_launch_counts()
    assert torch.equal(rowgather_sum(plane, rows), rowgather_sum_plain(plane, rows))
    counts = launch_counts()
    assert {"rowgather_sum", "finish_topk"} <= set(counts)
    assert not any(counts.values())


def test_rowgather_wrapper_checks_inputs():
    plane = torch.zeros((8, 128))
    with pytest.raises(ValueError):
        rowgather_sum(plane, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        rowgather_sum(plane.double(), torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        rowgather_sum(plane[:, :126], torch.zeros((2, 3), dtype=torch.int32))


@pytest.mark.parametrize("R,B,K,k", [(40, 1303, 7, 10), (24, 130, 7, 8),
                                     (16, 45, 12, 6)])
def test_finish_plain_matches_jax(R, B, K, k):
    rng = np.random.default_rng(B)
    Sp, m = finish_rows(rng, R, B)
    mine = finish_topk_plain(torch.from_numpy(Sp), torch.from_numpy(m), K=K, k=k,
                             log_eps=LOG_EPS).numpy()
    outs = finish_scores_shifted(jnp.asarray(Sp), jnp.asarray(m), B=B, K=K, k=k,
                                 log_eps=LOG_EPS)
    ref = np.asarray(_pack_outputs_slim(outs))
    assert mine.shape == ref.shape == (R, 2 * K + 3)
    n = ref[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(mine[:, 2 * K + 1:], ref[:, 2 * K + 1:])  # n, zero_sum
    assert ref[4, 2 * K + 2] == 1 and ref[5, 2 * K + 2] == 1 and n[0] == 0 and n[1] == 2
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    np.testing.assert_array_equal(mine[:, K:2 * K][live], ref[:, K:2 * K][live])
    np.testing.assert_allclose(mine[:, :K][live], ref[:, :K][live], rtol=1e-5, atol=1e-5)
    assert np.isneginf(mine[:, :K][~live]).all()
    np.testing.assert_allclose(mine[:, 2 * K], ref[:, 2 * K], rtol=1e-5)
    np.testing.assert_array_equal(mine[2, K:2 * K], np.arange(10, 10 + K))


def test_finish_wrapper_strided_rows_and_bounds():
    rng = np.random.default_rng(5)
    Sp, m = finish_rows(rng, 12, 256)
    full = torch.from_numpy(Sp)
    m_t = torch.from_numpy(m)
    view = full[:, :200]  # the step's (R, B) view of the (R, bw) sums
    np.testing.assert_array_equal(
        finish_topk(view, m_t, K=7, k=10, log_eps=LOG_EPS).numpy(),
        finish_topk_plain(view.contiguous(), m_t, K=7, k=10, log_eps=LOG_EPS).numpy())
    with pytest.raises(ValueError):
        finish_topk(full, m_t, K=65, k=10, log_eps=LOG_EPS)
    with pytest.raises(ValueError):
        finish_topk(full, m_t[:5], K=7, k=10, log_eps=LOG_EPS)


def _dense_batch(rng, n_rows, bw, B, R, W, Amax):
    """A shifted plane, slot rows and ambiguity rows (a third of the reads
    ambiguous), with n == 0, n < K and Q1 reads."""
    plane = _plane(rng, n_rows, bw, B)
    zero = n_rows - 1
    rows = rng.integers(0, n_rows - 1, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = zero
    rows[0] = zero  # n == 0
    rows[1] = zero
    rows[1, 0] = 0  # one row: n < K where that row is sparse
    arows = np.full((R, Amax), zero, np.int32)
    amb = rng.random(R) < 0.33
    arows[amb] = rng.integers(0, n_rows - 1, (int(amb.sum()), Amax))
    arows[0] = zero
    m = rng.integers(W, W + 20, R).astype(np.float32)
    m[3] = np.float32(2.0**64)  # quirk Q1
    return plane, rows, arows, m, zero


@pytest.mark.parametrize("n_rows,bw,B,R,W,Amax,K", [
    (80, 256, 200, 24, 16, 4, 7),
    (60, 128, 45, 16, 9, 2, 12),
    (120, 384, 300, 32, 33, 8, 5),
])
def test_rowgather_sum_topk_matches_jax_chain(n_rows, bw, B, R, W, Amax, K):
    rng = np.random.default_rng(n_rows + B)
    plane, rows, arows, m, zero = _dense_batch(rng, n_rows, bw, B, R, W, Amax)
    k, eps = 10, np.float32(5.499e-5)
    log_eps = float(np.float32(math.log10(eps)))
    Wp = -(-W // 16) * 16
    rows_p = np.pad(rows, ((0, 0), (0, Wp - W)), constant_values=zero)
    Sp = dense_sums_shifted(jnp.asarray(plane), jnp.asarray(rows_p), R=R, B=B, Wmax=Wp)
    Sp, _ = _apply_amb(Sp, None, jnp.asarray(plane), jnp.asarray(arows), R=R, B=B,
                       Amax=Amax, k=k, eps=float(eps), log_eps=log_eps, shifted=True)
    outs = finish_scores_shifted(Sp, jnp.asarray(m), B=B, K=K, k=k, log_eps=log_eps)
    ref = np.asarray(_pack_outputs_slim(outs))

    plane_t, rows_t = torch.from_numpy(plane), torch.from_numpy(rows)
    reads, delta = amb_deltas(plane_t, torch.from_numpy(arows), zero_row=zero, B=B, k=k,
                              eps=float(eps), log_eps=log_eps)
    assert reads.numel() > 0
    m_t = torch.from_numpy(m)
    kw = dict(B=B, K=K, k=k, log_eps=log_eps)
    reset_launch_counts()
    mine = rowgather_sum_topk(plane_t, rows_t, m_t, reads, delta, **kw).numpy()
    assert not any(launch_counts().values())
    assert mine.shape == ref.shape == (R, 2 * K + 3)
    n = ref[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(mine[:, 2 * K + 1:], ref[:, 2 * K + 1:])  # n, zero_sum
    assert n[0] == 0 and ref[3, 2 * K + 2] == 1
    scores, want = mine[:, :K], ref[:, :K]
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    # f32 sums in another order (XLA reduces each 16-window chunk first), as
    # in test_step_matches_jax
    np.testing.assert_allclose(scores[live], want[live], rtol=1e-5, atol=1e-5)
    assert np.isneginf(scores[~live]).all()
    # indices equal where the scores are not near-tied with a neighbour
    step = np.abs(np.diff(np.where(live, want, 0.0), axis=1))
    gap = np.full_like(want, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    clear = live & (gap > 1e-4)
    assert clear.sum() > R
    np.testing.assert_array_equal(mine[:, K:2 * K][clear], ref[:, K:2 * K][clear])
    np.testing.assert_allclose(mine[:, 2 * K], ref[:, 2 * K], rtol=1e-5)


def test_rowgather_sum_topk_plain_is_the_chain():
    """The plain version is the plain row sums, plus the delta rows at their
    reads, through the plain finish; no delta rows is the same as none."""
    rng = np.random.default_rng(17)
    plane, rows, arows, m, zero = _dense_batch(rng, 50, 128, 100, 12, 11, 3)
    plane_t, rows_t, m_t = torch.from_numpy(plane), torch.from_numpy(rows), torch.from_numpy(m)
    reads = torch.tensor([2, 5, 7])
    delta = torch.from_numpy(rng.uniform(-1.0, 3.0, (3, 100)).astype(np.float32))
    kw = dict(B=100, K=7, k=10, log_eps=LOG_EPS)
    Sp = rowgather_sum_plain(plane_t, rows_t)[:, :100].clone()
    Sp[reads] = Sp[reads] + delta
    np.testing.assert_array_equal(
        rowgather_sum_topk_plain(plane_t, rows_t, m_t, reads, delta, **kw).numpy(),
        finish_topk_plain(Sp, m_t, K=7, k=10, log_eps=LOG_EPS).numpy())
    empty = rowgather_sum_topk(plane_t, rows_t, m_t, reads[:0], delta[:0], **kw)
    np.testing.assert_array_equal(
        empty.numpy(), rowgather_sum_topk(plane_t, rows_t, m_t, None, None, **kw).numpy())


def test_rowgather_sum_topk_checks_inputs():
    plane = torch.zeros((8, 128))
    rows = torch.zeros((4, 3), dtype=torch.int32)
    m = torch.ones(4)
    reads = torch.tensor([1, 2])
    delta = torch.zeros((2, 100))
    kw = dict(B=100, K=7, k=10, log_eps=LOG_EPS)
    rowgather_sum_topk(plane, rows, m, reads, delta, **kw)
    with pytest.raises(ValueError, match="amb_read"):
        rowgather_sum_topk(plane, rows, m, reads.float(), delta, **kw)
    with pytest.raises(ValueError, match="amb_read"):
        rowgather_sum_topk(plane, rows, m, reads[:, None], delta, **kw)
    with pytest.raises(ValueError, match="together"):
        rowgather_sum_topk(plane, rows, m, reads, None, **kw)
    for bad in (torch.zeros((3, 100)), torch.zeros((2, 99)), torch.zeros((2, 100)).double(),
                torch.zeros((100, 2)).t()):
        with pytest.raises(ValueError, match="amb_delta"):
            rowgather_sum_topk(plane, rows, m, reads, bad, **kw)
    with pytest.raises(ValueError, match="m_f32"):
        rowgather_sum_topk(plane, rows, m[:3], reads, delta, **kw)
    with pytest.raises(ValueError, match="B="):
        rowgather_sum_topk(plane, rows, m, None, None, B=129, K=7, k=10, log_eps=LOG_EPS)
    with pytest.raises(ValueError, match="K="):
        rowgather_sum_topk(plane, rows, m, None, None, B=100, K=65, k=10, log_eps=LOG_EPS)
