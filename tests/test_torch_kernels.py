"""The port's kernel modules on the CPU, held to the JAX package.

Kernel 1 (row gather + sum): its plain version is bit-equal to the Pallas
kernel it replaces, ``rowgather_sum_mq`` in interpret mode (both add rows in
window order), and within f32 reordering of ``dense_sums_shifted`` (XLA sums
each chunk of 16 windows first).

Kernel 2 (finish): its plain version matches ``finish_scores_shifted`` +
``_pack_outputs_slim``: scores within 1e-5, live top-K indices, n and
zero_sum exact.

On CPU tensors the wrappers run the plain versions and count no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.engine.placer import _pack_outputs_slim, dense_sums_shifted, finish_scores_shifted
from epik_tpu.ops.pallas.rowgather_mq import rowgather_sum_mq, stage_plane

from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
from epik_tpu_torch.kernels.rowgather import rowgather_sum, rowgather_sum_plain
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
