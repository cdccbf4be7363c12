"""The slice layout's read order on the CPU (``kernels/rowgather.py::
locality_order``).

The gather with counts (kernel 1c, ``rowgather_sum_counts``) and the gather
alone (kernel 1d, ``rowgather_sum``; pair rows in read order) run their
reads in locality order: sorted stably by their least row id, so that reads
that share rows run together and the rows they share come from the L2.
Here: the order is a permutation of the reads, a stable sort by the least
row (ties keep read order), and a gather taken through it and put back in
read order equals the gather in read order, bit for bit -- and within f32
reordering of JAX's ``dense_sums_from_rows`` / ``dense_sums_shifted``
(XLA adds 16 windows at a time), counts and int16 sums exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.engine.placer import dense_sums_from_rows, dense_sums_shifted

from epik_tpu_torch.kernels.rowgather import (
    locality_order,
    rowgather_sum,
    rowgather_sum_counts,
    rowgather_sum_counts_plain,
    rowgather_sum_plain,
)

#: the int16 plane's scale at log10(eps) = -4.2597 (engine/state.py::plane_cells)
_SCALE = 32000.0 / 4.2597


def _overlapping_rows(rng, R, W, n_rows):
    """Reads as windows of one row sequence at random starts, a tenth of the
    windows missing (the zero row ``n_rows - 1``)."""
    ref = rng.integers(0, n_rows - 1, 4 * W + R)
    start = rng.integers(0, ref.size - W + 1, R)
    rows = ref[start[:, None] + np.arange(W)[None, :]]
    rows[rng.random((R, W)) < 0.1] = n_rows - 1
    return rows.astype(np.int32)


def _classic_plane(rng, n_rows, bw):
    p = rng.uniform(-7.0, -0.01, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[-1] = 0.0
    return p


def _shifted_plane(rng, n_rows, bw, cell):
    """The shifted plane (> 0 present, 0 absent): f32, or int16 cells in [1,
    32000] as ``precision="int16"`` quantizes them."""
    if cell == "int16":
        p = rng.integers(1, 32001, (n_rows, bw)).astype(np.int16)
    else:
        p = rng.uniform(0.01, 7.0, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0
    p[-1] = 0
    return p


@pytest.mark.parametrize("R,W", [(0, 5), (1, 1), (7, 3), (300, 143), (64, 1500), (5, 0)])
def test_locality_order_is_a_stable_sort_by_least_row(R, W):
    rng = np.random.default_rng(R + W)
    rows = _overlapping_rows(rng, R, W, 200) if W else np.zeros((R, 0), np.int32)
    order = locality_order(torch.from_numpy(rows))
    assert order.dtype == torch.int32 and order.shape == (R,)
    order = order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(R))
    want = np.argsort(rows.min(axis=1), kind="stable") if W else np.arange(R)
    np.testing.assert_array_equal(order, want)


def test_locality_order_ties_keep_read_order():
    """Every read's least row is row 0: the order is the read order; reads
    that miss everywhere (least row the zero row) go last, in read order."""
    rng = np.random.default_rng(3)
    rows = _overlapping_rows(rng, 200, 143, 400)
    rows[:, 70] = 0
    rows[[5, 17, 60]] = 399
    order = locality_order(torch.from_numpy(rows)).numpy()
    rest = np.setdiff1d(np.arange(200), [5, 17, 60])
    np.testing.assert_array_equal(order, np.concatenate([rest, [5, 17, 60]]))


@pytest.mark.parametrize("R,W,bw", [(300, 143, 256), (64, 37, 1412), (1, 143, 128)])
@pytest.mark.parametrize("cell", ["f32", "bf16", "sums_f32", "sums_int16"])
def test_gather_through_the_order_and_back(R, W, bw, cell):
    """The plain gather over the reads in locality order, its rows put back
    at their reads, equals the plain gather in read order (each read's sums
    are its own, in window order), and the wrapper's (the plain version on
    the CPU). ``sums_*``: the gather alone (1d) over the shifted f32 or int16
    plane, also against JAX's ``dense_sums_shifted`` (f32 within reordering,
    int16 exact)."""
    rng = np.random.default_rng(R * W + bw)
    if cell.startswith("sums_"):
        _sums_through_the_order_and_back(rng, R, W, bw, cell[5:])
        return
    plane = torch.from_numpy(_classic_plane(rng, 400, bw))
    if cell == "bf16":
        plane = plane.to(torch.bfloat16)
    rows = torch.from_numpy(_overlapping_rows(rng, R, W, 400))
    order = locality_order(rows).long()
    S_o, C_o = rowgather_sum_counts_plain(plane, rows[order])
    S, C = torch.empty_like(S_o), torch.empty_like(C_o)
    S[order], C[order] = S_o, C_o
    S_p, C_p = rowgather_sum_counts_plain(plane, rows)
    assert torch.equal(S.view(torch.int32), S_p.view(torch.int32)) and torch.equal(C, C_p)
    if cell == "f32":
        S_w, C_w = rowgather_sum_counts(plane, rows)
        assert torch.equal(S_w.view(torch.int32), S_p.view(torch.int32))
        assert torch.equal(C_w, C_p)


def test_gather_in_locality_order_matches_jax():
    """Through the order and back, against ``dense_sums_from_rows`` on the
    same plane and rows: sums within f32 reordering (XLA adds 16 windows a
    chunk), counts exact."""
    rng = np.random.default_rng(11)
    R, W, bw = 96, 144, 256
    plane = _classic_plane(rng, 400, bw)
    rows = _overlapping_rows(rng, R, W, 400)
    order = locality_order(torch.from_numpy(rows)).long()
    S_o, C_o = rowgather_sum_counts_plain(torch.from_numpy(plane), torch.from_numpy(rows)[order])
    S, C = torch.empty_like(S_o), torch.empty_like(C_o)
    S[order], C[order] = S_o, C_o
    S_j, C_j = dense_sums_from_rows(jnp.asarray(plane), jnp.asarray(rows), R=R, B=bw, Wmax=W)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(C.numpy(), np.asarray(C_j))


def _sums_through_the_order_and_back(rng, R, W, bw, cell):
    plane = torch.from_numpy(_shifted_plane(rng, 400, bw, cell))
    scale = _SCALE if cell == "int16" else None
    rows = torch.from_numpy(_overlapping_rows(rng, R, W, 400))
    order = locality_order(rows).long()
    S_o = rowgather_sum_plain(plane, rows[order], scale)
    S = torch.empty_like(S_o)
    S[order] = S_o
    S_p = rowgather_sum_plain(plane, rows, scale)
    assert torch.equal(S.view(torch.int32), S_p.view(torch.int32))
    for pair_rows in (False, True):  # the locality order, and read order
        assert torch.equal(rowgather_sum(plane, rows, scale=scale,
                                         pair_rows=pair_rows).view(torch.int32),
                           S_p.view(torch.int32))
    _against_dense_sums_shifted(S, plane.numpy(), rows.numpy(), scale)


def _against_dense_sums_shifted(S, plane, rows, scale):
    """``S`` against JAX's ``dense_sums_shifted`` on the rows padded with the
    zero row to a multiple of 16 windows (as JAX pads them): f32 within
    reordering, int16 bit for bit after the one divide by the scale."""
    R, W = rows.shape
    Wp = -(-W // 16) * 16
    padded = np.full((R, Wp), plane.shape[0] - 1, np.int32)
    padded[:, :W] = rows
    Sp = np.asarray(dense_sums_shifted(jnp.asarray(plane), jnp.asarray(padded), R=R,
                                       B=plane.shape[1], Wmax=Wp))
    if scale is None:
        np.testing.assert_allclose(S.numpy(), Sp, rtol=1e-5, atol=1e-4)
    else:
        assert Sp.dtype == np.int32
        want = Sp.astype(np.float32) / np.float32(scale)
        np.testing.assert_array_equal(S.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("cell", ["f32", "int16"])
def test_sums_in_locality_order_match_jax(cell):
    """Kernel 1d's plain side through the order and back, against
    ``dense_sums_shifted`` on the same plane and rows, at a width that is not
    a multiple of 8 cells (the int16 kernel's 4-cell vectors)."""
    rng = np.random.default_rng(12)
    R, W, bw = 96, 141, 260
    plane = _shifted_plane(rng, 400, bw, cell)
    rows = _overlapping_rows(rng, R, W, 400)
    scale = _SCALE if cell == "int16" else None
    order = locality_order(torch.from_numpy(rows)).long()
    S_o = rowgather_sum_plain(torch.from_numpy(plane), torch.from_numpy(rows)[order], scale)
    S = torch.empty_like(S_o)
    S[order] = S_o
    _against_dense_sums_shifted(S, plane, rows, scale)
