"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no jax, so it also runs where jax is not installed (the repository's
conftest.py imports jax; run it there with ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.accumulate_packed import (
    accumulate_packed_sums,
    accumulate_packed_topk,
    accumulate_packed_topk_plain,
    packed_sums_plain,
)
from epik_tpu_torch.kernels.accumulate_sums import (
    accumulate_sums,
    accumulate_sums_counts,
    accumulate_sums_counts_csr,
    accumulate_sums_counts_csr_plain,
    accumulate_sums_plain,
    plan,
)
from epik_tpu_torch.kernels.finish import (
    finish_topk,
    finish_topk_counts,
    finish_topk_counts_plain,
    finish_topk_plain,
)
from epik_tpu_torch.kernels.finish_cols import (
    finish_cols_partial,
    finish_cols_partial_counts,
    finish_cols_partial_counts_plain,
    finish_cols_layout,
    finish_cols_partial_plain,
)
from epik_tpu_torch.kernels.rowgather import (
    GROUP_BLOCK_RESERVE,
    GROUP_MAX,
    GROUP_MIN_BLOCKS,
    SHIFTED_COLS_MAX_BW,
    SHIFTED_GROUP_MAX,
    SHIFTED_TOPK_MAX_BW,
    cols_fits,
    cols_smem,
    counts_cols_fits,
    counts_group,
    counts_topk_fits,
    counts_topk_smem,
    group_smem,
    locality_order,
    posted_fits,
    posted_smem,
    posted_topk_fits,
    posted_topk_smem,
    rowgather_sum,
    rowgather_sum_cols,
    rowgather_sum_cols_plain,
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_counts_cols,
    rowgather_sum_counts_cols_plain,
    rowgather_sum_counts_plain,
    rowgather_sum_counts_topk,
    rowgather_sum_counts_topk_bf16,
    rowgather_sum_counts_topk_plain,
    rowgather_sum_plain,
    rowgather_sum_posted,
    rowgather_sum_posted_plain,
    rowgather_sum_posted_topk,
    rowgather_sum_posted_topk_plain,
    rowgather_sum_topk,
    rowgather_sum_topk_int16,
    rowgather_sum_topk_plain,
    shifted_fused,
    shifted_group,
    topk_fits,
    topk_smem,
)
from epik_tpu_torch.kernels.tokenize import tokenize_combo_fused
from torch_fixtures import (
    cell_order_sums,
    counts_rows,
    finish_rows,
    flat_cells,
    packed_cells,
    packed_rows,
    score_cells,
    score_rows,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plane(rng, n_rows, bw, density=0.3):
    p = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > density] = 0.0
    p[-1] = 0.0  # the all-zero miss row
    return p


@pytest.mark.parametrize("n_rows,bw,R,W", [
    (50, 128, 16, 1), (300, 256, 64, 17), (1000, 1408, 257, 71),
    (64, 4608, 8, 9),  # bw/4 > 1024: threads loop over column chunks
    (40, 128, 3, 2500),  # W > one shared-memory tile of row offsets
])
def test_rowgather_bit_equal(cuda, n_rows, bw, R, W):
    rng = np.random.default_rng(n_rows + W)
    plane = torch.from_numpy(_plane(rng, n_rows, bw)).to(cuda)
    rows = torch.from_numpy(rng.integers(0, n_rows, (R, W)).astype(np.int32)).to(cuda)
    got = rowgather_sum(plane, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, rowgather_sum_plain(plane, rows))


@pytest.mark.parametrize("R,B,K", [(300, 1303, 7), (64, 130, 7), (16, 40, 40),
                                   (8, 20000, 5)])
def test_finish_matches_plain(cuda, R, B, K):
    rng = np.random.default_rng(B)
    Sp, m = finish_rows(rng, R, B)
    Sp_t = torch.from_numpy(Sp).to(cuda)
    m_t = torch.from_numpy(m).to(cuda)
    kw = dict(K=K, k=10, log_eps=-4.2597)
    got = finish_topk(Sp_t, m_t, **kw).cpu().numpy()
    want = finish_topk_plain(Sp_t, m_t, **kw).cpu().numpy()
    n = want[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(got[:, :K], want[:, :K])  # scores bit-equal
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    np.testing.assert_array_equal(got[:, K:2 * K][live], want[:, K:2 * K][live])
    idx = got[:, K:2 * K]
    assert ((idx >= 0) & (idx < B)).all()
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6)
    # the 20 engineered ties go to the lowest branch index
    kk = min(K, 20)
    np.testing.assert_array_equal(got[2, K:K + kk], np.arange(10, 10 + kk))


@pytest.mark.parametrize("R,B,density", [(64, 19999, 0.02), (16, 19999, 1.0),
                                         (64, 1303, 1.0)])
def test_finish_few_and_all_touched(cuda, R, B, density):
    """The finish over the touched list at the f32 tile path's width, with few
    branches touched and with every one (but the engineered rows); every
    index equal, two launches alike."""
    rng = np.random.default_rng(R + B)
    Sp, m = finish_rows(rng, R, B, density=density)
    Sp_t, m_t = torch.from_numpy(Sp).to(cuda), torch.from_numpy(m).to(cuda)
    kw = dict(K=7, k=10, log_eps=-4.2597)
    got = finish_topk(Sp_t, m_t, **kw)
    assert torch.equal(finish_topk(Sp_t, m_t, **kw), got)
    _check_pack(got.cpu().numpy(), finish_topk_plain(Sp_t, m_t, **kw).cpu().numpy(), 7, B)
    if density == 1.0:
        assert (got[8:, 2 * 7 + 1] == B).all()


def _check_pack(got, want, K, B):
    """The finish criteria: scores, n and zero_sum bit-equal, every index
    equal (the -inf slots hold the lowest untouched branches in both), and
    log_sum within rtol 1e-6 (its sum of exponentials runs in another order)."""
    np.testing.assert_array_equal(got[:, :2 * K], want[:, :2 * K])
    assert ((got[:, K:2 * K] >= 0) & (got[:, K:2 * K] < B)).all()
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6)


@pytest.mark.parametrize("R,PP,B,K", [(64, 2304, 19999, 7), (300, 512, 1303, 7),
                                      (16, 40, 45, 12), (8, 3000, 32000, 5),
                                      (5, 7, 130, 3)])
def test_accumulate_packed_topk_bit_equal(cuda, R, PP, B, K):
    rng = np.random.default_rng(R + PP)
    p, m = packed_cells(rng, R, PP, B)
    p_t, m_t = torch.from_numpy(p).to(cuda), torch.from_numpy(m).to(cuda)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597, scale=15025.0)
    got, sq = accumulate_packed_topk(p_t, m_t, **kw, return_sums=True)
    assert torch.equal(accumulate_packed_topk(p_t, m_t, **kw), got)
    assert torch.equal(sq.long(), packed_sums_plain(p_t, B))  # the integer sums
    want = accumulate_packed_topk_plain(p_t, m_t, **kw).cpu().numpy()
    got = got.cpu().numpy()
    _check_pack(got, want, K, B)
    assert want[0, 2 * K + 1] == 0 and want[1, 2 * K + 1] == 2
    if PP >= 20 and B >= 30:  # the 20 ties go to the lowest branch index
        np.testing.assert_array_equal(got[2, K:2 * K], np.arange(10, 10 + K))


@pytest.mark.parametrize("R,PP,B,K", [(16, 2816, 19999, 7), (16, 2304, 1303, 7),
                                      (8, 300, 130, 7), (8, 45, 40, 40), (9, 64, 64, 12),
                                      (8, 13000, 32767, 7), (8, 32800, 32767, 64),
                                      (16, 4608, 19999, 7), (16, 8384, 19999, 7),
                                      (8, 8384, 32767, 7)])
def test_accumulate_packed_topk_engineered(cuda, R, PP, B, K):
    """Kernel 2 on the engineered rows (n = 0, n < K, every cell on its own
    branch, exact ties across the K cut, Q3, a Q1 m = 2**64, PP >= B with
    every branch touched): sums and the whole pack bit-equal but log_sum
    (rtol 1e-6), two launches alike. The widest B the packed cells allow,
    with PP past 13,000 and past B, bounds the block's shared memory. The
    pair-fused tiles' widths: PP = 72 * 2 * 32 (a 150 bp read at config 4's
    PT = 32) and 131 * 2 * 32, the widest the packed exactness gate lets
    through (W = 262)."""
    rng = np.random.default_rng(R * PP + B)
    p, m = packed_rows(rng, R, PP, B)
    p_t, m_t = torch.from_numpy(p).to(cuda), torch.from_numpy(m).to(cuda)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597, scale=15025.0)
    got, sq = accumulate_packed_topk(p_t, m_t, **kw, return_sums=True)
    again, sq2 = accumulate_packed_topk(p_t, m_t, **kw, return_sums=True)
    assert torch.equal(again, got) and torch.equal(sq2, sq)
    assert torch.equal(sq.long(), packed_sums_plain(p_t, B))
    want = accumulate_packed_topk_plain(p_t, m_t, **kw).cpu().numpy()
    got = got.cpu().numpy()
    _check_pack(got, want, K, B)
    n = got[:, 2 * K + 1]
    assert n[0] == 0 and n[1] == 2 and n[5] == min(PP, B) and got[6, 2 * K + 2] == 1
    if PP >= B:
        assert n[7] == B


@pytest.mark.parametrize("R,PP,B", [(64, 2816, 20096), (128, 3072, 5120), (16, 40, 45),
                                    (5, 7, 130)])
def test_accumulate_packed_sums_bit_equal(cuda, R, PP, B):
    """Kernel 3's sums alone at the column-sharded widths of config 4 (one
    shard of 20,096 columns, four of 5,120) and at ragged small shapes."""
    rng = np.random.default_rng(R + B)
    p, _ = packed_cells(rng, R, PP, B)
    p_t = torch.from_numpy(p).to(cuda)
    got = accumulate_packed_sums(p_t, B=B)
    want = packed_sums_plain(p_t, B)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (R, B)
    assert torch.equal(got, want.to(torch.float32))
    assert int(want.max()) < 1 << 24  # exact in f32
    if PP >= 64:
        assert int(got[3, 5]) >= 64 * 64000


def _bits(x):
    """A float tensor's bits (``torch.equal`` takes -0.0 for 0.0)."""
    return x.view(torch.int32)


@pytest.mark.parametrize("R,PP,B,engineered", [
    pytest.param(64, 2304, 19999, False, id="64-2304-19999"),
    pytest.param(300, 512, 1303, False, id="300-512-1303"),
    pytest.param(4, 700, 40000, False, id="4-700-40000"),
    pytest.param(9, 33, 100, False, id="9-33-100"),
    pytest.param(3, 5000, 7, False, id="3-5000-7"),
    # the CSR batch's width, an odd PP, the 1x4 shard width, two tiles
    pytest.param(16, 16384, 19999, True, id="16-16384-19999-engineered"),
    pytest.param(16, 4577, 19999, True, id="16-4577-19999-engineered"),
    pytest.param(32, 3072, 5120, True, id="32-3072-5120-engineered"),
    pytest.param(16, 2000, 40000, True, id="16-2000-40000-engineered"),
    pytest.param(16, 1024, 1303, True, id="16-1024-1303-engineered"),
    # the counts block's shared memory just under and just over 48 KB
    pytest.param(16, 2000, 1512, True, id="16-2000-1512-under-48kb-engineered"),
    pytest.param(16, 2000, 1520, True, id="16-2000-1520-over-48kb-engineered"),
])
def test_accumulate_sums_bit_equal(cuda, R, PP, B, engineered):
    """Kernel 4, with counts and without, bit for bit against its plain
    version (and, on the engineered rows, against a loop over each row's
    cells in order); two launches give the same bytes. The launch opts in
    to its shared memory on both sides of the 48 KB default."""
    rng = np.random.default_rng(R * PP)
    if engineered:
        layouts = plan(B, True), plan(B, False)
        # with counts, B = 40,000 takes the path past one tile
        assert layouts[0].n_tiles == (2 if B == 40000 else 1)
        assert layouts[0].radix_bits == layouts[1].radix_bits == 0
        if B in (1512, 1520):
            assert (layouts[0].smem < 48 * 1024) == (B == 1512)
        b, s = score_rows(rng, R, PP, B, edges=tuple(p.tile_w for p in layouts))
    else:
        b, s = score_cells(rng, R, PP, B)
    b_t, s_t = torch.from_numpy(b).to(cuda), torch.from_numpy(s).to(cuda)
    S = accumulate_sums(b_t, s_t, B=B)
    S2, C2 = accumulate_sums_counts(b_t, s_t, B=B)
    S_p, C_p = accumulate_sums_plain(b_t, s_t, B=B, counts=True)
    S_again = accumulate_sums(b_t, s_t, B=B)
    S2_again, C2_again = accumulate_sums_counts(b_t, s_t, B=B)
    torch.cuda.synchronize()
    assert torch.equal(_bits(S), _bits(S_p)) and torch.equal(_bits(S2), _bits(S_p))
    assert torch.equal(C2, C_p)
    assert torch.equal(_bits(S_again), _bits(S)) and torch.equal(_bits(S2_again), _bits(S2))
    assert torch.equal(C2_again, C2)
    assert int(C_p[0, B - 1]) == PP  # row 0: every cell on one branch
    if engineered:
        want_S, want_C = cell_order_sums(b, s, B)
        np.testing.assert_array_equal(_bits(S).cpu().numpy(), want_S.view(np.int32))
        np.testing.assert_array_equal(C2.cpu().numpy(), want_C)


@pytest.mark.parametrize("n_rows,bw,B,R,W", [
    (2000, 1408, 1303, 300, 72),  # D652's widths (G = 8)
    (64, 128, 40, 50, 9),
    (300, 4608, 4500, 24, 17),  # G = 2: 36 slices a read
    (40, 128, 100, 3, 2500),  # W > one shared-memory tile of row ids
])
@pytest.mark.parametrize("amb", [False, True])
@pytest.mark.parametrize("pair_rows", [False, True])
def test_rowgather_sum_topk_bit_equal(cuda, n_rows, bw, B, R, W, amb, pair_rows):
    """Kernel 1 with the finish fused in against its plain version: the
    whole pack bit-equal but log_sum (rtol 1e-6), with and without delta
    rows, the reads in locality order and in read order; two launches
    alike."""
    rng = np.random.default_rng(n_rows + W)
    plane_np = _plane(rng, n_rows, bw)
    plane_np[:, B:] = 0.0
    plane = torch.from_numpy(plane_np).to(cuda)
    rows_np = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows_np[rng.random((R, W)) < 0.3] = n_rows - 1
    rows_np[0] = n_rows - 1  # n == 0
    rows = torch.from_numpy(rows_np).to(cuda)
    m_np = rng.integers(W, W + 40, R).astype(np.float32)
    m_np[1] = np.float32(2.0**64)  # quirk Q1
    m = torch.from_numpy(m_np).to(cuda)
    reads = delta = None
    if amb:
        reads = torch.from_numpy(rng.choice(R, max(1, R // 3), replace=False)).to(cuda)
        d = rng.uniform(-2.0, 6.0, (reads.numel(), B)).astype(np.float32)
        d[rng.random(d.shape) < 0.7] = 0.0
        delta = torch.from_numpy(d).to(cuda)
    K = min(7, B)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
    got = rowgather_sum_topk(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw)
    assert torch.equal(rowgather_sum_topk(plane, rows, m, reads, delta, pair_rows=pair_rows,
                                          **kw), got)
    want = rowgather_sum_topk_plain(plane, rows, m, reads, delta, **kw).cpu().numpy()
    _check_pack(got.cpu().numpy(), want, K, B)
    assert want[0, 2 * K + 1] == 0


def test_finish_strided_rows(cuda):
    """The step hands the finish the (R, B) view of the (R, bw) sums."""
    rng = np.random.default_rng(9)
    Sp, m = finish_rows(rng, 32, 1408)
    full = torch.from_numpy(Sp).to(cuda)
    m_t = torch.from_numpy(m).to(cuda)
    view = full[:, :1303]
    got = finish_topk(view, m_t, K=7, k=10, log_eps=-4.2597)
    want = finish_topk(view.contiguous(), m_t, K=7, k=10, log_eps=-4.2597)
    assert torch.equal(got, want)


def test_launch_counts(cuda):
    plane = torch.zeros((8, 128), device=cuda)
    rows = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    p = torch.zeros((4, 5), dtype=torch.int32, device=cuda)
    b = torch.zeros((4, 5), dtype=torch.int32, device=cuda)
    s = torch.zeros((4, 5), device=cuda)
    m = torch.ones(4, device=cuda)
    plane_q = torch.zeros((8, 128), dtype=torch.int16, device=cuda)
    reset_launch_counts()
    Sp = rowgather_sum(plane, rows)
    off = torch.zeros(9, dtype=torch.int64, device=cuda)
    cells = torch.zeros((0, 2), dtype=torch.int32, device=cuda)
    rowgather_sum_posted(off, cells, rows, bw=128)
    rowgather_sum_posted_topk(off, cells, rows, m, None, None, bw=128, B=100, K=3, k=4,
                              log_eps=-1.0)
    rowgather_sum_topk(plane, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0)
    rowgather_sum_topk_int16(plane_q, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0,
                             scale=2.0)
    rowgather_sum_counts(plane, rows)
    rowgather_sum_counts_bf16(plane.to(torch.bfloat16), rows)
    rowgather_sum_counts_topk(plane, rows, m, None, None, None, B=100, K=3, k=4, log_eps=-1.0)
    rowgather_sum_counts_topk_bf16(plane.to(torch.bfloat16), rows, m, None, None, None, B=100,
                                   K=3, k=4, log_eps=-1.0)
    finish_topk(Sp, m, K=3, k=4, log_eps=-1.0)
    C = torch.ones(Sp.shape, dtype=torch.int32, device=cuda)
    finish_topk_counts(Sp, C, m, K=3, k=4, log_eps=-1.0)
    finish_cols_partial(Sp, m, K=3, k=4, log_eps=-1.0, col0=128)
    finish_cols_partial_counts(Sp, C, m, K=3, k=4, log_eps=-1.0, col0=128)
    rowgather_sum_cols(plane, rows, m, None, None, K=3, k=4, log_eps=-1.0, col0=0)
    rowgather_sum_counts_cols(plane, rows, m, None, None, None, K=3, k=4, log_eps=-1.0, col0=0)
    accumulate_packed_topk(p, m, B=100, K=3, k=4, log_eps=-1.0, scale=2.0)
    accumulate_packed_sums(p, B=100)
    accumulate_sums(b, s, B=100)
    accumulate_sums_counts(b, s, B=100)
    ptr = torch.tensor([0, 5, 5, 12, 20], dtype=torch.int64, device=cuda)
    accumulate_sums_counts_csr(b.view(-1), s.view(-1), ptr, R=4, B=100)
    buf = torch.zeros((4, 152 // 4 + 152 // 8 + 2), dtype=torch.uint8, device=cuda)
    combo = torch.zeros(4**5 + 4**4 + 1, dtype=torch.int32, device=cuda)
    tokenize_combo_fused(buf, combo, k=4, Lmax=152)
    # the plain versions never count
    rowgather_sum_plain(plane, rows)
    rowgather_sum_posted_plain(off, cells, rows, 128)
    rowgather_sum_posted_topk_plain(off, cells, rows, m, None, None, bw=128, B=100, K=3, k=4,
                                    log_eps=-1.0)
    rowgather_sum_topk_plain(plane, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0)
    rowgather_sum_counts_plain(plane, rows)
    rowgather_sum_counts_topk_plain(plane, rows, m, None, None, None, B=100, K=3, k=4,
                                    log_eps=-1.0)
    finish_topk_counts_plain(Sp, C, m, K=3, k=4, log_eps=-1.0)
    accumulate_packed_topk_plain(p, m, B=100, K=3, k=4, log_eps=-1.0, scale=2.0)
    accumulate_sums_plain(b, s, B=100, counts=True)
    accumulate_sums_counts_csr_plain(b.view(-1), s.view(-1), ptr, R=4, B=100)
    packed_sums_plain(p, 100)
    finish_cols_partial_plain(Sp, m, K=3, k=4, log_eps=-1.0, col0=128)
    finish_cols_partial_counts_plain(Sp, C, m, K=3, k=4, log_eps=-1.0, col0=128)
    rowgather_sum_cols_plain(plane, rows, m, None, None, K=3, k=4, log_eps=-1.0, col0=0)
    rowgather_sum_counts_cols_plain(plane, rows, m, None, None, None, K=3, k=4, log_eps=-1.0,
                                    col0=0)
    assert launch_counts() == {"rowgather_sum": 1, "rowgather_sum_posted": 1,
                               "rowgather_sum_posted_topk": 1, "rowgather_sum_topk": 1,
                               "rowgather_sum_topk_int16": 1, "rowgather_sum_counts": 1,
                               "rowgather_sum_counts_bf16": 1,
                               "rowgather_sum_counts_topk": 1,
                               "rowgather_sum_counts_topk_bf16": 1, "finish_topk": 1,
                               "finish_topk_counts": 1,
                               "rowgather_sum_cols": 1, "rowgather_sum_counts_cols": 1,
                               "finish_cols_partial": 1, "finish_cols_partial_counts": 1,
                               "accumulate_packed_topk": 1, "accumulate_packed_sums": 1,
                               "accumulate_sums": 1, "accumulate_sums_counts": 1,
                               "accumulate_sums_counts_csr": 1, "tokenize_combo_fused": 1}


def test_wrappers_raise_on_bad_input(cuda):
    plane = torch.zeros((8, 128), device=cuda)
    with pytest.raises(ValueError):
        rowgather_sum(plane, torch.zeros((4, 3), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        rowgather_sum(plane, torch.zeros((4, 3), dtype=torch.int32))  # CPU rows
    with pytest.raises(ValueError):
        finish_topk(torch.ones((4, 100), device=cuda), torch.ones(4, device=cuda),
                    K=65, k=4, log_eps=-1.0)
    rows = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    m = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="amb_delta"):
        rowgather_sum_topk(plane, rows, m, torch.tensor([1], device=cuda),
                           torch.zeros((1, 100)), B=100, K=3, k=4, log_eps=-1.0)  # CPU delta
    with pytest.raises(ValueError, match="scale"):
        accumulate_packed_topk(torch.zeros((4, 5), dtype=torch.int32, device=cuda), m,
                               B=100, K=3, k=4, log_eps=-1.0, scale=0.0)
    p = torch.zeros((4, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="2\\*\\*15"):
        accumulate_packed_topk(p, torch.ones(4, device=cuda), B=40000, K=3, k=4,
                               log_eps=-1.0, scale=2.0)
    with pytest.raises(ValueError, match="2\\*\\*15"):
        accumulate_packed_sums(p, B=40000)
    with pytest.raises(ValueError):
        accumulate_packed_sums(p.long(), B=100)
    with pytest.raises(ValueError):
        accumulate_sums(p, torch.zeros((4, 5), device=cuda, dtype=torch.float64), B=9)
    Sp = torch.ones((4, 256), device=cuda)
    with pytest.raises(ValueError):
        finish_cols_partial(Sp, torch.ones(4), K=3, k=4, log_eps=-1.0, col0=0)  # CPU m
    with pytest.raises(ValueError):
        finish_cols_partial(Sp, m, K=65, k=4, log_eps=-1.0, col0=0)
    with pytest.raises(ValueError):
        finish_cols_partial_counts(Sp, torch.ones((4, 256), dtype=torch.int32), m, K=3, k=4,
                                   log_eps=-1.0, col0=0)  # CPU counts
    with pytest.raises(ValueError, match="amb_delta"):
        rowgather_sum_cols(plane, rows, m, torch.tensor([1], device=cuda),
                           torch.zeros((1, 128)), K=3, k=4, log_eps=-1.0, col0=0)  # CPU delta
    with pytest.raises(ValueError, match="shared memory"):
        rowgather_sum_counts_cols(torch.zeros((8, 40000), device=cuda), rows, m, None, None,
                                  None, K=3, k=4, log_eps=-1.0, col0=0)
    with pytest.raises(ValueError, match="16 bits"):
        rowgather_sum_cols(torch.zeros((8, 70016), device=cuda), rows, m, None, None, K=3,
                           k=4, log_eps=-1.0, col0=0)
    C = torch.ones((4, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        finish_topk_counts(Sp, C.cpu(), m, K=3, k=4, log_eps=-1.0)  # CPU counts
    with pytest.raises(ValueError):
        finish_topk_counts(Sp, C.long(), m, K=3, k=4, log_eps=-1.0)
    hit = torch.ones((1, 100), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="amb_dS"):
        rowgather_sum_counts_topk(plane, rows, m, torch.tensor([1], device=cuda),
                                  torch.zeros((1, 100)), hit, B=100, K=3, k=4,
                                  log_eps=-1.0)  # CPU contributions
    with pytest.raises(ValueError, match="shared memory"):
        rowgather_sum_counts_topk(torch.zeros((8, 40000), device=cuda), rows, m, None, None,
                                  None, B=39000, K=3, k=4, log_eps=-1.0)


def test_placer_cuda_matches_cpu(cuda):
    """The whole path on the card against the same path on the CPU (plain
    versions): same edges; scores equal up to the f32 exp of ambiguous hits."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=31)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=101, mutation_rate=0.05, seed=32)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    want = TorchPlacer(db, tree, device="cpu").place(reads)
    reset_launch_counts()
    got = TorchPlacer(db, tree, device=cuda).place(reads)
    counts = launch_counts()
    # the dense path runs the fused kernel, not the gather and finish apart
    assert counts["rowgather_sum_topk"] > 0
    assert counts["rowgather_sum"] == 0 and counts["finish_topk"] == 0
    np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
    np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("payload,budget", [("packed", None), ("f32", None),
                                            ("auto", 1)])
def test_tiles_and_csr_placer_cuda_matches_cpu(cuda, payload, budget):
    """The tiles route (both payloads; IUPAC reads split off to CSR, a 400 bp
    batch wholly on CSR) and the CSR route (``dense_db_budget=1``) on the card
    against the same routes on the CPU: same edges and counts, scores within
    f32 rounding of the exp in the ambiguous first hit."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=71)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=121, mutation_rate=0.05, seed=72)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    long_reads = reads_from_reference(ref, 5, length=400, mutation_rate=0.05, seed=76)
    cfg = PlacerConfig(dense_db="off", tile_payload=payload, dense_db_budget=budget)
    cpu = TorchPlacer(db, tree, config=cfg, device="cpu")
    reset_launch_counts()
    gpu = TorchPlacer(db, tree, config=cfg, device=cuda)
    assert gpu.route == cpu.route == ("csr" if budget else "tiles")
    for batch in (reads, long_reads):
        want, got = cpu.place(batch), gpu.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_array_equal(got.counts[got.keep], want.counts[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    counts = launch_counts()
    assert counts["accumulate_sums_counts"] > 0  # the CSR step ran
    if budget is None:
        kernel = "accumulate_packed_topk" if payload == "packed" else "accumulate_sums"
        assert counts[kernel] > 0


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 2)])
def test_sharded_placer_cuda_matches_cpu(cuda, n_data, n_model):
    """The column-sharded big-tree path on the card (a mesh of one repeated
    card) against the same mesh on the CPU: the tiles (kernel 3's sums) with
    an ambiguous batch on the hash-sharded CSR (kernel 4 with counts) and a
    400 bp batch past the packed gate. Same edges; scores within f32 rounding
    of the exp in the ambiguous first hit."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=81)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=121, mutation_rate=0.05, seed=82)
    amb = reads[:5] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
    long_reads = reads_from_reference(ref, 5, length=400, mutation_rate=0.05, seed=83)
    cfg = PlacerConfig(dense_db="off")
    n = n_data * n_model
    cpu = ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=["cpu"] * n),
                             config=cfg)
    reset_launch_counts()
    gpu = ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=[cuda] * n),
                             config=cfg)
    assert gpu.route == cpu.route == "tiles"
    for batch in (reads, amb, long_reads):
        want, got = cpu.place(batch), gpu.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    counts = launch_counts()
    assert counts["accumulate_packed_sums"] > 0 and counts["accumulate_sums_counts"] > 0
    # the tile step finishes through the per-shard column finish, one launch a shard
    assert counts["finish_cols_partial"] > 0 and counts["finish_cols_partial"] % n_model == 0


@pytest.mark.parametrize("n_data,n_model,cfg", [(1, 4, {}), (2, 2, {}), (4, 1, {}),
                                                (1, 4, {"plane_mode": "classic"}),
                                                (2, 2, {"dense_db": "off"})])
def test_sharded_placer_across_cards(cuda, n_data, n_model, cfg):
    """The sharded engine over four distinct cards (skips with fewer): the
    shards' sums and partial packs move to the first card for the merge.
    Against a 1x1 mesh on one card: same edges; scores equal up to the f32
    rounding of the merged exp-sums (the finish adds the shards' sums in
    shard order)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, ref = reference_like_db(num_leaves=300, kmer_size=10, ref_length=60_000,
                                mean_posting_len=6.0, seed=85)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 300, length=150, mutation_rate=0.05, seed=86)
    amb = reads[:9] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
    short = [("s1", b"ACG"), ("s2", reads[1][1][:9])]
    conf = PlacerConfig(**cfg)
    one = ShardedTorchPlacer(db, tree, make_mesh(1, 1, devices=[cuda]), config=conf)
    mesh = make_mesh(n_data, n_model, devices=[torch.device("cuda", i) for i in range(4)])
    reset_launch_counts()
    four = ShardedTorchPlacer(db, tree, mesh, config=conf)
    assert four.route == one.route == ("tiles" if cfg.get("dense_db") == "off" else "dense")
    for batch in (reads, amb, short):
        want, got = one.place(batch), four.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    counts = launch_counts()
    assert counts["rowgather_sum"] + counts["rowgather_sum_counts"] + counts[
        "accumulate_packed_sums"] > 0


def _check_partial(got, want, what=""):
    """The partial packs [values | ids | n_s | max_s | e_s]: all but e_s
    bit-equal, e_s within rtol 1e-6 (another order of adds)."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1], err_msg=what)
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-6, atol=0.0, err_msg=what)


def _cols_sums(rng, R, bwl, n_model, counts):
    """One (R, n_model * bwl) sums matrix (and counts) cut into shard views,
    the last shard's 97 padded columns untouched, ties at the K cut across a
    shard boundary (row 6), nothing touched in shard 0 (row 7)."""
    B = n_model * bwl - 97
    if counts:
        S_b, C_b, m = counts_rows(rng, R, B, density=0.05)
    else:
        S_b, m = finish_rows(rng, R, B, density=0.05)
        C_b = None
    full = np.zeros((R, n_model * bwl), np.float32)
    full[:, :B] = S_b
    cnt = np.zeros(full.shape, np.int32)
    if counts:
        cnt[:, :B] = C_b
    tie0 = bwl - 8 if n_model > 1 else B // 2
    full[6], cnt[6] = 0.0, 0
    full[6, tie0:tie0 + 16] = -7.5 if counts else 7.5
    cnt[6, tie0:tie0 + 16] = 2
    full[7, :bwl], cnt[7, :bwl] = 0.0, 0
    return B, full, (cnt if counts else None), m, tie0


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("R,bwl,n_model", [(16384, 1408, 1), (16384, 384, 4), (4096, 20096, 1),
                                           (4096, 5120, 4), (300, 70016, 1), (4096, 22272, 1),
                                           (300, 65537, 1)])
def test_finish_cols_bit_equal(cuda, R, bwl, n_model, counts):
    """Kernel A, one launch per shard, on (R, bwl) row views of one sums
    matrix (and counts): the partial pack (values, global ids, n_s, max_s,
    and the counts form's candidate counts) bit-equal to its plain version
    and alike over two launches, e_s within rtol 1e-6; the whole finish on the
    card against its plain version on the CPU: scores, ids, n and zero_sum
    equal, log_sum within rtol 1e-6. D652's bwl 1,408 takes the small block
    (128 threads), the wide classic shard's 22,272 the wide one; at bwl =
    65,537 and 70,016 the ids go to the global workspace."""
    from epik_tpu_torch.parallel.sharding import (
        _pack_slim,
        finish_scores_cols,
        finish_scores_cols_shifted,
        pack_outputs,
    )

    rng = np.random.default_rng(R + bwl + n_model)
    B, full, cnt, m, tie0 = _cols_sums(rng, R, bwl, n_model, counts)
    full_t, m_t = torch.from_numpy(full).to(cuda), torch.from_numpy(m).to(cuda)
    cnt_t = torch.from_numpy(cnt).to(cuda) if counts else None
    cols = [slice(s * bwl, (s + 1) * bwl) for s in range(n_model)]
    Sps = [full_t[:, c] for c in cols]
    Cs = [cnt_t[:, c] for c in cols] if counts else None
    K, kw = 7, dict(k=10, log_eps=-4.2597)
    lay = finish_cols_layout(Sps[0], K, counts)
    assert 0 < lay["smem"] <= lay["limit"]
    reset_launch_counts()
    for s in range(n_model):
        if counts:
            got, got_c = finish_cols_partial_counts(Sps[s], Cs[s], m_t, K=K, col0=s * bwl, **kw)
            again, again_c = finish_cols_partial_counts(Sps[s], Cs[s], m_t, K=K, col0=s * bwl,
                                                        **kw)
            want, want_c = finish_cols_partial_counts_plain(Sps[s], Cs[s], m_t, K=K,
                                                            col0=s * bwl, **kw)
            assert torch.equal(got_c, want_c) and torch.equal(got_c, again_c)
        else:
            got = finish_cols_partial(Sps[s], m_t, K=K, col0=s * bwl, **kw)
            again = finish_cols_partial(Sps[s], m_t, K=K, col0=s * bwl, **kw)
            want = finish_cols_partial_plain(Sps[s], m_t, K=K, col0=s * bwl, **kw)
        assert torch.equal(got, again)
        _check_partial(got, want, f"shard {s}")
    name = "finish_cols_partial_counts" if counts else "finish_cols_partial"
    assert {n: c for n, c in launch_counts().items() if c} == {name: 2 * n_model}
    if counts:
        got = pack_outputs(finish_scores_cols(Sps, Cs, m_t, B=B, K=K, **kw), 0, 0)
        want = pack_outputs(finish_scores_cols([S.cpu() for S in Sps], [C.cpu() for C in Cs],
                                               m_t.cpu(), B=B, K=K, **kw), 0, 0)
        got, want = got.cpu().numpy()[:-1], want.numpy()[:-1]
        _check_full_pack(got, want, K, B)
        idx = got[:, 2 * K:3 * K]
    else:
        got = _pack_slim(finish_scores_cols_shifted(Sps, m_t, B=B, K=K, **kw)).cpu().numpy()
        want = _pack_slim(finish_scores_cols_shifted([S.cpu() for S in Sps], m_t.cpu(), B=B,
                                                     K=K, **kw)).numpy()
        _check_pack(got, want, K, B)
        idx = got[:, K:2 * K]
    np.testing.assert_array_equal(idx[0], np.arange(K))  # n = 0: the lowest ids
    np.testing.assert_array_equal(idx[6], np.arange(tie0, tie0 + K))


def _cols_case(cuda, rng, R, bwl, counts, amb, n_rows=400, W=72):
    """One shard's f32 plane and a batch of rows for the fused column kernel
    (``_dense_case`` / ``_classic_case`` at B = bwl - 5, the first hits
    padded to bwl columns), on the card: (plane, rows, m, reads, delta or dS,
    hit or None)."""
    B = bwl - 5
    if counts:
        p, rows, m, reads, dS, hit = _classic_case(rng, n_rows, bwl, B, R, W, amb)
        if amb:
            hit = np.hstack([hit, np.zeros((hit.shape[0], bwl - B), bool)])
            dS = np.hstack([dS, np.zeros((dS.shape[0], bwl - B), np.float32)])
        return _to(cuda, p, rows, m, reads, dS, hit)
    p, rows, m, reads, delta = _dense_case(rng, n_rows, bwl, B, R, W, amb)
    if amb:
        delta = np.hstack([delta, np.zeros((delta.shape[0], bwl - B), np.float32)])
    return (*_to(cuda, p, rows, m, reads, delta), None)


def _cols_call(plain, plane, rows, m, reads, delta, hit, counts, col0, K=7, pair_rows=False):
    """The fused column kernel (or with ``plain`` its plain version) on one
    shard's inputs (the shifted kernel in read order where ``pair_rows``):
    (pack, the counts form's candidate counts or None)."""
    kw = dict(K=K, k=10, log_eps=-4.2597, col0=col0)
    if counts:
        fn = rowgather_sum_counts_cols_plain if plain else rowgather_sum_counts_cols
        return fn(plane, rows, m, reads, delta, hit, **kw)
    if plain:
        return rowgather_sum_cols_plain(plane, rows, m, reads, delta, **kw), None
    return rowgather_sum_cols(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw), None


@pytest.mark.parametrize("counts,pair_rows", [(False, False), (False, True), (True, False)])
@pytest.mark.parametrize("amb", [True, False])
@pytest.mark.parametrize("R,bwl,n_shards", [(16384, 1408, 1), (16384, 384, 4), (4096, 20096, 1)])
def test_rowgather_sum_cols_bit_equal(cuda, R, bwl, n_shards, counts, amb, pair_rows):
    """Kernel B, the gather with one shard's column finish in its epilogue,
    against its plain version at the sharded dense shapes (D652 1x1 and 1x4,
    config 4 1x1; the shifted form in locality order and in read order): the
    pack but e_s bit-equal (and the counts), e_s within rtol 1e-6, two
    launches alike."""
    for s in range(n_shards):
        rng = np.random.default_rng(R + bwl + s + 2 * counts + amb)
        plane, rows, m, reads, delta, hit = _cols_case(cuda, rng, R, bwl, counts, amb,
                                                       n_rows=4000 if bwl < 5000 else 400)
        assert counts_cols_fits(plane, 7) if counts else cols_fits(plane, 7)
        args = (plane, rows, m, reads, delta, hit, counts, s * bwl)
        got, got_c = _cols_call(False, *args, pair_rows=pair_rows)
        again, again_c = _cols_call(False, *args, pair_rows=pair_rows)
        want, want_c = _cols_call(True, *args)
        assert torch.equal(got, again)
        _check_partial(got, want, f"shard {s}")
        if counts:
            assert torch.equal(got_c, want_c) and torch.equal(got_c, again_c)
        assert (got[:, 14] > 0).any()


def _limit_bw(counts, K=7):
    """The widest shard (a multiple of 4 columns) the fused column kernel
    takes: its shared-memory formula against the card's limit."""
    lo, hi = 256, 1 << 16
    while lo < hi:
        mid = (lo + hi + 4) // 8 * 4
        need, limit = cols_smem(torch.empty((2, mid), device="cuda"), K, counts)
        lo, hi = (mid, hi) if need <= limit else (lo, mid - 4)
    return lo


@pytest.mark.parametrize("counts,pair_rows", [(False, False), (False, True), (True, False)])
def test_rowgather_sum_cols_at_and_past_its_limit(cuda, counts, pair_rows):
    """At the widest shard the fused column kernel takes it launches and
    matches its plain version; one group of four columns past it (the
    plane's rows are whole groups of 4) the wrapper raises; the shard runs
    the gather, the adds and kernel A apart past it, and the shifted shard
    at both widths (past the width rule, ``shifted_fused``): the same pack
    but e_s (rtol 1e-6) and the same counts (``pair_rows``: the shifted
    shard in read order)."""
    from epik_tpu_torch.parallel.sharding import _classic_cols, _shifted_cols

    bw_at = _limit_bw(counts)
    if counts:
        assert 18000 < bw_at < 26000, bw_at
    else:
        assert 30000 < bw_at < 45000, bw_at
    for bw, fits in ((bw_at, True), (bw_at + 4, False)):
        rng = np.random.default_rng(bw)
        plane, rows, m, reads, delta, hit = _cols_case(cuda, rng, 16, bw, counts, True,
                                                       n_rows=120, W=30)
        assert (counts_cols_fits(plane, 7) if counts else cols_fits(plane, 7)) == fits
        kw = dict(K=7, k=10, log_eps=-4.2597, col0=bw)
        args = (plane, rows, m, reads, delta, hit, counts, bw)
        want, want_c = _cols_call(True, *args)
        if not fits:
            with pytest.raises(ValueError, match="shared memory"):
                _cols_call(False, *args, pair_rows=pair_rows)
        else:
            got, got_c = _cols_call(False, *args, pair_rows=pair_rows)
            _check_partial(got, want, f"the fused kernel at bwl {bw}")
            if counts:
                assert torch.equal(got_c, want_c)
        reset_launch_counts()
        if counts:
            got, got_c = _classic_cols(plane, rows, m, reads, delta, hit, **kw)
            assert torch.equal(got_c, want_c)
            expect = ({"rowgather_sum_counts_cols": 1} if fits else
                      {"rowgather_sum_counts": 1, "finish_cols_partial_counts": 1})
        else:
            got = _shifted_cols(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw)
            expect = ({"rowgather_sum_cols": 1} if fits and shifted_fused(bw, cols=True) else
                      {"rowgather_sum": 1, "finish_cols_partial": 1})
        assert {n: c for n, c in launch_counts().items() if c} == expect
        _check_partial(got, want)


def _group_limit(cuda):
    """Bytes a group-layout block may take on the card."""
    return counts_topk_smem(torch.empty((2, 128), device=cuda), 100, 7)[1]


def _group_48kb_edge(cuda, B_of):
    """A width bw and a K whose group-layout block (at its G) asks within 64
    bytes of 48 KB, under the kernel's 384 static bytes: the widest bw (a
    multiple of 8) with such a K (``B_of(bw)`` branches)."""
    edge, limit = 48 * 1024, _group_limit(cuda)
    for bw in range(2048, 256, -8):
        B = B_of(bw)
        for K in range(1, min(64, B) + 1):
            if edge - 64 < group_smem(counts_group(bw, B, K, limit), bw, B, K) <= edge:
                return bw, K
    raise AssertionError("no group layout at the 48 KB edge")


@pytest.mark.parametrize("counts", [False, True])
def test_cols_kernels_at_the_48kb_edge(cuda, counts):
    """Both column kernels where their dynamic shared memory is within 48 KB
    but not with the kernels' static bytes (the launch must opt in): the
    shifted kernel B (the group layout's shifted form, 384 static bytes) at
    the widest such width, the counts form at a width and K within 64 bytes
    of the edge, and kernel A (its 256 bytes of reductions)."""
    edge = 48 * 1024
    K = 7
    if counts:
        bw, K = _group_48kb_edge(cuda, lambda b: b)
        assert edge - 64 < cols_smem(torch.empty((2, bw), device=cuda), K, True)[0] <= edge
    else:
        bw = max(b for b in range(256, 12000, 4)
                 if cols_smem(torch.empty((2, b), device=cuda), 7, counts)[0] <= edge)
        need, _ = cols_smem(torch.empty((2, bw), device=cuda), 7, counts)
        assert need > edge - 256
    rng = np.random.default_rng(bw)
    plane, rows, m, reads, delta, hit = _cols_case(cuda, rng, 64, bw, counts, True, n_rows=200,
                                                   W=40)
    args = (plane, rows, m, reads, delta, hit, counts, 0)
    (got, got_c), (want, want_c) = _cols_call(False, *args, K=K), _cols_call(True, *args, K=K)
    _check_partial(got, want)
    if counts:
        assert torch.equal(got_c, want_c)
    bwl = max(b for b in range(4097, 24000)  # the wide block (512 threads)
              if finish_cols_layout(torch.empty((2, b), device=cuda), 7, counts)["smem"] <= edge)
    assert finish_cols_layout(torch.empty((2, bwl), device=cuda), 7, counts)["smem"] > edge - 256
    B, full, cnt, m_a, _ = _cols_sums(np.random.default_rng(bwl), 40, bwl, 1, counts)
    S_t, m_t = _to(cuda, full, m_a)
    kw = dict(K=7, k=10, log_eps=-4.2597, col0=0)
    if counts:
        C_t = _to(cuda, cnt)[0]
        got, _ = finish_cols_partial_counts(S_t, C_t, m_t, **kw)
        want, _ = finish_cols_partial_counts_plain(S_t, C_t, m_t, **kw)
    else:
        got = finish_cols_partial(S_t, m_t, **kw)
        want = finish_cols_partial_plain(S_t, m_t, **kw)
    _check_partial(got, want)


def _fixed_cols_bytes(bwl, threads, K=7):
    """Kernel A's shared memory less its cache, by the CUDA source's formula:
    the mask words, the 16-bit ids (none past 2**16: the global workspace)
    and the warps' top-K candidates."""
    ids = 0 if bwl > 1 << 16 else (bwl + 1) // 2
    return ((bwl + 31) // 32 + ids) * 4 + threads // 32 * K * 8


@pytest.mark.parametrize("counts", [False, True])
def test_finish_cols_layout_at_its_limit(cuda, counts):
    """Kernel A's layout, one formula in the CUDA source: 128 threads a read
    up to bwl = 4,096 (16 blocks an SM: its register cap) and 512 past it;
    the bytes are the fixed part and the score cache (at most min(bwl, 8,192)
    scores), within what a block may take; two small widths whose cache is
    short of their width take the same bytes, the SM's share at 16 blocks.
    At the widest shard whose fixed part fits (ids in the global
    workspace, no room for a cache) the kernel launches and matches its plain
    version; one column past it the wrapper raises before any launch."""
    K, kw = 7, dict(k=10, log_eps=-4.2597, col0=0)

    def need(bwl):
        lay = finish_cols_layout(torch.empty((2, bwl), device=cuda), K, counts)
        return lay["smem"], lay["limit"]

    for bwl in (384, 1408, 4096, 4097, 20096, 22272, 65536, 65537, 70016):
        lay = finish_cols_layout(torch.empty((2, bwl), device=cuda), K, counts)
        n, limit = need(bwl)
        assert lay["threads"] == (128 if bwl <= 4096 else 512)
        assert lay["blocks_per_sm"] == 16 if bwl <= 4096 else lay["blocks_per_sm"] >= 1
        assert lay["global_ids"] == (bwl > 1 << 16)
        assert 0 <= lay["cache"] <= min(bwl, 8192)
        assert n == _fixed_cols_bytes(bwl, lay["threads"], K) + 4 * lay["cache"] <= limit
    assert finish_cols_layout(torch.empty((2, 1408), device=cuda), K, counts)["cache"] == 1408
    small = [finish_cols_layout(torch.empty((2, bwl), device=cuda), K, counts)
             for bwl in (4000, 4096)]
    assert all(lay["cache"] < 4000 for lay in small)
    assert abs(small[0]["smem"] - small[1]["smem"]) < 4
    lo, hi = 70016, 4_000_000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        n, limit = need(mid)
        lo, hi = (mid, hi) if n <= limit else (lo, mid - 1)
    assert 1_500_000 < lo < 2_000_000, lo
    assert finish_cols_layout(torch.empty((2, lo), device=cuda), K, counts)["cache"] == 0
    rng = np.random.default_rng(lo)
    for bwl, fits in ((lo, True), (lo + 1, False)):
        if counts:
            S, C, m = _to(cuda, *counts_rows(rng, 8, bwl, density=0.001))
            run = lambda: finish_cols_partial_counts(S, C, m, K=K, **kw)  # noqa: E731
            want = finish_cols_partial_counts_plain(S, C, m, K=K, **kw)
        else:
            S, m = _to(cuda, *finish_rows(rng, 8, bwl, density=0.001))
            C = None
            run = lambda: finish_cols_partial(S, m, K=K, **kw)  # noqa: E731
            want = finish_cols_partial_plain(S, m, K=K, **kw)
        reset_launch_counts()
        if fits:
            got = run()
            if counts:
                assert torch.equal(got[1], want[1])
                got, want = got[0], want[0]
            _check_partial(got, want, f"bwl={bwl}")
            assert sum(launch_counts().values()) == 1
        else:
            with pytest.raises(ValueError, match="shared memory"):
                run()
            assert sum(launch_counts().values()) == 0
        del S, C, m


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("bwl", [4096, 22272])
def test_finish_cols_past_the_cache(cuda, bwl, counts):
    """Kernel A where reads touch more columns than its score cache holds
    (they read their row each round), beside reads that fit the cache and
    the fixtures' n = 0 and n < K rows: bit-equal to the plain version but
    e_s (rtol 1e-6), the counts too, two launches alike."""
    R, K, kw = 64, 7, dict(k=10, log_eps=-4.2597, col0=3 * bwl)
    rng = np.random.default_rng(bwl + counts)
    cache = finish_cols_layout(torch.empty((R, bwl), device=cuda), K, counts)["cache"]
    assert 0 < cache < bwl
    if counts:
        S, C, m = counts_rows(rng, R, bwl, density=0.95)
    else:
        S, m = finish_rows(rng, R, bwl, density=0.95)
        C = None
    few = rng.random((R, bwl)) > cache / 2 / bwl
    few[:8] = False
    few[::2] = False  # the even rows keep ~95% touched: past the cache
    S[few] = 0.0
    if counts:
        C[few] = 0
    n = (C > 0 if counts else S > 0).sum(axis=1)
    assert (n > cache).any() and ((n <= cache) & (n > K)).any() and (n < K).any()
    if counts:
        S_t, C_t, m_t = _to(cuda, S, C, m)
        got, got_c = finish_cols_partial_counts(S_t, C_t, m_t, K=K, **kw)
        again, again_c = finish_cols_partial_counts(S_t, C_t, m_t, K=K, **kw)
        want, want_c = finish_cols_partial_counts_plain(S_t, C_t, m_t, K=K, **kw)
        assert torch.equal(got_c, want_c) and torch.equal(again_c, got_c)
    else:
        S_t, m_t = _to(cuda, S, m)
        got = finish_cols_partial(S_t, m_t, K=K, **kw)
        again = finish_cols_partial(S_t, m_t, K=K, **kw)
        want = finish_cols_partial_plain(S_t, m_t, K=K, **kw)
    assert torch.equal(got, again)
    _check_partial(got, want)


@pytest.mark.parametrize("n_data,n_model,cfg", [(1, 1, {}), (2, 2, {}), (1, 4, {}),
                                                (1, 2, {"plane_mode": "classic"}),
                                                (1, 2, {"tokenize_where": "host"})])
def test_sharded_dense_placer_cuda_matches_cpu(cuda, n_data, n_model, cfg, monkeypatch):
    """The column-sharded dense route on the card (a mesh of one repeated
    card) against the same mesh on the CPU: an IUPAC batch, a clean one and
    a batch of reads shorter than k. Same edges; scores within f32 rounding
    of the exp in the ambiguous first hit. Every shard of every step launches
    one fused column kernel (shifted ``rowgather_sum_cols``, classic
    ``rowgather_sum_counts_cols``) and nothing apart, beside the pair plane's
    tokenizer kernel; the torch finish
    (``partial_from_corrected``) never runs on a card tensor."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.kernels import finish_cols as finish_cols_mod
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=81)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=121, mutation_rate=0.05, seed=82)
    amb = reads[:5] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
    short = [("s1", b"ACG"), ("s2", reads[1][1][:9])]
    n = n_data * n_model
    conf = PlacerConfig(**cfg)
    cpu = ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=["cpu"] * n),
                             config=conf)
    reset_launch_counts()
    gpu = ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=[cuda] * n),
                             config=conf)
    assert gpu.route == cpu.route == "dense" and gpu._paired == cpu._paired
    torch_finish = finish_cols_mod.partial_from_corrected

    def cpu_only(corrected, *a, **k):
        assert corrected.device.type == "cpu", "the torch column finish ran on the card"
        return torch_finish(corrected, *a, **k)

    monkeypatch.setattr(finish_cols_mod, "partial_from_corrected", cpu_only)
    for batch in (reads, amb, short):
        want, got = cpu.place(batch), gpu.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    counts = {n: c for n, c in launch_counts().items() if c}
    fused = "rowgather_sum_cols" if gpu._shifted else "rowgather_sum_counts_cols"
    # the pair plane's device tokenizer is one kernel too
    assert (counts.pop("tokenize_combo_fused", 0) > 0) == gpu._paired, counts
    assert list(counts) == [fused] and counts[fused] % n_model == 0, counts


STEP_CASES = [("paired", {}), ("bytes", {"pair_plane": "off"}), ("rows", {"tokenize_where": "host"}),
              ("bytes_classic", {"plane_mode": "classic"}),
              ("rows_classic", {"plane_mode": "classic", "tokenize_where": "host"})]


@pytest.mark.parametrize("kind,cfg", STEP_CASES, ids=[k for k, _ in STEP_CASES])
def test_sharded_dense_steps_launch_one_kernel_per_shard(cuda, kind, cfg):
    """Each sharded dense step (bytes, paired, rows; shifted and classic) on a
    1x2 mesh laid on the card: per step and shard one fused column kernel,
    and no gather, gather with counts or kernel A launch."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel import sharding as sharding_mod
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=81)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 40, length=121, mutation_rate=0.05, seed=84)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
    placer = ShardedTorchPlacer(db, tree, make_mesh(1, 2, devices=[cuda] * 2),
                                config=PlacerConfig(**cfg))
    name = {"paired": "sharded_dense_paired_step", "bytes": "sharded_dense_bytes_step",
            "rows": "sharded_dense_rows_step"}[kind.split("_")[0]]
    steps = [0]
    step = getattr(sharding_mod, name)

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    sharding_mod_step = name
    reset_launch_counts()
    try:
        setattr(sharding_mod, sharding_mod_step, counted)
        placer.place(reads)
    finally:
        setattr(sharding_mod, sharding_mod_step, step)
    torch.cuda.synchronize()
    fused = "rowgather_sum_counts_cols" if kind.endswith("classic") else "rowgather_sum_cols"
    assert steps[0] > 0
    # the paired step tokenizes once a step: both shards lie on the one card
    tok = {"tokenize_combo_fused": steps[0]} if kind == "paired" else {}
    assert {n: c for n, c in launch_counts().items() if c} == {fused: 2 * steps[0], **tok}


def _dense_case(rng, n_rows, bw, B, R, W, amb):
    """A shifted-plane-like f32 plane (zero padding columns, the last row the
    miss row), rows with misses and an n == 0 read, m with a Q1 read, and
    delta rows for a third of the reads."""
    plane = _plane(rng, n_rows, bw)
    plane[:, B:] = 0.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = n_rows - 1
    rows[0] = n_rows - 1
    m = rng.integers(W, W + 40, R).astype(np.float32)
    m[1] = np.float32(2.0**64)
    reads = delta = None
    if amb:
        reads = rng.choice(R, max(1, R // 3), replace=False)
        delta = rng.uniform(-2.0, 6.0, (reads.size, B)).astype(np.float32)
        delta[rng.random(delta.shape) < 0.7] = 0.0
    return plane, rows, m, reads, delta


@pytest.mark.parametrize("n_rows,B,R,W", [
    (300, 19999, 64, 141),  # config 4's unpaired width: bw 20,096, W = 141
    (200, 30000, 16, 40),  # past the old int32-id limit (~28,000 at bw ~ B)
])
def test_rowgather_sum_topk_wide(cuda, n_rows, B, R, W):
    """The fused kernel at the widths of the big trees: bit-equal to its
    plain version but log_sum (rtol 1e-6), two launches alike, and within
    the limit ``topk_fits`` states."""
    rng = np.random.default_rng(B + W)
    bw = -(-B // 128) * 128
    plane, rows, m, reads, delta = _dense_case(rng, n_rows, bw, B, R, W, True)
    t = [torch.from_numpy(x).to(cuda) for x in (plane, rows, m, reads, delta)]
    K = 7
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
    need, limit = topk_smem(t[0], B, K)
    assert topk_fits(t[0], B, K) and need <= limit
    got = rowgather_sum_topk(*t, **kw)
    assert torch.equal(rowgather_sum_topk(*t, **kw), got)
    want = rowgather_sum_topk_plain(*t, **kw).cpu().numpy()
    _check_pack(got.cpu().numpy(), want, K, B)
    assert want[0, 2 * K + 1] == 0


def test_rowgather_sum_topk_past_its_limit(cuda):
    """A tree past the fused kernel's shared-memory limit: the wrapper
    raises stating the bytes, and the dense step runs the gather, the delta
    add and ``finish_topk`` apart, bit-equal to the fused plain version."""
    from epik_tpu_torch.engine.step import _shifted_finish, dense_gather

    rng = np.random.default_rng(40)
    B, R, W = 40000, 16, 30
    bw = -(-B // 128) * 128
    plane, rows, m, reads, delta = _dense_case(rng, 120, bw, B, R, W, True)
    t = [torch.from_numpy(x).to(cuda) for x in (plane, rows, m, reads, delta)]
    K = 7
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
    need, limit = topk_smem(t[0], B, K)
    assert need > limit and not topk_fits(t[0], B, K)
    with pytest.raises(ValueError, match="shared memory"):
        rowgather_sum_topk(*t, **kw)
    # the step's ambiguous reads are the reads with a non-miss ambiguous row
    arows = np.full((R, 2), 119, np.int32)
    arows[reads, 0] = rng.integers(0, 119, reads.size)
    arows_t = torch.from_numpy(arows).to(cuda)
    reset_launch_counts()
    got = _shifted_finish(t[0], t[1], t[2], arows_t, Amax=2, zero_row=119, eps=5.5e-5,
                          gather=dense_gather(t[0], B, K, shifted=True), **kw)
    counts = launch_counts()
    assert counts["rowgather_sum"] == 1 and counts["finish_topk"] == 1
    assert counts["rowgather_sum_topk"] == 0
    from epik_tpu_torch.ops.dense import amb_deltas
    a_read, a_delta = amb_deltas(t[0], arows_t, zero_row=119, B=B, k=10, eps=5.5e-5,
                                 log_eps=-4.2597)
    want = rowgather_sum_topk_plain(t[0], t[1], t[2], a_read, a_delta, **kw).cpu().numpy()
    _check_pack(got.cpu().numpy(), want, K, B)


@pytest.mark.parametrize("R,B,K", [(40, 70000, 7), (8, 65537, 5), (300, 66000, 7)])
def test_finish_past_16_bit_ids(cuda, R, B, K):
    """``finish_topk`` past B = 2**16, the ids in the global workspace (R
    above the blocks that fit at once, so blocks take several reads): every
    index equal, two launches alike, the ties to the lowest index."""
    rng = np.random.default_rng(B + R)
    Sp, m = finish_rows(rng, R, B, density=0.05)
    Sp_t, m_t = torch.from_numpy(Sp).to(cuda), torch.from_numpy(m).to(cuda)
    kw = dict(K=K, k=10, log_eps=-4.2597)
    got = finish_topk(Sp_t, m_t, **kw)
    assert torch.equal(finish_topk(Sp_t, m_t, **kw), got)
    got = got.cpu().numpy()
    _check_pack(got, finish_topk_plain(Sp_t, m_t, **kw).cpu().numpy(), K, B)
    np.testing.assert_array_equal(got[2, K:K + min(K, 20)], np.arange(10, 10 + min(K, 20)))


@pytest.mark.parametrize("n_rows,bw,B,R,W", [
    (2000, 1408, 1303, 300, 143),  # D652's widths, unpaired
    (64, 128, 40, 50, 9),
    (300, 4608, 4500, 24, 17),  # more than 1,024 column groups; the fused kernel at G = 2
    (40, 128, 100, 3, 2500),  # W > one shared-memory tile of row ids
    (40, 132, 100, 3, 2500),  # a width not a multiple of 8: 8-byte vectors
])
@pytest.mark.parametrize("pair_rows", [False, True])
def test_int16_variants_bit_equal(cuda, n_rows, bw, B, R, W, pair_rows):
    """Kernel 1 over an int16 plane: the dequantized sums and the fused pack
    bit-equal to their plain versions (exact int32 sums, carried between
    tiles of row ids as they are, one correctly rounded divide), with delta
    rows, the reads in locality order and in read order, two launches
    alike."""
    rng = np.random.default_rng(n_rows * 3 + W)
    q = rng.integers(1, 32001, (n_rows, bw)).astype(np.int16)
    q[rng.random((n_rows, bw)) > 0.3] = 0
    q[:, B:] = 0
    q[-1] = 0
    plane = torch.from_numpy(q).to(cuda)
    _, rows, m, reads, delta = _dense_case(rng, n_rows, bw, B, R, W, True)
    rows, m, reads, delta = (torch.from_numpy(x).to(cuda) for x in (rows, m, reads, delta))
    scale = 32000.0 / 4.2597
    sums = rowgather_sum(plane, rows, scale=scale, pair_rows=pair_rows)
    torch.cuda.synchronize()
    assert torch.equal(sums, rowgather_sum_plain(plane, rows, scale))
    K = min(7, B)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597, scale=scale, pair_rows=pair_rows)
    got = rowgather_sum_topk_int16(plane, rows, m, reads, delta, **kw)
    assert torch.equal(rowgather_sum_topk_int16(plane, rows, m, reads, delta, **kw), got)
    del kw["pair_rows"]
    want = rowgather_sum_topk_plain(plane, rows, m, reads, delta, **kw).cpu().numpy()
    _check_pack(got.cpu().numpy(), want, K, B)


@pytest.mark.parametrize("n_rows,bw,R,W", [
    (2000, 1408, 300, 143), (300, 256, 64, 17), (64, 4608, 8, 9), (40, 128, 3, 2500),
    (300, 20096, 16, 141),
])
@pytest.mark.parametrize("cell", ["f32", "bf16"])
def test_rowgather_sum_counts_bit_equal(cuda, n_rows, bw, R, W, cell):
    """Kernel 1 with counts over the classic plane (negative scores, the
    -1e-37 nudge), f32 and bf16: the sums' bits and the counts equal to the
    plain version's, two launches alike."""
    rng = np.random.default_rng(n_rows + bw + W)
    p = rng.uniform(-7.0, -0.01, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[0, :8] = np.float32(-1e-37)
    p[-1] = 0.0
    plane = torch.from_numpy(p).to(cuda)
    fn = rowgather_sum_counts
    if cell == "bf16":
        plane, fn = plane.to(torch.bfloat16), rowgather_sum_counts_bf16
    rows = torch.from_numpy(rng.integers(0, n_rows, (R, W)).astype(np.int32)).to(cuda)
    S, C = fn(plane, rows)
    S2, C2 = fn(plane, rows)
    S_p, C_p = rowgather_sum_counts_plain(plane, rows)
    torch.cuda.synchronize()
    assert torch.equal(_bits(S), _bits(S_p)) and torch.equal(C, C_p)
    assert torch.equal(_bits(S2), _bits(S)) and torch.equal(C2, C)


def _overlapping_rows(rng, R, W, n_rows, n_ref=None):
    """Reads as windows of one row sequence at random starts (reads that
    overlap share rows at every offset, as sampled reads do), with a tenth of
    the windows missing (the zero row, ``n_rows - 1``)."""
    ref = rng.integers(0, n_rows - 1, n_ref or 4 * W + R)
    start = rng.integers(0, ref.size - W + 1, R)
    rows = ref[start[:, None] + np.arange(W)[None, :]]
    rows[rng.random((R, W)) < 0.1] = n_rows - 1
    return rows.astype(np.int32)


@pytest.mark.parametrize("R,W,bw,kind", [
    pytest.param(0, 143, 1408, "random", id="R0"),
    pytest.param(1, 143, 1408, "random", id="R1"),
    pytest.param(300, 143, 1408, "overlapping", id="R300-W143-bw1408"),
    pytest.param(300, 1, 1408, "random", id="W1"),
    pytest.param(64, 1500, 1408, "overlapping", id="W1500-past-a-row-id-tile"),
    pytest.param(300, 143, 1408, "all-miss", id="all-miss"),
    pytest.param(300, 143, 1408, "ties", id="ties-one-least-row"),
    pytest.param(40, 143, 22272, "overlapping", id="bw22272"),
    pytest.param(300, 143, 1412, "ties", id="bw1412-not-a-slice-multiple"),
    pytest.param(33, 17, 100, "random", id="bw100-R33"),
])
@pytest.mark.parametrize("cell", ["f32", "bf16"])
def test_rowgather_sum_counts_in_locality_order(cuda, R, W, bw, kind, cell):
    """Kernel 1c (the gather with counts) in its own layout -- the reads in
    locality order, the row in 256-byte column slices -- against its plain
    version, bit for bit, two launches alike: R = 0 and 1, W = 1 and past a
    staged tile of row ids, rows that all miss, many reads whose least row
    is the same (ties keep read order), the wide classic width and widths
    that are not a multiple of the slice (bf16: nor of 8 cells)."""
    rng = np.random.default_rng(R + W + bw)
    n_rows = 400
    p = rng.uniform(-7.0, -0.01, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[0, :8] = np.float32(-1e-37)
    p[-1] = 0.0
    plane = torch.from_numpy(p).to(cuda)
    fn = rowgather_sum_counts
    if cell == "bf16":
        plane, fn = plane.to(torch.bfloat16), rowgather_sum_counts_bf16
    if kind == "random":
        rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    elif kind == "all-miss":
        rows = np.full((R, W), n_rows - 1, np.int32)
    else:
        rows = _overlapping_rows(rng, R, W, n_rows)
        if kind == "ties":
            rows[:, W // 2] = 0  # every read's least row
    rows_t = torch.from_numpy(rows).to(cuda)
    order = locality_order(rows_t).cpu().numpy()
    if W:
        np.testing.assert_array_equal(order, np.argsort(rows.min(axis=1), kind="stable"))
    if kind == "ties":
        np.testing.assert_array_equal(order, np.arange(R))
    reset_launch_counts()
    S, C = fn(plane, rows_t)
    S2, C2 = fn(plane, rows_t)
    S_p, C_p = rowgather_sum_counts_plain(plane, rows_t)
    torch.cuda.synchronize()
    assert launch_counts()[fn.__name__] == (2 if R else 0)
    assert torch.equal(_bits(S), _bits(S_p)) and torch.equal(C, C_p)
    assert torch.equal(_bits(S2), _bits(S)) and torch.equal(C2, C)
    if kind == "all-miss":
        assert not S.any() and not C.any()


@pytest.mark.parametrize("R,W,bw,n_rows,kind", [
    pytest.param(16381, 72, 1408, 20000, "overlapping", id="d652-pair-rows"),
    pytest.param(4096, 143, 40064, 2000, "overlapping", id="bw40064-wide-shifted"),
    pytest.param(0, 143, 1408, 400, "random", id="R0"),
    pytest.param(300, 0, 1408, 400, "random", id="W0"),
    pytest.param(1, 143, 1408, 400, "random", id="R1"),
    pytest.param(64, 1500, 1408, 400, "overlapping", id="W1500-past-a-tile-of-steps"),
    pytest.param(300, 143, 1408, 400, "all-miss", id="all-miss"),
    pytest.param(300, 143, 1408, 400, "ties", id="ties-one-least-row"),
    pytest.param(300, 143, 1412, 400, "overlapping", id="bw1412-not-a-multiple-of-8"),
    pytest.param(33, 17, 100, 400, "random", id="bw100-R33"),
])
@pytest.mark.parametrize("cell", ["f32", "int16"])
def test_rowgather_sum_in_locality_order(cuda, R, W, bw, n_rows, kind, cell):
    """Kernel 1d (the gather alone) in the slice layout -- the reads in
    locality order or in read order (as the paired steps run it), the row in
    256-byte column slices -- against its plain version, bit for bit (int16:
    exact int32 sums, one correctly rounded divide by the scale), two
    launches alike: D652's pair rows and the wide shifted width,
    R = 0 and 1, W = 0 and past a staged tile of steps, rows that all miss,
    many reads whose least row is the same, and widths that are not a
    multiple of the slice (int16: nor of 8 cells)."""
    rng = np.random.default_rng(R + W + bw)
    if cell == "f32":
        p = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
        p[rng.random((n_rows, bw)) > 0.3] = 0.0
        p[0, :8] = np.float32(1e-37)
        scale = None
    else:
        p = rng.integers(1, 32001, (n_rows, bw)).astype(np.int16)
        p[rng.random((n_rows, bw)) > 0.3] = 0
        scale = 32000.0 / 4.2597
    p[-1] = 0
    plane = torch.from_numpy(p).to(cuda)
    if kind == "random":
        rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    elif kind == "all-miss":
        rows = np.full((R, W), n_rows - 1, np.int32)
    else:
        rows = _overlapping_rows(rng, R, W, n_rows)
        if kind == "ties":
            rows[:, W // 2] = 0  # every read's least row
    rows_t = torch.from_numpy(rows).to(cuda)
    reset_launch_counts()
    got = rowgather_sum(plane, rows_t, scale=scale)
    again = rowgather_sum(plane, rows_t, scale=scale)
    in_read_order = rowgather_sum(plane, rows_t, scale=scale, pair_rows=True)
    want = rowgather_sum_plain(plane, rows_t, scale)
    torch.cuda.synchronize()
    assert launch_counts()["rowgather_sum"] == (3 if R else 0)
    assert got.shape == (R, bw)
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(again), _bits(got))
    assert torch.equal(_bits(in_read_order), _bits(want))
    if kind == "all-miss" or W == 0:
        assert not got.any()


@pytest.mark.parametrize("config", [
    dict(pair_plane="off"), dict(plane_mode="classic"), dict(precision="int16"),
    dict(precision="bf16"), dict(lookup_where="device"), dict(tokenize_where="host"),
])
def test_dense_configs_cuda_match_cpu(cuda, config):
    """Each dense config on the card against the same config on the CPU
    (plain versions): same edges, scores within f32 rounding of the exp in
    the ambiguous first hit; a batch of short reads and a 65,536 bp read
    (the host tokenizer) too; the config's kernel launched."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=31)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=101, mutation_rate=0.05, seed=32)
    reads += [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    batches = [reads, [("a", b"ACG"), ("b", b"")],
               [("long", (reads[0][1] * 700)[:65536]), ("r", reads[1][1])]]
    cfg = PlacerConfig(**config)
    cpu = TorchPlacer(db, tree, config=cfg, device="cpu")
    reset_launch_counts()
    gpu = TorchPlacer(db, tree, config=cfg, device=cuda)
    for batch in batches:
        want, got = cpu.place(batch), gpu.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    counts = launch_counts()
    kernel = ("rowgather_sum_topk_int16" if gpu._plane_q
              else "rowgather_sum_topk" if gpu._shifted
              else "rowgather_sum_counts_topk_bf16" if config.get("precision") == "bf16"
              else "rowgather_sum_counts_topk")
    assert counts[kernel] > 0, counts
    # the classic steps end in the fused kernel: no gather with counts, no finish apart
    assert not (counts["rowgather_sum_counts"] or counts["rowgather_sum_counts_bf16"]
                or counts["finish_topk_counts"] or counts["finish_topk"]), counts


@pytest.mark.parametrize("amb", [False, True])
def test_rowgather_sum_topk_config2_shape(cuda, amb):
    """The fused kernel 1 at the amino main path's shape (BASELINE.md config
    2: R = 4,096 reads of 144 aa, k = 8, so W = 137; bw 1,408, B = 1,303,
    K = 7), with and without ambiguous delta rows: bit-equal to its plain
    version but log_sum, two launches alike."""
    rng = np.random.default_rng(2)
    n_rows, bw, B, R, W, K = 60_000, 1408, 1303, 4096, 137, 7
    plane_np = _plane(rng, n_rows, bw, density=0.01)
    plane_np[:, B:] = 0.0
    plane_np[-1] = 0.0  # the zero row
    plane = torch.from_numpy(plane_np).to(cuda)
    rows_np = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows_np[rng.random((R, W)) < 0.5] = n_rows - 1  # misses
    rows_np[0] = n_rows - 1
    rows = torch.from_numpy(rows_np).to(cuda)
    m_np = np.full(R, W, np.float32)
    m_np[1] = np.float32(2.0**64)  # quirk Q1: a read shorter than k
    m = torch.from_numpy(m_np).to(cuda)
    reads = delta = None
    if amb:
        reads = torch.from_numpy(np.sort(rng.choice(R, 40, replace=False))).to(cuda)
        d = rng.uniform(0.0, 6.0, (40, B)).astype(np.float32)
        d[rng.random(d.shape) < 0.95] = 0.0
        delta = torch.from_numpy(d).to(cuda)
    kw = dict(B=B, K=K, k=8, log_eps=-9.0)
    assert topk_fits(plane, B, K)
    got = rowgather_sum_topk(plane, rows, m, reads, delta, **kw)
    assert torch.equal(rowgather_sum_topk(plane, rows, m, reads, delta, **kw), got)
    want = rowgather_sum_topk_plain(plane, rows, m, reads, delta, **kw).cpu().numpy()
    _check_pack(got.cpu().numpy(), want, K, B)


def _oracle_close(want, got, eps=1e-4, per_edge=False):
    """Score sets within ``eps`` on every read; with ``per_edge``, the whole
    jplace_diff rule (tools/jplace_diff.py): a read whose sets differ may
    still match edge by edge within ``eps`` in probability space."""
    a = {q.sequence: {p.branch_id: p.score for p in q.placements} for q in want.placed_seqs}
    b = {q.sequence: {p.branch_id: p.score for p in q.placements} for q in got.placed_seqs}
    assert set(a) == set(b)
    for seq, ea in a.items():
        eb = b[seq]
        sa, sb = sorted(ea.values()), sorted(eb.values())
        if len(sa) == len(sb) and all(abs(x - y) <= eps for x, y in zip(sa, sb)):
            continue
        assert per_edge and set(ea) == set(eb), seq
        assert all(abs(10.0 ** ea[e] - 10.0 ** eb[e]) <= eps for e in ea), seq


@pytest.mark.parametrize("db_kind,config", [
    ("amino", {}), ("amino", dict(pair_plane="on")), ("amino", dict(precision="int16")),
    ("amino", dict(dense_db="off")), ("dna14", {}), ("dna14", dict(pair_plane="on")),
])
def test_codes_placer_cuda_matches_oracle(cuda, db_kind, config):
    """Amino (k = 6) and DNA k = 14 on the card: the codes tokenizer and the
    radix lookup, then the fused kernel 1 (the CSR step's kernel 4 with
    counts under ``dense_db="off"``), against the scalar oracle (score sets
    within 1e-4; int16 by its edges within 1e-4 in probability space) and
    the same placer on the CPU (same edges)."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.reference import ReferencePlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    if db_kind == "amino":
        db, ref = reference_like_db(num_leaves=48, kmer_size=6, ref_length=20_000,
                                    mean_posting_len=6.0, sequence_type="amino", seed=21)
        reads = reads_from_reference(ref, 60, length=90, mutation_rate=0.04,
                                     sequence_type="amino", seed=22)
        reads += [("amb", reads[0][1][:30] + b"X" + reads[0][1][31:]),
                  ("ambB", b"B" + reads[1][1][:50]), ("short", b"AC"), ("nohit", b"W" * 40)]
    else:
        db, ref = reference_like_db(num_leaves=24, kmer_size=14, ref_length=12_000,
                                    mean_posting_len=6.0, seed=141)
        reads = reads_from_reference(ref, 50, length=81, mutation_rate=0.03, seed=142)
        reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
                  ("short", b"ACGTACG"), ("nohit", b"T" * 40)]
    tree = parse_newick(db.tree())
    cfg = PlacerConfig(**config)
    cpu = TorchPlacer(db, tree, config=cfg, device="cpu")
    reset_launch_counts()
    gpu = TorchPlacer(db, tree, config=cfg, device=cuda)
    got = gpu.place(reads)
    counts = launch_counts()
    if config.get("dense_db") == "off":
        assert gpu.route == "csr" and counts["accumulate_sums_counts"] > 0, counts
    else:
        assert gpu._fast_codes and gpu._paired_codes == ("pair_plane" in config)
        kernel = "rowgather_sum_topk_int16" if gpu._plane_q else "rowgather_sum_topk"
        assert counts[kernel] > 0 and counts["rowgather_sum"] == 0, counts
    want = cpu.place(reads)
    np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
    np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                               rtol=1e-6, atol=1e-6)
    _oracle_close(ReferencePlacer(db, tree).place(reads), got, per_edge=gpu._plane_q)


# ---- kernel 1 with counts and the counts finish fused in; the counts finish alone -------


def _classic_case(rng, n_rows, bw, B, R, W, amb):
    """A classic-plane-like f32 plane (negative cells, the -1e-37 nudge, zero
    padding columns, the last row the miss row), rows with misses and an n ==
    0 read, m with a read shorter than k (2**64) and two reads whose counts
    pass m (the Q1 wrap), and the ambiguous first hits of a third of the
    reads: (reads, dS, hit), dS positive where hit."""
    p = rng.uniform(-7.0, -0.01, (n_rows, bw)).astype(np.float32)
    p[rng.random((n_rows, bw)) > 0.3] = 0.0
    p[0, :8] = np.float32(-1e-37)
    p[:, B:] = 0.0
    p[-1] = 0.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    rows[rng.random((R, W)) < 0.3] = n_rows - 1
    rows[0] = n_rows - 1
    m = rng.integers(W, W + 40, R).astype(np.float32)
    m[1] = np.float32(2.0**64)
    m[2:4] = 1.0  # counts of 2 and more wrap m - C
    reads = dS = hit = None
    if amb:  # read 0 stays untouched
        reads = rng.choice(np.arange(1, R), max(1, R // 3), replace=False)
        hit = rng.random((reads.size, B)) < 0.3
        dS = np.where(hit, rng.uniform(1e-4, 0.1, hit.shape), 0.0).astype(np.float32)
    return p, rows, m, reads, dS, hit


def _check_full_pack(got, want, K, B):
    """The full pack's body: scores, ids, counts, n and zero_sum bit-equal,
    wr within rtol 1e-4 (10**(score - log_sum), log_sum summed in another
    order)."""
    np.testing.assert_array_equal(got[:, :K], want[:, :K])
    np.testing.assert_array_equal(got[:, 2 * K:], want[:, 2 * K:])
    assert ((got[:, 2 * K:3 * K] >= 0) & (got[:, 2 * K:3 * K] < B)).all()
    np.testing.assert_allclose(got[:, K:2 * K], want[:, K:2 * K], rtol=1e-4, atol=1e-30)


def _to(cuda, *xs):
    return [None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in xs]


@pytest.mark.parametrize("n_rows,bw,B,R,W", [
    (2000, 1408, 1303, 300, 143),  # D652's classic widths
    (64, 128, 40, 50, 9),
    (300, 4608, 4500, 24, 17),  # more than 1,024 column groups
    (40, 128, 100, 3, 2500),  # W > one shared-memory tile of row offsets
])
@pytest.mark.parametrize("cell", ["f32", "bf16"])
@pytest.mark.parametrize("amb", [False, True])
def test_rowgather_sum_counts_topk_bit_equal(cuda, n_rows, bw, B, R, W, cell, amb):
    """Kernel 1 with counts and the counts finish fused in, against its
    plain version: scores, ids, counts, n and zero_sum bit-equal, wr within
    rtol 1e-4, with and without first hits, the wrap rows among them; two
    launches alike."""
    rng = np.random.default_rng(n_rows + bw + W)
    p, rows, m, reads, dS, hit = _classic_case(rng, n_rows, bw, B, R, W, amb)
    plane, rows, m, reads, dS, hit = _to(cuda, p, rows, m, reads, dS, hit)
    fn = rowgather_sum_counts_topk
    if cell == "bf16":
        plane, fn = plane.to(torch.bfloat16), rowgather_sum_counts_topk_bf16
    K = min(7, B)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
    got = fn(plane, rows, m, reads, dS, hit, **kw)
    assert torch.equal(fn(plane, rows, m, reads, dS, hit, **kw), got)
    want = rowgather_sum_counts_topk_plain(plane, rows, m, reads, dS, hit, **kw)
    _check_full_pack(got.cpu().numpy(), want.cpu().numpy(), K, B)
    assert want[0, 4 * K] == 0


@pytest.mark.parametrize("R,B,K,density", [
    (300, 1303, 7, 0.2), (64, 19999, 7, 0.2), (16, 40, 40, 0.2),
    (16, 12000, 7, 0.9),  # more touched branches than the block caches
    (8, 65537, 5, 0.05), (300, 66000, 7, 0.05),  # ids in the global workspace
])
@pytest.mark.parametrize("full", [True, False])
def test_finish_topk_counts_bit_equal(cuda, R, B, K, density, full):
    """The counts finish alone on the quirk rows (C > m, m = 2**64, n = 0,
    n < K, ties, Q3, touched at S >= 0), strided rows, past the block's
    score cache and past B = 2**16 (the ids in the global workspace), in
    both forms: the full body as ``_check_full_pack``, the slim pack as
    ``_check_pack``; two launches alike; the ties to the lowest index."""
    rng = np.random.default_rng(B + R)
    S, C, m = counts_rows(rng, R, B, density=density)
    wide_S = np.zeros((S.shape[0], B + 64), np.float32)
    wide_S[:, :B] = S
    S_t, C_t, m_t = _to(cuda, wide_S, C, m)
    S_t = S_t[:, :B]
    kw = dict(K=K, k=10, log_eps=-4.2597, full=full)
    got = finish_topk_counts(S_t, C_t, m_t, **kw)
    assert torch.equal(finish_topk_counts(S_t, C_t, m_t, **kw), got)
    got = got.cpu().numpy()
    want = finish_topk_counts_plain(S_t, C_t, m_t, **kw).cpu().numpy()
    if full:
        _check_full_pack(got, want, K, B)
        ix = slice(2 * K, 3 * K)
    else:
        _check_pack(got, want, K, B)
        ix = slice(K, 2 * K)
    kk = min(K, 20)
    np.testing.assert_array_equal(got[2, ix][:kk], np.arange(10, 10 + kk))


def _limit_B(plane_for, K):
    """The largest B (plane width B rounded up to 128) the fused counts
    kernel takes, by the CUDA source's formula against the card's limit."""
    lo, hi = 1024, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        need, limit = counts_topk_smem(plane_for(-(-mid // 128) * 128), mid, K)
        lo, hi = (mid, hi) if need <= limit else (lo, mid - 1)
    return lo


def test_rowgather_sum_counts_topk_at_and_past_its_limit(cuda):
    """At the widest tree the fused counts kernel takes (its shared-memory
    formula against the card's limit) it launches and matches its plain
    version; one branch past it the wrapper raises stating the bytes and the
    classic step runs ``rowgather_sum_counts`` + ``finish_topk_counts``: the
    same bits."""
    from epik_tpu_torch.engine.step import _classic_finish, dense_gather
    from epik_tpu_torch.ops.dense import amb_classic_deltas

    K = 7
    B_at = _limit_B(lambda bw: torch.empty((2, bw), device=cuda), K)
    assert 18000 < B_at < 26000, B_at  # near 22,000 at bw ~ B
    for B, fits in ((B_at, True), (B_at + 1, False)):
        rng = np.random.default_rng(B)
        bw = -(-B // 128) * 128
        p, rows, m, _, _, _ = _classic_case(rng, 120, bw, B, 16, 30, False)
        arows = np.full((16, 2), 119, np.int32)
        arows[1::4, 0] = rng.integers(0, 119, 4)
        plane, rows, m, arows = _to(cuda, p, rows, m, arows)
        kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
        need, limit = counts_topk_smem(plane, B, K)
        assert (need <= limit) == fits == counts_topk_fits(plane, B, K)
        reads, dS, hit = amb_classic_deltas(plane, arows, zero_row=119, B=B, k=10, eps=5.5e-5)
        assert reads.numel() > 0
        want = rowgather_sum_counts_topk_plain(plane, rows, m, reads, dS, hit, **kw)
        if not fits:
            with pytest.raises(ValueError, match="shared memory"):
                rowgather_sum_counts_topk(plane, rows, m, reads, dS, hit, **kw)
        reset_launch_counts()
        got = _classic_finish(plane, rows, m, arows, Amax=2, zero_row=119, eps=5.5e-5,
                              gather=dense_gather(plane, B, K, shifted=False), **kw)
        counts = {n: c for n, c in launch_counts().items() if c}
        assert counts == ({"rowgather_sum_counts_topk": 1} if fits else
                          {"rowgather_sum_counts": 1, "finish_topk_counts": 1}), counts
        assert not got[-1].any()  # the zero totals row
        _check_full_pack(got[:-1].cpu().numpy(), want.cpu().numpy(), K, B)


def test_counts_group_bytes_equal_the_cuda_source(cuda):
    """The group layout's bytes by the Python formula (``group_smem``) equal
    the CUDA source's (``epik_rowgather_counts_group_smem``) over G, widths
    and K; the wrappers ask the bytes of ``counts_group``'s G, the largest up
    to GROUP_MAX of which GROUP_MIN_BLOCKS blocks fit the card's limit (one
    block at the widest trees), and the card's occupancy calculator holds
    that many blocks of the compiled kernels an SM."""
    from epik_tpu_torch.kernels._build import library

    lib = library()
    for G in (1, 2, 3, 7, 8, 9, 16, 32):
        for bw, B in ((128, 40), (1408, 1303), (4608, 4500), (22016, 22016), (22272, 22199),
                      (65536, 65536)):
            for K in (1, 7, 64):
                assert lib.epik_rowgather_counts_group_smem(G, bw, B, K) == \
                    group_smem(G, bw, B, K), (G, bw, B, K)
    limit = _group_limit(cuda)
    assert 230_000 < limit < 232_448  # the opt-in bytes less the static ones
    for bw, B in ((1408, 1303), (4608, 4500), (12288, 12000), (22016, 22016)):
        G = counts_group(bw, B, 7, limit)
        assert 1 <= G <= GROUP_MAX
        fits = [GROUP_MIN_BLOCKS * (group_smem(g, bw, B, 7) + GROUP_BLOCK_RESERVE)
                 <= limit + GROUP_BLOCK_RESERVE for g in (G, G + 1)]
        assert (G == 1 or fits[0]) and (G == GROUP_MAX or not fits[1])
        plane = torch.empty((2, bw), device=cuda)
        assert counts_topk_smem(plane, B, 7) == (group_smem(G, bw, B, 7), limit)
        Gc = counts_group(bw, bw, 7, limit)
        assert cols_smem(plane, 7, True) == (group_smem(Gc, bw, bw, 7), limit)
        if G > 1:  # the register budget and the bytes give the blocks aimed at
            for cell, cols in ((0, 0), (2, 0), (0, 1)):
                assert lib.epik_rowgather_counts_group_blocks_per_sm(
                    G, bw, B, 7, cell, cols) >= GROUP_MIN_BLOCKS, (bw, cell, cols)
    assert counts_group(22016, 22016, 7, limit) == 1


def _group_steps(cuda, B_of):
    """Widths (multiples of 8) around the steps of ``counts_group``: the
    first below GROUP_MAX and the one to G = 1, each with the width 8 below
    it, as (bw, G) pairs."""
    limit = _group_limit(cuda)
    out, prev = [], None
    for bw in range(256, 24000, 8):
        G = counts_group(bw, B_of(bw), 7, limit)
        if prev is not None and G < prev and (prev == GROUP_MAX or G == 1):
            out += [(bw - 8, prev), (bw, G)]
        prev = G
    return out


def _group_case(cuda, rng, bw, B, R, W, n_rows, G, cols):
    """``_classic_case`` without its first hits, then first hits for the
    read in the middle of every other group of G reads of the locality order
    and of the last group (read 0, which names no row, keeps none); the
    contributions padded to bw columns for the column kernel: (plane, rows,
    m, reads, dS, hit) on the card."""
    p, rows, m, _, _, _ = _classic_case(rng, n_rows, bw, B, R, W, False)
    perm = locality_order(torch.from_numpy(rows)).numpy()
    last = (R - 1) // G * G
    pos = sorted({*range(G // 2, R, 2 * G), last + (R - last) // 2})
    reads = np.array([r for r in perm[pos] if r != 0], np.int64)
    width = bw if cols else B
    hit = np.zeros((reads.size, width), bool)
    hit[:, :B] = rng.random((reads.size, B)) < 0.3
    dS = np.where(hit, rng.uniform(1e-4, 0.1, hit.shape), 0.0).astype(np.float32)
    return _to(cuda, p, rows, m, reads, dS, hit)


@pytest.mark.parametrize("kind", ["f32", "bf16", "cols"])
@pytest.mark.parametrize("edge", ["ragged", "steps", "48kb"])
def test_counts_group_layout_edges(cuda, kind, edge):
    """The group layout (``rowgather_sum_counts_topk[_bf16]``, and
    ``rowgather_sum_counts_cols`` with col0 > 0) against its plain version at
    its edges, first hits on the read in the middle of a group: R not a
    multiple of G at D652's widths and window count; the widths where G
    steps down from GROUP_MAX and to G = 1 (each with the width below); a
    block within 64 bytes of 48 KB. Scores, ids, counts, n and zero_sum
    bit-equal (wr within rtol 1e-4; the partial pack but e_s, e_s within
    rtol 1e-6, and the candidates' counts); two launches alike."""
    cols = kind == "cols"
    B_of = (lambda b: b) if cols else (lambda b: b - 5)
    limit = _group_limit(cuda)
    if edge == "ragged":
        cases = [(1408, 7, 143, 2000)]
    elif edge == "steps":
        steps = _group_steps(cuda, B_of)
        assert [G for _, G in steps][-1] == 1 and len(steps) == 4, steps
        cases = [(bw, 7, 30, 120) for bw, _ in steps]
    else:
        cases = [(*_group_48kb_edge(cuda, B_of), 40, 200)]
    for bw, K, W, n_rows in cases:
        B = B_of(bw)
        G = counts_group(bw, B, K, limit)
        R = 5 * G + 3 if edge == "ragged" else 2 * G + 1
        rng = np.random.default_rng(bw + K)
        plane, rows, m, reads, dS, hit = _group_case(cuda, rng, bw, B - (5 if cols else 0), R,
                                                     W, n_rows, G, cols)
        reset_launch_counts()
        if cols:
            args = (plane, rows, m, reads, dS, hit, True, 3 * bw)
            (got, got_c), (again, again_c) = (_cols_call(False, *args, K=K),
                                              _cols_call(False, *args, K=K))
            want, want_c = _cols_call(True, *args, K=K)
            name = "rowgather_sum_counts_cols"
            assert torch.equal(got, again) and torch.equal(got_c, again_c)
            _check_partial(got, want, f"bwl {bw}, G {G}")
            assert torch.equal(got_c, want_c)
            assert (got[:, K:2 * K] >= 3 * bw).all()
        else:
            fn = rowgather_sum_counts_topk
            if kind == "bf16":
                plane, fn = plane.to(torch.bfloat16), rowgather_sum_counts_topk_bf16
            kw = dict(B=B, K=K, k=10, log_eps=-4.2597)
            got, again = fn(plane, rows, m, reads, dS, hit, **kw), fn(plane, rows, m, reads,
                                                                      dS, hit, **kw)
            want = rowgather_sum_counts_topk_plain(plane, rows, m, reads, dS, hit, **kw)
            name = fn.__name__
            assert torch.equal(got, again)
            _check_full_pack(got.cpu().numpy(), want.cpu().numpy(), K, B)
        assert {n: c for n, c in launch_counts().items() if c} == {name: 2}, (bw, G)


def test_shifted_group_bytes_equal_the_cuda_source(cuda):
    """The shifted form's bytes by the Python formula (``group_smem(...,
    counts=False)``) equal the CUDA source's
    (``epik_rowgather_shifted_group_smem``) over G, widths and K; the
    wrappers ask the bytes of ``shifted_group``'s G, the largest up to
    SHIFTED_GROUP_MAX of which GROUP_MIN_BLOCKS blocks fit the card's limit
    (one block at the widest trees), and the card's occupancy calculator
    holds that many blocks of the compiled kernels an SM."""
    from epik_tpu_torch.kernels._build import library

    lib = library()
    for G in (1, 2, 3, 7, 8, 9, 16, 32):
        for bw, B in ((128, 40), (384, 384), (1408, 1303), (4608, 4500), (20096, 19999),
                      (36352, 36352), (65536, 65536)):
            for K in (1, 7, 64):
                assert lib.epik_rowgather_shifted_group_smem(G, bw, B, K) == \
                    group_smem(G, bw, B, K, counts=False), (G, bw, B, K)
    limit = _group_limit(cuda)
    for bw, B in ((384, 384), (1408, 1303), (1408, 1408), (4608, 4500), (20096, 19999)):
        G = shifted_group(bw, B, 7, limit)
        assert 1 <= G <= SHIFTED_GROUP_MAX
        fits = [GROUP_MIN_BLOCKS * (group_smem(g, bw, B, 7, False) + GROUP_BLOCK_RESERVE)
                <= limit + GROUP_BLOCK_RESERVE for g in (G, G + 1)]
        assert (G == 1 or fits[0]) and (G == SHIFTED_GROUP_MAX or not fits[1])
        plane = torch.empty((2, bw), device=cuda)
        assert topk_smem(plane, B, 7) == (group_smem(G, bw, B, 7, False), limit)
        Gc = shifted_group(bw, bw, 7, limit)
        assert cols_smem(plane, 7, False) == (group_smem(Gc, bw, bw, 7, False), limit)
        if G > 1:  # the register budget and the bytes give the blocks aimed at
            for cell, cols in ((0, 0), (1, 0), (0, 1)):
                assert lib.epik_rowgather_shifted_group_blocks_per_sm(
                    G, bw, B, 7, cell, cols) >= GROUP_MIN_BLOCKS, (bw, cell, cols)
    assert shifted_group(1408, 1303, 7, limit) == SHIFTED_GROUP_MAX  # D652
    assert shifted_group(20096, 19999, 7, limit) == 1  # config 4


def _shifted_case(cuda, rng, bw, B, R, W, n_rows, G, cell, pair_rows):
    """A shifted plane (f32, or int16 with its scale), rows with misses and
    an n == 0 read, m with a Q1 read, and delta rows for the read in the
    middle of every other group of G reads of the order the kernel takes
    (the locality order, or read order) and of the last group: (plane,
    rows, m, reads, delta, scale) on the card."""
    plane, rows, m, _, _ = _dense_case(rng, n_rows, bw, B, R, W, False)
    scale = None
    if cell == "int16":
        q = rng.integers(1, 32001, (n_rows, bw)).astype(np.int16)
        q[plane == 0] = 0
        plane, scale = q, 32000.0 / 4.2597
    order = (np.arange(R) if pair_rows
             else locality_order(torch.from_numpy(rows)).numpy())
    last = (R - 1) // G * G
    pos = sorted({*range(G // 2, R, 2 * G), last + (R - last) // 2})
    reads = np.array([r for r in order[pos] if r != 0], np.int64)
    delta = rng.uniform(-2.0, 6.0, (reads.size, B)).astype(np.float32)
    delta[rng.random(delta.shape) < 0.7] = 0.0
    return (*_to(cuda, plane, rows, m, reads, delta), scale)


def _shifted_steps(cuda, B_of):
    """For every G ``shifted_group`` can pick, the first width (a multiple of
    8) at which it picks it, as (bw, G) pairs from SHIFTED_GROUP_MAX down to
    1."""
    limit = _group_limit(cuda)
    out = {}
    for bw in range(128, 40000, 8):
        out.setdefault(shifted_group(bw, B_of(bw), 7, limit), bw)
    return sorted(((bw, G) for G, bw in out.items()), key=lambda x: -x[1])


@pytest.mark.parametrize("kind", ["f32", "int16", "cols"])
@pytest.mark.parametrize("edge", ["ragged", "steps", "tiles", "48kb"])
def test_shifted_group_layout_edges(cuda, kind, edge):
    """The group layout's shifted form (``rowgather_sum_topk[_int16]``, and
    ``rowgather_sum_cols`` with col0 > 0) against its plain version at its
    edges, delta rows on the read in the middle of a group, in locality
    order and in read order: R not a multiple of G at D652's widths and
    window count; every G the wrapper can pick, at the first width that
    picks it; windows over two tiles of staged row ids (an int16 plane's
    int32 sums carried between tiles); a block within 64 bytes of 48 KB. The
    slim pack bit-equal but log_sum (rtol 1e-6), the partial pack but e_s
    (rtol 1e-6); two launches alike."""
    cols = kind == "cols"
    B_of = (lambda b: b) if cols else (lambda b: b - 5)
    limit = _group_limit(cuda)
    if edge == "ragged":
        cases = [(1408, 7, 143, 2000)]
    elif edge == "steps":
        steps = _shifted_steps(cuda, B_of)
        assert [G for _, G in steps] == list(range(SHIFTED_GROUP_MAX, 0, -1)), steps
        cases = [(bw, 7, 30, 120) for bw, _ in steps]
    elif edge == "tiles":
        G = shifted_group(1408, B_of(1408), 7, limit)
        cases = [(1408, 7, 2 * (2048 // G) + 3, 400)]
    else:
        edge_b, found = 48 * 1024, None
        for bw in range(2048, 256, -8):
            for K in range(1, min(64, B_of(bw)) + 1):
                G = shifted_group(bw, B_of(bw), K, limit)
                if edge_b - 64 < group_smem(G, bw, B_of(bw), K, False) <= edge_b:
                    found = found or (bw, K)
        assert found is not None
        cases = [(*found, 40, 200)]
    for bw, K, W, n_rows in cases:
        B = B_of(bw)
        G = shifted_group(bw, B, K, limit)
        R = 5 * G + 3 if edge == "ragged" else 2 * G + 1
        for pair_rows in (False, True):
            rng = np.random.default_rng(bw + K + W)
            plane, rows, m, reads, delta, scale = _shifted_case(
                cuda, rng, bw, B, R, W, n_rows, G, "int16" if kind == "int16" else "f32",
                pair_rows)
            if cols:  # the shard's delta rows span its bwl columns
                delta = torch.cat([delta, torch.zeros((delta.shape[0], bw - B), device=cuda)], 1)
            reset_launch_counts()
            if cols:
                kw = dict(K=K, k=10, log_eps=-4.2597, col0=3 * bw)
                got, again = (rowgather_sum_cols(plane, rows, m, reads, delta, pair_rows=pair_rows,
                                                 **kw) for _ in range(2))
                want = rowgather_sum_cols_plain(plane, rows, m, reads, delta, **kw)
                name = "rowgather_sum_cols"
                _check_partial(got, want, f"bwl {bw}, G {G}")
                assert (got[:, K:2 * K] >= 3 * bw).all()
            else:
                fn = rowgather_sum_topk_int16 if kind == "int16" else rowgather_sum_topk
                kw = dict(B=B, K=K, k=10, log_eps=-4.2597,
                          **({"scale": scale} if scale is not None else {}))
                got, again = (fn(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw)
                              for _ in range(2))
                want = rowgather_sum_topk_plain(plane, rows, m, reads, delta, **kw)
                name = fn.__name__
                _check_pack(got.cpu().numpy(), want.cpu().numpy(), K, B)
            assert torch.equal(got, again)
            assert {n: c for n, c in launch_counts().items() if c} == {name: 2}, (bw, G)


@pytest.mark.parametrize("pair_rows", [False, True])
def test_rowgather_sum_topk_at_and_past_its_limit(cuda, pair_rows):
    """The fused shifted kernel at the widest B its shared memory takes (at
    bw = B rounded up to 128) launches and matches its plain version, f32 and
    int16, in locality order and in read order (``pair_rows``); one branch
    past it the wrapper raises. At both the dense step takes the unfused
    pair, past the width rule (``shifted_fused``): the same pack but
    log_sum."""
    from epik_tpu_torch.engine.step import _shifted_finish, dense_gather
    from epik_tpu_torch.ops.dense import amb_deltas

    lo, hi = 1024, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        need, limit = topk_smem(torch.empty((2, -(-mid // 128) * 128), device=cuda), mid, 7)
        lo, hi = (mid, hi) if need <= limit else (lo, mid - 1)
    assert 34000 < lo < 39000, lo
    for B, fits in ((lo, True), (lo + 1, False)):
        bw = -(-B // 128) * 128
        rng = np.random.default_rng(B)
        plane, rows, m, _, _ = _dense_case(rng, 120, bw, B, 16, 30, False)
        arows = np.full((16, 2), 119, np.int32)
        arows[1::4, 0] = rng.integers(0, 119, 4)
        for cell in ("f32", "int16"):
            scale = None
            if cell == "int16":
                q = rng.integers(1, 32001, plane.shape).astype(np.int16)
                q[plane == 0] = 0
                plane_c, scale = q, 32000.0 / 4.2597
            else:
                plane_c = plane
            p_t, rows_t, m_t, arows_t = _to(cuda, plane_c, rows, m, arows)
            assert topk_fits(p_t, B, 7) == fits
            kw = dict(B=B, K=7, k=10, log_eps=-4.2597)
            reads, delta = amb_deltas(p_t, arows_t, zero_row=119, B=B, k=10, eps=5.5e-5,
                                      log_eps=-4.2597, plane_scale=scale or 1.0)
            skw = {"scale": scale} if scale is not None else {}
            want = rowgather_sum_topk_plain(p_t, rows_t, m_t, reads, delta, **kw, **skw)
            fn = rowgather_sum_topk_int16 if scale is not None else rowgather_sum_topk
            if fits:
                _check_pack(fn(p_t, rows_t, m_t, reads, delta, pair_rows=pair_rows, **kw,
                               **skw).cpu().numpy(), want.cpu().numpy(), 7, B)
            else:
                with pytest.raises(ValueError, match="shared memory"):
                    fn(p_t, rows_t, m_t, reads, delta, pair_rows=pair_rows, **kw, **skw)
            reset_launch_counts()
            got = _shifted_finish(p_t, rows_t, m_t, arows_t, Amax=2, zero_row=119, eps=5.5e-5,
                                  plane_scale=scale or 1.0, pair_rows=pair_rows,
                                  gather=dense_gather(p_t, B, 7, shifted=True), **kw)
            fused = fits and shifted_fused(bw)
            assert {n: c for n, c in launch_counts().items() if c} == (
                {fn.__name__: 1} if fused else {"rowgather_sum": 1, "finish_topk": 1})
            _check_pack(got.cpu().numpy(), want.cpu().numpy(), 7, B)


@pytest.mark.parametrize("cols", [False, True])
def test_shifted_width_rule_routes(cuda, cols):
    """The width rule on the card: at the widest plane (shard) the rule
    gives the fused kernel, the step launches it; 128 columns wider, the
    unfused pair; the same pack both ways (but log_sum / e_s)."""
    from epik_tpu_torch.engine.step import _shifted_finish, dense_gather
    from epik_tpu_torch.parallel.sharding import _shifted_cols

    top = SHIFTED_COLS_MAX_BW if cols else SHIFTED_TOPK_MAX_BW
    for bw in (top // 128 * 128, top // 128 * 128 + 128):
        B = bw if cols else bw - 5
        rng = np.random.default_rng(bw)
        plane, rows, m, _, _ = _dense_case(rng, 120, bw, B, 40, 30, False)
        arows = np.full((40, 2), 119, np.int32)
        arows[1::4, 0] = rng.integers(0, 119, 10)
        p_t, rows_t, m_t, arows_t = _to(cuda, plane, rows, m, arows)
        fused = shifted_fused(bw, cols=cols)
        assert fused == (bw <= top)
        reset_launch_counts()
        if cols:
            from epik_tpu_torch.ops.dense import amb_deltas

            reads, delta = amb_deltas(p_t, arows_t, zero_row=119, B=bw, k=10, eps=5.5e-5,
                                      log_eps=-4.2597)
            kw = dict(K=7, k=10, log_eps=-4.2597, col0=0)
            got = _shifted_cols(p_t, rows_t, m_t, reads, delta, **kw)
            _check_partial(got, rowgather_sum_cols_plain(p_t, rows_t, m_t, reads, delta, **kw))
            expect = ({"rowgather_sum_cols": 1} if fused
                      else {"rowgather_sum": 1, "finish_cols_partial": 1})
        else:
            from epik_tpu_torch.ops.dense import amb_deltas

            kw = dict(B=B, K=7, k=10, log_eps=-4.2597)
            reads, delta = amb_deltas(p_t, arows_t, zero_row=119, B=B, k=10, eps=5.5e-5,
                                      log_eps=-4.2597)
            got = _shifted_finish(p_t, rows_t, m_t, arows_t, Amax=2, zero_row=119, eps=5.5e-5,
                                  gather=dense_gather(p_t, B, 7, shifted=True), **kw)
            _check_pack(got.cpu().numpy(), rowgather_sum_topk_plain(
                p_t, rows_t, m_t, reads, delta, **kw).cpu().numpy(), 7, B)
            expect = ({"rowgather_sum_topk": 1} if fused
                      else {"rowgather_sum": 1, "finish_topk": 1})
        assert {n: c for n, c in launch_counts().items() if c} == expect, bw


@pytest.mark.parametrize("ids", ["int64", "int32", "strided"])
@pytest.mark.parametrize("cols", [False, True])
def test_shifted_slot_map_from_read_ids(cuda, ids, cols):
    """The shifted forms make their slot map on the card from the ambiguous
    reads' ids (int64 or int32, contiguous or a strided view, not sorted):
    each read's delta row lands on it, in locality order and in read order;
    the pack bit-equal to the plain version but log_sum / e_s (rtol 1e-6)."""
    bw, R, W = 1408, 50, 30
    B = bw if cols else 1303
    rng = np.random.default_rng(16 + int(cols))
    plane, rows, m, _, _ = _dense_case(rng, 120, bw, B, R, W, False)
    reads = torch.from_numpy(rng.permutation(R)[:12].astype(np.int64)).to(cuda)
    if ids == "int32":
        reads = reads.to(torch.int32)
    elif ids == "strided":
        reads = torch.stack([reads, reads + 1], 1)[:, 0]
        assert not reads.is_contiguous()
    delta = rng.uniform(-2.0, 6.0, (12, B)).astype(np.float32)
    delta[rng.random(delta.shape) < 0.7] = 0.0
    plane, rows, m, delta = _to(cuda, plane, rows, m, delta)
    for pair_rows in (False, True):
        reset_launch_counts()
        if cols:
            kw = dict(K=7, k=10, log_eps=-4.2597, col0=bw)
            got = rowgather_sum_cols(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw)
            _check_partial(got, rowgather_sum_cols_plain(plane, rows, m, reads, delta, **kw))
            name = "rowgather_sum_cols"
        else:
            kw = dict(B=B, K=7, k=10, log_eps=-4.2597)
            got = rowgather_sum_topk(plane, rows, m, reads, delta, pair_rows=pair_rows, **kw)
            _check_pack(got.cpu().numpy(), rowgather_sum_topk_plain(
                plane, rows, m, reads, delta, **kw).cpu().numpy(), 7, B)
            name = "rowgather_sum_topk"
        assert {n: c for n, c in launch_counts().items() if c} == {name: 1}


def test_csr_step_launches_the_counts_finish(cuda):
    """The CSR step (the 400 bp batch of a big-tree placer) launches kernel 4
    with counts and the counts finish once each, and no torch finish runs:
    the pack equals the CPU step's (plain versions) up to the f32 exp of the
    first hit."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=71)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 30, length=400, mutation_rate=0.05, seed=77)
    seqs = list(dict.fromkeys(s for _, s in reads))
    seqs[0] = seqs[0][:40] + b"N" + seqs[0][41:]
    cfg = PlacerConfig(dense_db="off")
    packs = []
    for dev in ("cpu", cuda):
        placer = TorchPlacer(db, tree, config=cfg, device=dev)
        step, P, PA, _ = placer._stage_csr(seqs)
        reset_launch_counts()
        packs.append(step(P, PA).cpu().numpy())
        counts = {n: c for n, c in launch_counts().items() if c}
    assert counts == {"accumulate_sums_counts": 1, "finish_topk_counts": 1}, counts
    want, got = packs
    K = (got.shape[1] - 2) // 4
    np.testing.assert_array_equal(got[-1], want[-1])  # the budget totals
    np.testing.assert_array_equal(got[:-1, 2 * K:], want[:-1, 2 * K:])  # ids, counts, n, flags
    np.testing.assert_allclose(got[:-1, :K], want[:-1, :K], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("counts", [False, True])
def test_finish_at_the_48kb_edge(cuda, counts):
    """B = 7,850, K = 7: the finish's dynamic shared memory (48,980 bytes)
    is under 48 KB but not with the kernel's static bytes, so the launch
    must opt in all the same."""
    rng = np.random.default_rng(7850)
    kw = dict(K=7, k=10, log_eps=-4.2597)
    if counts:
        S_t, C_t, m_t = _to(cuda, *counts_rows(rng, 40, 7850))
        got = finish_topk_counts(S_t, C_t, m_t, **kw).cpu().numpy()
        _check_full_pack(got, finish_topk_counts_plain(S_t, C_t, m_t, **kw).cpu().numpy(), 7,
                         7850)
    else:
        Sp_t, m_t = _to(cuda, *finish_rows(rng, 40, 7850))
        got = finish_topk(Sp_t, m_t, **kw).cpu().numpy()
        _check_pack(got, finish_topk_plain(Sp_t, m_t, **kw).cpu().numpy(), 7, 7850)


def _tile_bytes(tile_w):
    """The row-pointer block's sums and counts, each padded to a multiple of
    4, plus 4."""
    return 8 * (((tile_w + 3) & ~3) + 4)


def _csr_scratch():
    """The row-pointer block's sort storage and sorted chunk, by the radix
    bits of a pass: 5 at B = 1, 4 at the wide classic tree's B = 22,199
    (where the 5-bit block would take two tiles)."""
    five, four = plan(1, True, row_ptr=True), plan(22199, True, row_ptr=True)
    assert (five.radix_bits, four.radix_bits) == (5, 4)
    return {5: five.smem - _tile_bytes(five.tile_w), 4: four.smem - _tile_bytes(four.tile_w)}


def _fewest_tiles(B, scratch, optin):
    n = 1
    while _tile_bytes(-(-B // n)) + scratch > optin:
        n += 1
    return n


def _csr_layout_holds(layout, B, optin=232_448):
    """The row-pointer form's layout is the fewest tiles whose block fits the
    card's opt-in shared memory, the tile's sums and counts beside the
    block's scratch: the 5-bit sort's, or the 4-bit sort's (smaller) where
    that takes fewer tiles."""
    scratch = _csr_scratch()
    assert layout.threads == 1024 and scratch[4] >= 5120 * 8 and scratch[5] > scratch[4]
    n5, n4 = _fewest_tiles(B, scratch[5], optin), _fewest_tiles(B, scratch[4], optin)
    bits = 4 if n4 < n5 else 5
    assert layout.radix_bits == bits and layout.tile_w == -(-B // min(n4, n5))
    assert layout.n_tiles == -(-B // layout.tile_w)
    assert layout.smem == _tile_bytes(layout.tile_w) + scratch[bits] <= optin
    return scratch


def _csr_case(cuda, R, PP, B, layout):
    """The row-pointer form on the engineered rows cut to ragged lengths,
    cells alternating at every tile edge of ``layout``: bit for bit against
    its plain version and a loop over each read's cells in order, two
    launches alike."""
    rng = np.random.default_rng(R * PP + B)
    edges = tuple(layout.tile_w * t for t in range(1, layout.n_tiles))
    b, s = score_rows(rng, R, PP, B, edges=edges)
    lens = rng.integers(0, PP + 1, R)
    lens[[0, 3, 8]] = [PP, 0, PP]
    fb, fs, ptr = flat_cells(b, s, lens, extra=4099)
    b_t, s_t, p_t = (torch.from_numpy(a).to(cuda) for a in (fb, fs, ptr))
    reset_launch_counts()
    S, C = accumulate_sums_counts_csr(b_t, s_t, p_t, R=R, B=B)
    S2, C2 = accumulate_sums_counts_csr(b_t, s_t, p_t, R=R, B=B)
    S_p, C_p = accumulate_sums_counts_csr_plain(b_t, s_t, p_t, R=R, B=B)
    torch.cuda.synchronize()
    assert launch_counts()["accumulate_sums_counts_csr"] == 2
    assert torch.equal(_bits(S), _bits(S_p)) and torch.equal(C, C_p)
    assert torch.equal(_bits(S2), _bits(S)) and torch.equal(C2, C)
    cut_b = np.where(np.arange(PP)[None, :] < lens[:, None], b, B)
    want_S, want_C = cell_order_sums(cut_b, s, B)
    np.testing.assert_array_equal(_bits(S).cpu().numpy(), want_S.view(np.int32))
    np.testing.assert_array_equal(C.cpu().numpy(), want_C)
    assert int(C[3].sum()) == 0 and int(C[0, B - 1]) == PP


@pytest.mark.parametrize("R,PP,B", [
    pytest.param(16, 16384, 19999, id="16-16384-19999"),
    pytest.param(16, 6000, 40000, id="16-6000-40000-two-tiles"),
    pytest.param(16, 2000, 1512, id="16-2000-1512"),
    pytest.param(16, 2000, 1520, id="16-2000-1520"),
    pytest.param(300, 700, 1303, id="300-700-1303"),
    pytest.param(16, 300, 1, id="16-300-1"),
    pytest.param(16, 6000, 65537, id="16-6000-65537"),
    pytest.param(16, 6000, 22199, id="16-6000-22199-wide-classic"),
    # more (read, tile) items than the card holds blocks: each block takes several
    pytest.param(600, 3000, 19999, id="600-3000-19999-items-in-turn"),
])
def test_accumulate_sums_csr_bit_equal(cuda, R, PP, B):
    """Kernel 4's row-pointer form on the engineered rows cut to ragged
    lengths -- a read with no cells, a read of every PP cells (more than one
    5,120-cell chunk of its sort), cells past the last read that no read
    owns -- with cells at every tile edge of its layout, bit for bit against
    its plain version and a loop over each read's cells in order; two
    launches alike. One tile at B = 19,999 and at the wide classic tree's
    22,199 (4-bit passes), two at 40,000, three at 65,537 (4-bit passes);
    every launch opts in to its block's shared memory (above 48 KB at B =
    1)."""
    layout = plan(B, True, row_ptr=True)
    _csr_layout_holds(layout, B)
    assert layout.n_tiles == {19999: 1, 22199: 1, 40000: 2, 65537: 3}.get(B, 1)
    assert layout.radix_bits == (4 if B in (22199, 65537) else 5)
    assert plan(1, True, row_ptr=True).smem > 48 * 1024
    _csr_case(cuda, R, PP, B, layout)


@pytest.mark.parametrize("edge", ["last-5-bit-tile", "first-4-bit-tile", "last-4-bit-tile",
                                  "first-two-tiles"])
def test_accumulate_sums_csr_layout_edges(cuda, edge, optin=232_448):
    """The row-pointer form on each side of its layout's edges: the widest
    B that one 5-bit block holds, the next B (one 4-bit block), the widest
    B that one 4-bit block holds, and the next (two 5-bit tiles); each bit
    for bit against its plain version, two launches alike."""
    scratch = _csr_scratch()

    def widest(s):  # the widest tile that one block of scratch s holds
        return ((optin - s) // 8 - 4) // 4 * 4

    B = {"last-5-bit-tile": widest(scratch[5]), "first-4-bit-tile": widest(scratch[5]) + 1,
         "last-4-bit-tile": widest(scratch[4]), "first-two-tiles": widest(scratch[4]) + 1}[edge]
    layout = plan(B, True, row_ptr=True)
    _csr_layout_holds(layout, B)
    assert (layout.n_tiles, layout.radix_bits) == {
        "last-5-bit-tile": (1, 5), "first-4-bit-tile": (1, 4), "last-4-bit-tile": (1, 4),
        "first-two-tiles": (2, 5)}[edge]
    _csr_case(cuda, 16, 6000, B, layout)


@pytest.mark.parametrize("route", ["scatter", "pair_fused_tiles", "sharded_scatter"])
def test_new_routes_cuda_match_cpu(cuda, route):
    """``accumulate="scatter"`` (single device, and the hash-sharded CSR on a
    1x1 mesh) and the pair-fused tiles on the card against the same routes
    on the CPU: same edges and counts, scores within f32 rounding of the
    ambiguous first hit's exp. The scatter engine launches the row-pointer
    kernel 4 and the counts finish, never kernel 4's (R, PP) form; the
    pair-fused tiles launch kernel 2 once per clean batch."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.config import PlacerConfig
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db
    from epik_tpu_torch.parallel.mesh import make_mesh
    from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer

    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=71)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 60, length=121, mutation_rate=0.05, seed=72)
    amb = reads[:8] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
                       ("short", b"AC"), ("nohit", b"T" * 30)]
    long_reads = reads_from_reference(ref, 5, length=400, mutation_rate=0.05, seed=76)
    batches = (reads, amb, long_reads)
    if route == "pair_fused_tiles":
        cfg = PlacerConfig(dense_db="off", pair_plane="on")
    else:
        cfg = PlacerConfig(accumulate="scatter", budget_headroom=0.5)
    if route == "sharded_scatter":
        cpu = ShardedTorchPlacer(db, tree, make_mesh(1, 1, devices=[torch.device("cpu")]),
                                 config=cfg)
        gpu = ShardedTorchPlacer(db, tree, make_mesh(1, 1, devices=[cuda]), config=cfg)
    else:
        cpu = TorchPlacer(db, tree, config=cfg, device="cpu")
        gpu = TorchPlacer(db, tree, config=cfg, device=cuda)
    assert gpu.route == cpu.route == ("tiles" if route == "pair_fused_tiles" else "csr")
    reset_launch_counts()
    for batch in batches:
        want, got = cpu.place(batch), gpu.place(batch)
        np.testing.assert_array_equal(got.ids[got.keep], want.ids[want.keep])
        np.testing.assert_array_equal(got.counts[got.keep], want.counts[want.keep])
        np.testing.assert_allclose(got.scores[got.keep], want.scores[want.keep],
                                   rtol=1e-6, atol=1e-6)
    assert gpu.overflow_retries == cpu.overflow_retries
    counts = launch_counts()
    if route == "pair_fused_tiles":
        assert gpu.tiles.paired
        # the clean batch and the split batch's clean reads; IUPAC and 400 bp on CSR
        assert counts["accumulate_packed_topk"] == 2
        assert counts["accumulate_sums_counts"] == 2
    else:
        assert counts["accumulate_sums_counts_csr"] == 3 + gpu.overflow_retries
        assert counts["finish_topk_counts"] == counts["accumulate_sums_counts_csr"]
        assert counts["accumulate_sums_counts"] == counts["accumulate_packed_topk"] == 0


# ---- the gather over a shifted plane's posted cells (rowgather_sum_posted) ---------------


def _posted_plane(cuda, rng, n_rows: int, bw: int, per_row: float, wide_row: int = 0):
    """A shifted f32 plane on the card: ~per_row posted cells a row at
    random columns (values over a wide range of magnitudes, some 1e-37), row
    0 with ``wide_row`` more, the last row all zero; and its posted cells."""
    from epik_tpu_torch.engine.state import build_posted

    n = int(per_row * (n_rows - 1))
    r = torch.from_numpy(rng.integers(0, n_rows - 1, n)).to(cuda)
    c = torch.from_numpy(rng.integers(0, bw, n)).to(cuda)
    v = torch.from_numpy((10.0 ** rng.uniform(-6, 1.5, n)).astype(np.float32)).to(cuda)
    v[::17] = 1e-37
    plane = torch.zeros((n_rows, bw), dtype=torch.float32, device=cuda)
    plane.index_put_((r, c), v)
    if wide_row:
        cols = torch.from_numpy(rng.choice(bw, wide_row, replace=False)).to(cuda)
        vals = rng.uniform(0.1, 3.0, wide_row).astype(np.float32)
        plane[0, cols] = torch.from_numpy(vals).to(cuda)
    return plane, build_posted(plane)


@pytest.mark.parametrize("case,n_rows,bw,R,W,per_row", [
    ("wol10k", 50_001, 21_248, 2000, 141, 12.0),  # the cell's batch and width
    ("config4", 50_001, 20_096, 4096, 143, 12.0),  # config 4's
    ("misses", 5_001, 1_792, 300, 141, 12.0),  # a third of the windows on the zero row
    ("repeats", 5_001, 1_792, 300, 141, 12.0),  # a row named in several windows of a read
    ("short", 5_001, 1_792, 300, 141, 12.0),  # reads shorter than k: every window missed
    ("long", 2_001, 4_096, 9, 2_600, 12.0),  # window tiles and cell tiles past one
    ("wide_row", 2_001, 4_096, 40, 300, 6.0),  # a row of 3,000 cells: a window past a tile
    ("empty", 2_001, 1_792, 0, 141, 12.0),  # no read
])
def test_rowgather_sum_posted_bit_equal_to_1d(cuda, case, n_rows, bw, R, W, per_row):
    """``rowgather_sum_posted`` on the card against ``rowgather_sum`` (1d) on
    the same rows and against the plain version, bit for bit; one launch."""
    rng = np.random.default_rng(n_rows + bw + R)
    plane, p = _posted_plane(cuda, rng, n_rows, bw, per_row,
                             wide_row=3_000 if case == "wide_row" else 0)
    zero = n_rows - 1
    rows = rng.integers(0, n_rows - 1, (R, W)).astype(np.int32)
    if case == "misses":
        rows[rng.random(rows.shape) < 0.33] = zero
    elif case == "repeats":
        rows[:, 5] = rows[:, 2]
        rows[:, 40:60] = rows[:, [1]]
    elif case == "short":
        rows[::4] = zero
    elif case == "wide_row":
        rows[:, ::7] = 0
    rows = torch.from_numpy(rows).to(cuda)
    reset_launch_counts()
    got = rowgather_sum_posted(p.off, p.cells, rows, bw=bw)
    torch.cuda.synchronize()
    assert launch_counts()["rowgather_sum_posted"] == (1 if R else 0)
    assert got.shape == (R, bw) and got.dtype == torch.float32
    want = rowgather_sum(plane, rows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if R * W <= 300 * 141:
        plain = rowgather_sum_posted_plain(p.off.cpu(), p.cells.cpu(), rows.cpu(), bw)
        assert torch.equal(got.cpu().view(torch.int32), plain.view(torch.int32))


def test_rowgather_sum_posted_limit(cuda):
    """The posted gather's shared memory, from the CUDA source: the bw sums,
    1,024 sorted cells, 256 window starts and 257 scan entries; wol10k's and
    config 4's widths fit with 2 blocks an SM, a plane past the limit raises."""
    from epik_tpu_torch.kernels._build import library

    need, limit = posted_smem(21_248, cuda)
    assert need == 21_248 * 4 + 1024 * 8 + 256 * 8 + 257 * 4
    assert posted_fits(21_248, cuda) and posted_fits(20_096, cuda) and posted_fits(40_064, cuda)
    assert library().epik_rowgather_posted_blocks_per_sm(21_248) == 2
    past = (limit // 4 + 128) // 128 * 128
    assert not posted_fits(past, cuda)
    p = _posted_plane(cuda, np.random.default_rng(5), 11, 128, 3.0)[1]
    with pytest.raises(ValueError, match="posted gather takes at most"):
        rowgather_sum_posted(p.off, p.cells, torch.zeros((2, 3), dtype=torch.int32,
                                                         device=cuda), bw=past)


@pytest.mark.parametrize("route", ["posted_fused", "posted"])
@pytest.mark.parametrize("amb", [False, True])
def test_unfused_step_gives_the_same_pack_through_both_gathers(cuda, monkeypatch, amb, route):
    """``engine.step.place_batch_dense_rows`` past the width rule (config 4's
    width) with and without the posted cells: the same slim pack (bit for
    bit but, through the fused posted gather, log_sum within rtol 1e-6); the
    fused posted gather one launch (``posted_fused``) or, past its limit,
    the posted gather and ``finish_topk`` one launch each (``posted``), 1d
    none."""
    from epik_tpu_torch.engine import step as step_mod
    from epik_tpu_torch.engine.step import dense_gather, place_batch_dense_rows

    if route == "posted":
        monkeypatch.setattr(step_mod, "posted_topk_fits", lambda bw, B, device: False)

    rng = np.random.default_rng(23 + amb)
    n_rows, bw, B, R, W = 20_001, 20_096, 19_999, 512, 143
    plane, p = _posted_plane(cuda, rng, n_rows, bw, 12.0)
    rows = torch.from_numpy(rng.integers(0, n_rows, (R, W)).astype(np.int32)).to(cuda)
    arows = torch.full((R, 2), n_rows - 1, dtype=torch.int32, device=cuda)
    if amb:
        arows[3::5, 0] = torch.from_numpy(rng.integers(0, n_rows - 1, arows[3::5].shape[0])
                                          .astype(np.int32)).to(cuda)
    m = torch.full((R,), float(W), device=cuda)
    kw = dict(B=B, K=7, Amax=2 if amb else 0, k=10, zero_row=n_rows - 1, log_eps=-4.2597,
              eps=5.5e-5, shifted=True)
    assert not shifted_fused(bw)
    want = place_batch_dense_rows(plane, rows, arows, m,
                                  gather=dense_gather(plane, B, 7, shifted=True), **kw)
    reset_launch_counts()
    gather = dense_gather(plane, B, 7, shifted=True, posted=p)
    assert gather.note == route
    got = place_batch_dense_rows(plane, rows, arows, m, gather=gather, **kw)
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    if route == "posted":
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert counts == {"rowgather_sum_posted": 1, "finish_topk": 1}
    else:
        _check_pack(got.cpu().numpy(), want.cpu().numpy(), 7, B)
        assert counts == {"rowgather_sum_posted_topk": 1}


# ---- the posted gather with the finish fused in (rowgather_sum_posted_topk) -------------


def _posted_pair(off, cells, rows, m, amb_read, amb_delta, bw: int, B: int, K: int):
    """The pair the fused posted gather stands for: ``rowgather_sum_posted``,
    the delta rows added, ``finish_topk``."""
    Sp = rowgather_sum_posted(off, cells, rows, bw=bw)[:, :B]
    if amb_read is not None:
        Sp[amb_read] = Sp[amb_read] + amb_delta
    return finish_topk(Sp, m, K=K, k=10, log_eps=-4.2597)


def _posted_topk_rows(cuda, rng, case: str, n_rows: int, bw: int, B: int, R: int, W: int):
    """(plane, its posted cells, rows, m) for a fused posted gather case: a
    plane of ~12 posted cells a row among the first B columns; ``short``:
    every fifth read's windows all on the zero row (n = 0); ``few``: every
    fourth read one window, on a row of fewer than K cells (n < K); ``all``:
    row 0 posts every one of the B branches and every third read names it
    (n = B, no untouched branch); ``over``: row 0 posts 5,500 branches, past
    the 5,410 ids of the kernel's touched list at K = 7 (those reads take the
    mask finish, the others the list, in one launch); any other case: as
    drawn."""
    from epik_tpu_torch.engine.state import build_posted

    plane, _ = _posted_plane(cuda, rng, n_rows, bw, 12.0)
    plane[:, B:] = 0.0
    if case in ("all", "over"):
        wide = B if case == "all" else 5_500
        plane[0, :wide] = torch.from_numpy(rng.uniform(0.01, 4.2, wide).astype(np.float32)
                                           ).to(cuda)
    p = build_posted(plane)
    zero = n_rows - 1
    rows = rng.integers(1, n_rows - 1, (R, W)).astype(np.int32)
    if case == "short":
        rows[::5] = zero
    elif case == "few":  # one window on a row of fewer than K cells
        sparse = np.flatnonzero(p.off.diff().cpu().numpy()[1:-1] < 7) + 1
        rows[::4, 0] = rng.choice(sparse, rows[::4].shape[0])
        rows[::4, 1:] = zero
    elif case in ("all", "over"):
        rows[::3, 7] = 0
    m = rng.integers(W, W + 20, R).astype(np.float32)
    m[::7] = 2.0**64  # reads shorter than k: the wrapped window count (quirk Q1)
    return plane, p, torch.from_numpy(rows).to(cuda), torch.from_numpy(m).to(cuda)


@pytest.mark.parametrize("amb", [False, True])
@pytest.mark.parametrize("case,n_rows,bw,B,R,W", [
    ("wol10k", 50_001, 21_248, 21_149, 2000, 141),  # the cell's batch and width
    ("config4", 50_001, 20_096, 19_999, 4096, 143),  # config 4's
    ("wide", 20_001, 40_064, 39_999, 512, 143),  # the wide shifted tree's, 1 block an SM
    ("short", 5_001, 1_792, 1_700, 300, 141),  # n = 0
    ("few", 5_001, 1_792, 1_700, 300, 141),  # n < K: the slots past n
    ("all", 2_001, 21_248, 21_149, 60, 141),  # every branch touched: the whole mask
    ("over", 2_001, 21_248, 21_149, 60, 141),  # past the touched list: the mask finish
    ("empty", 2_001, 1_792, 1_700, 0, 141),  # no read
])
def test_rowgather_sum_posted_topk_matches_the_pair(cuda, case, n_rows, bw, B, R, W, amb):
    """``rowgather_sum_posted_topk`` on the card against the posted gather,
    the delta add and ``finish_topk`` apart: scores, ids, n and zero_sum bit
    for bit, log_sum within rtol 1e-6; with and without delta rows (some
    negative, some touching branches the windows do not); two launches
    alike; one launch; and against the plain version on the small cases."""
    rng = np.random.default_rng(n_rows + bw + R + amb)
    plane, p, rows, m = _posted_topk_rows(cuda, rng, case, n_rows, bw, B, R, W)
    amb_read = amb_delta = None
    if amb and R:
        amb_read = torch.arange(2, R, 6, device=cuda)
        d = rng.uniform(-1.0, 2.5, (amb_read.numel(), B)).astype(np.float32)
        d[d < 1.5] = 0.0
        amb_delta = torch.from_numpy(d).to(cuda)
    args = (p.off, p.cells, rows, m, amb_read, amb_delta)
    kw = dict(bw=bw, B=B, K=7, k=10, log_eps=-4.2597)
    reset_launch_counts()
    got = rowgather_sum_posted_topk(*args, **kw)
    again = rowgather_sum_posted_topk(*args, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["rowgather_sum_posted_topk"] == (2 if R else 0)
    assert got.shape == (R, 17) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = _posted_pair(*args, bw, B, 7)
    _check_pack(got.cpu().numpy(), want.cpu().numpy(), 7, B)
    n = got[:, 15].cpu().numpy()
    if case == "short":
        assert (n == 0).any()
    elif case == "few":
        assert (n < 7).sum() >= R // 8
    elif case == "all":
        assert (n[::3] == B).all()
    elif case == "over":
        assert (n[::3] > 5_410).all() and (n[1::3] <= 5_410).all()
    if R * W <= 300 * 141:
        plain = rowgather_sum_posted_topk_plain(*(a.cpu() if a is not None else None
                                                   for a in args), **kw)
        _check_pack(got.cpu().numpy(), plain.numpy(), 7, B)


def test_rowgather_sum_posted_topk_limit(cuda):
    """The fused posted gather's shared memory, from the CUDA source: the bw
    sums, the B touched bits in whole pairs of words and the gather's staging
    (the finish's candidates and touched list laid over it); 2 blocks an SM
    at the wol10k cell's 21,248 columns, as the posted gather alone; at the
    widest plane ``posted_topk_fits`` takes (B = bw - 64) the pack of the
    pair, one past it refused and raising."""
    from epik_tpu_torch.kernels._build import library

    staging = 1024 * 8 + 256 * 8 + 257 * 4
    need, limit = posted_topk_smem(21_248, 21_149, cuda)
    assert need == 21_248 * 4 + 662 * 4 + staging
    assert posted_topk_smem(65_536, 65_536, cuda)[0] == 65_536 * 4 + 2_048 * 4 + staging
    assert library().epik_rowgather_posted_topk_blocks_per_sm(21_248, 21_149) == 2
    assert posted_topk_fits(21_248, 21_149, cuda) and posted_topk_fits(20_096, 19_999, cuda)
    assert posted_topk_fits(40_064, 39_999, cuda)
    bw = (limit - staging) // 16 * 4
    while posted_topk_fits(bw + 4, bw - 60, cuda):
        bw += 4
    while not posted_topk_fits(bw, bw - 64, cuda):
        bw -= 4
    assert not posted_topk_fits(bw + 4, bw - 60, cuda)
    rng = np.random.default_rng(bw)
    plane, p, rows, m = _posted_topk_rows(cuda, rng, "limit", 2_001, bw, bw - 64, 64, 141)
    kw = dict(bw=bw, B=bw - 64, K=7, k=10, log_eps=-4.2597)
    got = rowgather_sum_posted_topk(p.off, p.cells, rows, m, None, None, **kw)
    want = _posted_pair(p.off, p.cells, rows, m, None, None, bw, bw - 64, 7)
    _check_pack(got.cpu().numpy(), want.cpu().numpy(), 7, bw - 64)
    with pytest.raises(ValueError, match="fused posted gather takes at most"):
        rowgather_sum_posted_topk(p.off, p.cells, rows[:, :3].contiguous(), m, None, None,
                                  **dict(kw, bw=bw + 4, B=bw - 60))

