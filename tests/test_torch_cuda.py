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
    accumulate_sums_plain,
    plan,
)
from epik_tpu_torch.kernels.finish import finish_topk, finish_topk_plain
from epik_tpu_torch.kernels.rowgather import (
    rowgather_sum,
    rowgather_sum_counts,
    rowgather_sum_counts_bf16,
    rowgather_sum_counts_plain,
    rowgather_sum_plain,
    rowgather_sum_topk,
    rowgather_sum_topk_int16,
    rowgather_sum_topk_plain,
    topk_fits,
    topk_smem,
)
from torch_fixtures import (
    cell_order_sums,
    finish_rows,
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
                                      (8, 13000, 32767, 7), (8, 32800, 32767, 64)])
def test_accumulate_packed_topk_engineered(cuda, R, PP, B, K):
    """Kernel 2 on the engineered rows (n = 0, n < K, every cell on its own
    branch, exact ties across the K cut, Q3, a Q1 m = 2**64, PP >= B with
    every branch touched): sums and the whole pack bit-equal but log_sum
    (rtol 1e-6), two launches alike. The widest B the packed cells allow,
    with PP past 13,000 and past B, bounds the block's shared memory."""
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
])
def test_accumulate_sums_bit_equal(cuda, R, PP, B, engineered):
    """Kernel 4, with counts and without, bit for bit against its plain
    version (and, on the engineered rows, against a loop over each row's
    cells in order); two launches give the same bytes."""
    rng = np.random.default_rng(R * PP)
    if engineered:
        layouts = plan(B, True), plan(B, False)
        # with counts, B = 40,000 takes the path past one tile
        assert layouts[0].n_tiles == (2 if B == 40000 else 1)
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
    (2000, 1408, 1303, 300, 72),  # D652's widths
    (64, 128, 40, 50, 9),
    (300, 4608, 4500, 24, 17),  # bw/4 > 1024: threads loop over column chunks
    (40, 128, 100, 3, 2500),  # W > one shared-memory tile of row offsets
])
@pytest.mark.parametrize("amb", [False, True])
def test_rowgather_sum_topk_bit_equal(cuda, n_rows, bw, B, R, W, amb):
    """Kernel 1 with the finish fused in against its plain version: the
    whole pack bit-equal but log_sum (rtol 1e-6), with and without delta
    rows; two launches alike."""
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
    got = rowgather_sum_topk(plane, rows, m, reads, delta, **kw)
    assert torch.equal(rowgather_sum_topk(plane, rows, m, reads, delta, **kw), got)
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
    rowgather_sum_topk(plane, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0)
    rowgather_sum_topk_int16(plane_q, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0,
                             scale=2.0)
    rowgather_sum_counts(plane, rows)
    rowgather_sum_counts_bf16(plane.to(torch.bfloat16), rows)
    finish_topk(Sp, m, K=3, k=4, log_eps=-1.0)
    accumulate_packed_topk(p, m, B=100, K=3, k=4, log_eps=-1.0, scale=2.0)
    accumulate_packed_sums(p, B=100)
    accumulate_sums(b, s, B=100)
    accumulate_sums_counts(b, s, B=100)
    # the plain versions never count
    rowgather_sum_plain(plane, rows)
    rowgather_sum_topk_plain(plane, rows, m, None, None, B=100, K=3, k=4, log_eps=-1.0)
    rowgather_sum_counts_plain(plane, rows)
    accumulate_packed_topk_plain(p, m, B=100, K=3, k=4, log_eps=-1.0, scale=2.0)
    accumulate_sums_plain(b, s, B=100, counts=True)
    packed_sums_plain(p, 100)
    assert launch_counts() == {"rowgather_sum": 1, "rowgather_sum_topk": 1,
                               "rowgather_sum_topk_int16": 1, "rowgather_sum_counts": 1,
                               "rowgather_sum_counts_bf16": 1, "finish_topk": 1,
                               "accumulate_packed_topk": 1, "accumulate_packed_sums": 1,
                               "accumulate_sums": 1, "accumulate_sums_counts": 1}


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
    from epik_tpu_torch.engine.step import _shifted_finish

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
    got = _shifted_finish(t[0], t[1], t[2], arows_t, Amax=2, zero_row=119, eps=5.5e-5, **kw)
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
    (300, 4608, 4500, 24, 17),  # more than 1,024 column groups
    (40, 128, 100, 3, 2500),  # W > one shared-memory tile of row offsets
])
def test_int16_variants_bit_equal(cuda, n_rows, bw, B, R, W):
    """Kernel 1 over an int16 plane: the dequantized sums and the fused pack
    bit-equal to their plain versions (exact int32 sums, one correctly
    rounded divide), with delta rows, two launches alike."""
    rng = np.random.default_rng(n_rows * 3 + W)
    q = rng.integers(1, 32001, (n_rows, bw)).astype(np.int16)
    q[rng.random((n_rows, bw)) > 0.3] = 0
    q[:, B:] = 0
    q[-1] = 0
    plane = torch.from_numpy(q).to(cuda)
    _, rows, m, reads, delta = _dense_case(rng, n_rows, bw, B, R, W, True)
    rows, m, reads, delta = (torch.from_numpy(x).to(cuda) for x in (rows, m, reads, delta))
    scale = 32000.0 / 4.2597
    sums = rowgather_sum(plane, rows, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(sums, rowgather_sum_plain(plane, rows, scale))
    K = min(7, B)
    kw = dict(B=B, K=K, k=10, log_eps=-4.2597, scale=scale)
    got = rowgather_sum_topk_int16(plane, rows, m, reads, delta, **kw)
    assert torch.equal(rowgather_sum_topk_int16(plane, rows, m, reads, delta, **kw), got)
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
              else "rowgather_sum_counts_bf16" if config.get("precision") == "bf16"
              else "rowgather_sum_counts")
    assert counts[kernel] > 0, counts
