"""The group layout's shifted form on the CPU (``kernels/rowgather.py``:
``group_smem(..., counts=False)``, ``shifted_group``, ``shifted_fused``).

The shifted steps' fused kernel (#1 and 1a, ``rowgather_sum_topk`` and
``_int16``) and the sharded shifted shards' (1e, ``rowgather_sum_cols``) take
G reads a block (the locality order, or read order on pair rows), their sums
in shared memory. The wrapper chooses G from the width: the largest up to
SHIFTED_GROUP_MAX of whose blocks an SM holds GROUP_MIN_BLOCKS, down to G =
1 at the widest trees, whose block must fit for the kernel to launch at all.
The routers take the fused kernel where the width rule (``shifted_fused``,
the crossover measured on an H100) and the limit both allow it, else its
unfused pair (the gather, the delta add, the finish apart). Here, against an
H100's limit (its 232,448 opt-in bytes a block less the kernel's 384 static
ones): the bytes by hand at D652 and at config 4's width, G at the paths'
widths and where it steps down, the limits and the width rule the routers
keep, and the shifted and sharded shifted placers on both routes, through the
plain versions, against the JAX package and the oracle.
"""

import numpy as np
import pytest
import torch

from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import reads_from_reference, reference_like_db
from epik_tpu.parallel import sharding as jax_sharding
from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh

from epik_tpu_torch.engine import step as step_mod
from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels import rowgather as rg
from epik_tpu_torch.kernels.rowgather import (
    GROUP_BLOCK_RESERVE,
    GROUP_MIN_BLOCKS,
    SHIFTED_COLS_MAX_BW,
    SHIFTED_GROUP_MAX,
    SHIFTED_TOPK_MAX_BW,
    group_smem,
    shifted_fused,
    shifted_group,
)
from epik_tpu_torch.parallel import sharding as sh_mod
from epik_tpu_torch.parallel.mesh import make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from test_torch_placer import assert_jplace_close

#: an H100's opt-in shared memory a block less the group kernel's static bytes
LIMIT = 232_448 - 384


def _fits(G, bw, B, K=7):
    """Whether a shifted block of G reads fits the limit: the kernel launches."""
    return group_smem(G, bw, B, K, counts=False) <= LIMIT


def test_shifted_group_bytes_by_hand():
    """D652's pair rows (bw 1,408, B 1,303, K 7) at G = 8: 8 reads' sums,
    2,048 row ids, 41 mask words, 652 words of 16-bit ids, 8 warps' 7
    candidates of 8 bytes; config 4's width (bw 20,096, B 19,999) at G = 1:
    one read's sums, the row ids, 625 mask words, 10,000 words of ids, the
    candidates. Both against an H100's 232,448 opt-in bytes."""
    words = 8 * 1408 + 2048 + 41 + 652
    assert group_smem(8, 1408, 1303, 7, counts=False) == words * 4 + 8 * 7 * 8 == 56_468
    assert 3 * (56_468 + GROUP_BLOCK_RESERVE) <= 232_448 + GROUP_BLOCK_RESERVE  # 3 an SM
    words = 20096 + 2048 + 625 + 10000
    assert group_smem(1, 20096, 19999, 7, counts=False) == words * 4 + 448 == 131_524
    assert 131_524 <= LIMIT < 2 * 131_524  # one block an SM
    # the counts form keeps its bytes: S and C a read
    assert group_smem(4, 1408, 1303, 7) == group_smem(4, 1408, 1303, 7, counts=True) == 56_468


@pytest.mark.parametrize("what,bw,B,G", [
    ("D652 pair rows and unpaired f32 and int16 (#1, 1a)", 1408, 1303, 8),
    ("D652 sharded 1x1 (1e)", 1408, 1408, 8),
    ("D652 1x2 shard", 768, 768, 8),
    ("D652 1x4 shard", 384, 384, 8),
    ("config 2 codes rows (#1)", 1408, 1303, 8),
    ("G steps down from 8", 1968, 1963, 8),
    ("G = 7", 1976, 1971, 7),
    ("G = 4", 3048, 3043, 4),
    ("G = 2", 4776, 4771, 2),
    ("G = 1", 6656, 6651, 1),
    ("config 4 (#1)", 20096, 19999, 1),
    ("config 4 sharded 1x1 (1e)", 20096, 20096, 1),
    ("the widest tree the kernel takes", 36480, 36472, 1),
])
def test_shifted_group_at_the_paths_widths(what, bw, B, G):
    assert SHIFTED_GROUP_MAX == 8 and GROUP_MIN_BLOCKS == 3
    assert shifted_group(bw, B, 7, LIMIT) == G, what
    assert _fits(G, bw, B)


def test_shifted_group_steps_down_with_the_width():
    """G never grows with the width and takes every value from
    SHIFTED_GROUP_MAX down to 1; every G > 1 fits its blocks an SM (each with
    its reserve) and G + 1 does not, up to SHIFTED_GROUP_MAX."""
    prev, seen = SHIFTED_GROUP_MAX, set()
    for bw in range(128, 40000, 64):
        B = bw - 5
        G = shifted_group(bw, B, 7, LIMIT)
        assert 1 <= G <= prev
        n = [GROUP_MIN_BLOCKS * (group_smem(g, bw, B, 7, False) + GROUP_BLOCK_RESERVE)
             for g in (G, G + 1)]
        assert G == 1 or n[0] <= LIMIT + GROUP_BLOCK_RESERVE
        assert G == SHIFTED_GROUP_MAX or n[1] > LIMIT + GROUP_BLOCK_RESERVE
        prev = G
        seen.add(G)
    assert seen == set(range(1, SHIFTED_GROUP_MAX + 1))


def test_limits_the_routers_keep():
    """The single-device limit is B = 36,472 at bw ~ B (the plane's width B
    rounded up to 128), the sharded one bwl 36,476 (a multiple of 4); the wide
    shifted tree (B 39,999, bw 40,064) lies past it, so its steps run the
    gather and ``finish_topk`` apart whatever the width rule says."""
    def B_at(B):
        return _fits(1, -(-B // 128) * 128, B)

    assert B_at(36472) and not B_at(36473)
    assert _fits(1, 36476, 36476) and not _fits(1, 36480, 36480)
    assert not B_at(39999)


def test_width_rule():
    """The rules are the width alone, one a kernel, at the stated constants:
    the widest widths at which each fused kernel measured no slower than its
    unfused pair through the wrappers on the H100. #1 takes D652's and config
    2's 1,408 columns and 1,664, the pair from 1,792 and config 4's 20,096;
    1e takes D652's 1x4 and 1x2 shards (384, 768 columns) and 1,024, the pair
    from 1,216, D652's 1x1 shard of 1,408 columns (a tie) and config 4's."""
    assert (SHIFTED_TOPK_MAX_BW, SHIFTED_COLS_MAX_BW) == (1664, 1024)
    for cols, top in ((False, SHIFTED_TOPK_MAX_BW), (True, SHIFTED_COLS_MAX_BW)):
        assert shifted_fused(top, cols=cols) and not shifted_fused(top + 4, cols=cols)
    assert all(shifted_fused(bw) for bw in (384, 768, 1408, 1664))
    assert not any(shifted_fused(bw) for bw in (1792, 2816, 20096))
    assert all(shifted_fused(bw, cols=True) for bw in (384, 768, 1024))
    assert not any(shifted_fused(bw, cols=True) for bw in (1216, 1408, 2816, 20096))


def _routes(monkeypatch, module, names):
    """Wrap ``names`` of ``module`` so that each call is counted: a dict of
    name -> calls (the plain versions count no launch)."""
    seen = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def counted(*a, _fn=fn, _n=n, **k):
            seen[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(module, n, counted)
    return seen


@pytest.mark.parametrize("side", ["fused", "pair"])
@pytest.mark.parametrize("int16", [False, True])
def test_router_takes_the_side_of_the_width_rule(monkeypatch, side, int16):
    """``engine.step._shifted_finish`` with the width rule patched to each
    side of a 256-column plane: the fused kernel, or the gather, the delta
    add and ``finish_topk``; the same pack both ways (log_sum within rtol
    1e-6) as the fused plain version."""
    rng = np.random.default_rng(16 + int16)
    bw, B, R, W, n_rows = 256, 250, 40, 30, 60
    plane = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
    plane[rng.random(plane.shape) > 0.3] = 0.0
    plane[:, B:] = 0.0
    plane[-1] = 0.0
    scale = 1.0
    if int16:
        plane = np.round(plane * 1000).astype(np.int16)
        scale = 1000.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    m = rng.integers(W, W + 40, R).astype(np.float32)
    arows = np.full((R, 2), n_rows - 1, np.int32)
    arows[1::4, 0] = rng.integers(0, n_rows - 1, 10)
    plane, rows, m, arows = (torch.from_numpy(x) for x in (plane, rows, m, arows))
    monkeypatch.setattr(rg, "SHIFTED_TOPK_MAX_BW", bw if side == "fused" else bw - 4)
    seen = _routes(monkeypatch, step_mod, ["rowgather_sum_topk", "rowgather_sum_topk_int16",
                                           "rowgather_sum", "finish_topk"])
    kw = dict(B=B, K=7, k=6, log_eps=-4.2597)
    got = step_mod._shifted_finish(plane, rows, m, arows, Amax=2, zero_row=n_rows - 1, eps=5.5e-5,
                                   plane_scale=scale,
                                   gather=step_mod.dense_gather(plane, B, 7, shifted=True), **kw)
    fused = "rowgather_sum_topk_int16" if int16 else "rowgather_sum_topk"
    want_seen = {fused: 1} if side == "fused" else {"rowgather_sum": 1, "finish_topk": 1}
    assert {n: c for n, c in seen.items() if c} == want_seen
    from epik_tpu_torch.ops.dense import amb_deltas
    reads, delta = amb_deltas(plane, arows, zero_row=n_rows - 1, B=B, k=6, eps=5.5e-5,
                              log_eps=-4.2597, plane_scale=scale)
    assert reads.numel() > 0
    want = rg.rowgather_sum_topk_plain(plane, rows, m, reads, delta,
                                       scale=scale if int16 else None, **kw).numpy()
    got = got.numpy()
    K = 7
    np.testing.assert_array_equal(got[:, :2 * K], want[:, :2 * K])
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6)


@pytest.mark.parametrize("side", ["fused", "pair"])
def test_shard_router_takes_the_side_of_the_width_rule(monkeypatch, side):
    """``parallel.sharding._shifted_cols`` with the width rule patched to
    each side of a 256-column shard: the fused column kernel, or the gather,
    the delta add and ``finish_cols_partial``; the same partial pack but e_s
    (rtol 1e-6)."""
    rng = np.random.default_rng(17)
    bw, R, W, n_rows = 256, 40, 30, 60
    plane = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
    plane[rng.random(plane.shape) > 0.3] = 0.0
    plane[-1] = 0.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    m = rng.integers(W, W + 40, R).astype(np.float32)
    reads = np.arange(1, R, 4)
    delta = np.where(rng.random((reads.size, bw)) < 0.2,
                     rng.uniform(-2.0, 6.0, (reads.size, bw)), 0.0).astype(np.float32)
    plane, rows, m, reads, delta = (torch.from_numpy(x) for x in (plane, rows, m, reads, delta))
    monkeypatch.setattr(rg, "SHIFTED_COLS_MAX_BW", bw if side == "fused" else bw - 4)
    seen = _routes(monkeypatch, sh_mod, ["rowgather_sum_cols", "rowgather_sum",
                                         "finish_cols_partial"])
    kw = dict(K=7, k=6, log_eps=-4.2597, col0=2 * bw)
    got = sh_mod._shifted_cols(plane, rows, m, reads, delta, pair_rows=True, **kw).numpy()
    want_seen = ({"rowgather_sum_cols": 1} if side == "fused"
                 else {"rowgather_sum": 1, "finish_cols_partial": 1})
    assert {n: c for n, c in seen.items() if c} == want_seen
    want = rg.rowgather_sum_cols_plain(plane, rows, m, reads, delta, **kw).numpy()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-6)


def _shifted_case(rng, bw, B, R=12, W=20, n_rows=40):
    plane = rng.uniform(0.0, 8.0, (n_rows, bw)).astype(np.float32)
    plane[rng.random(plane.shape) > 0.3] = 0.0
    plane[:, B:] = 0.0
    plane[-1] = 0.0
    rows = rng.integers(0, n_rows, (R, W)).astype(np.int32)
    m = rng.integers(W, W + 40, R).astype(np.float32)
    return (torch.from_numpy(x) for x in (plane, rows, m))


@pytest.mark.parametrize("bw,B,route", [
    (1408, 1303, "fused"),  # D652, config 2
    (1664, 1559, "fused"),
    (1792, 1687, "pair"),
    (20096, 19999, "pair"),  # config 4
])
def test_router_at_the_paths_widths(monkeypatch, bw, B, route):
    """``engine.step._shifted_finish`` with the shipped rule: the fused kernel
    at D652's width and up to 1,664 columns, the unfused pair from 1,792 and
    at config 4's width; the pack the plain fused kernel's either way."""
    plane, rows, m = _shifted_case(np.random.default_rng(bw), bw, B)
    n_rows = plane.shape[0]
    arows = torch.full((rows.shape[0], 1), n_rows - 1, dtype=torch.int32)
    seen = _routes(monkeypatch, step_mod, ["rowgather_sum_topk", "rowgather_sum",
                                           "finish_topk"])
    kw = dict(B=B, K=7, k=6, log_eps=-4.2597)
    got = step_mod._shifted_finish(plane, rows, m, arows, Amax=0, zero_row=n_rows - 1,
                                   eps=5.5e-5, pair_rows=True,
                                   gather=step_mod.dense_gather(plane, B, 7, shifted=True),
                                   **kw).numpy()
    want_seen = ({"rowgather_sum_topk": 1} if route == "fused"
                 else {"rowgather_sum": 1, "finish_topk": 1})
    assert {n: c for n, c in seen.items() if c} == want_seen
    want = rg.rowgather_sum_topk_plain(plane, rows, m, None, None, **kw).numpy()
    np.testing.assert_array_equal(got[:, :14], want[:, :14])
    np.testing.assert_array_equal(got[:, 15:], want[:, 15:])
    np.testing.assert_allclose(got[:, 14], want[:, 14], rtol=1e-6)


@pytest.mark.parametrize("bwl,route", [
    (384, "fused"),  # D652 1x4
    (768, "fused"),  # D652 1x2
    (1024, "fused"),
    (1216, "pair"),
    (1408, "pair"),  # D652 and config 2 on 1x1, D652 on two ranks
    (20096, "pair"),  # config 4 sharded 1x1
])
def test_shard_router_at_the_paths_widths(monkeypatch, bwl, route):
    """``parallel.sharding._shifted_cols`` with the shipped rule: the fused
    column kernel on D652's 1x4 and 1x2 shards and up to 1,024 columns, the
    gather, the delta add and ``finish_cols_partial`` from 1,216, on D652's
    1x1 shard and at config 4's width; the partial pack the plain fused
    kernel's but e_s (rtol 1e-6) either way."""
    plane, rows, m = _shifted_case(np.random.default_rng(bwl), bwl, bwl)
    seen = _routes(monkeypatch, sh_mod, ["rowgather_sum_cols", "rowgather_sum",
                                         "finish_cols_partial"])
    kw = dict(K=7, k=6, log_eps=-4.2597, col0=bwl)
    got = sh_mod._shifted_cols(plane, rows, m, None, None, pair_rows=True, **kw).numpy()
    want_seen = ({"rowgather_sum_cols": 1} if route == "fused"
                 else {"rowgather_sum": 1, "finish_cols_partial": 1})
    assert {n: c for n, c in seen.items() if c} == want_seen
    want = rg.rowgather_sum_cols_plain(plane, rows, m, None, None, **kw).numpy()
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=1e-6)


@pytest.fixture(scope="module")
def fx():
    db, ref = reference_like_db(num_leaves=24, kmer_size=6, ref_length=8_000,
                                mean_posting_len=6.0, seed=63)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 50, length=80, mutation_rate=0.05, seed=64)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
              ("amb2", b"R" + reads[1][1][1:50] + b"Y" + reads[1][1][51:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    return db, tree, reads, ReferencePlacer(db, tree).place(reads)


def _side(monkeypatch, side):
    """Patch the width rules to ``side`` for every width of the fixtures."""
    top = 1 << 20 if side == "fused" else 0
    monkeypatch.setattr(rg, "SHIFTED_TOPK_MAX_BW", top)
    monkeypatch.setattr(rg, "SHIFTED_COLS_MAX_BW", top)


@pytest.mark.parametrize("side", ["fused", "pair"])
@pytest.mark.parametrize("cfg", [{}, {"pair_plane": "off"}, {"precision": "int16"}])
def test_shifted_placer_matches_jax(monkeypatch, fx, cfg, side):
    """The shifted steps (pair plane, unpaired, int16) on either side of the
    width rule, through the plain versions on the CPU, against
    ``JaxPlacer`` under the same config (score sets within 1e-4) and the
    oracle (int16, a lossy plane, by the whole jplace_diff rule)."""
    db, tree, reads, oracle = fx
    _side(monkeypatch, side)
    port = TorchPlacer(db, tree, config=PlacerConfig(**cfg), device="cpu")
    assert port._shifted and port.route == "dense"
    assert port._paired == ("pair_plane" not in cfg and "precision" not in cfg)
    seen = _routes(monkeypatch, step_mod, ["rowgather_sum_topk", "rowgather_sum_topk_int16",
                                           "rowgather_sum", "finish_topk"])
    reset_launch_counts()
    out = port.place(reads)
    assert not any(launch_counts().values())
    fused = seen["rowgather_sum_topk"] + seen["rowgather_sum_topk_int16"]
    assert (fused > 0, seen["rowgather_sum"] > 0) == (side == "fused", side == "pair"), seen
    assert_jplace_close(JaxPlacer(db, tree, config=JaxConfig(**cfg)).place(reads), out)
    assert_jplace_close(oracle, out, per_edge="precision" in cfg)


@pytest.mark.parametrize("side", ["fused", "pair"])
@pytest.mark.parametrize("n_model", [1, 4])
def test_sharded_shifted_placer_matches_jax(monkeypatch, fx, n_model, side):
    """The sharded shifted shards (1e's plain version, or its unfused pair)
    on a 1x1 and a 1x4 mesh against ``ShardedJaxPlacer`` on the same mesh and
    the oracle."""
    db, tree, reads, oracle = fx
    _side(monkeypatch, side)
    port = ShardedTorchPlacer(db, tree, make_mesh(1, n_model, devices=[torch.device("cpu")] * 8))
    jp = jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(1, n_model))
    assert port.route == "dense" and port._shifted
    seen = _routes(monkeypatch, sh_mod, ["rowgather_sum_cols", "rowgather_sum",
                                         "finish_cols_partial"])
    reset_launch_counts()
    out = port.place(reads)
    assert not any(launch_counts().values())
    assert (seen["rowgather_sum_cols"] > 0, seen["rowgather_sum"] > 0) == (
        side == "fused", side == "pair"), seen
    assert_jplace_close(oracle, out)
    assert_jplace_close(jp.place(reads), out)
    assert np.isfinite([p.score for q in out.placed_seqs for p in q.placements]).all()
