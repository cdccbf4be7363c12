"""The group layout of the fused counts kernels on the CPU
(``kernels/rowgather.py``: ``group_smem``, ``counts_group``).

The classic steps' fused kernel (1b, ``rowgather_sum_counts_topk`` and
``_bf16``) and the sharded classic shards' (1f, ``rowgather_sum_counts_cols``)
take G reads of the locality order a block, their sums and counts in shared
memory. The wrapper chooses G from the width: the largest up to GROUP_MAX of
whose blocks an SM holds GROUP_MIN_BLOCKS, down to G = 1 at the widest trees,
whose block must fit for the kernel to launch at all. Here, against an H100's
limit (its 232,448 opt-in bytes a block less the kernel's 384 static ones):
the bytes by hand at D652, G at the paths' widths and where it steps down,
the limits the routers keep (B = 22,016 at bw ~ B, bwl 22,064; the wide
classic tree's B = 22,199 past them), and the classic and sharded classic
placers, through the plain versions, against the JAX package and the oracle.
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

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.rowgather import (
    GROUP_BLOCK_RESERVE,
    GROUP_MAX,
    GROUP_MIN_BLOCKS,
    counts_group,
    group_smem,
)
from epik_tpu_torch.parallel.mesh import make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from test_torch_placer import assert_jplace_close

#: an H100's opt-in shared memory a block less the group kernel's static bytes
LIMIT = 232_448 - 384


def _fits(G, bw, B, K=7):
    """Whether a block of one read (G = 1) fits the limit: the kernel launches."""
    return group_smem(G, bw, B, K) <= LIMIT


def test_group_bytes_by_hand():
    """D652's classic widths (bw 1,408, B 1,303, K 7) at G = 4: 4 reads'
    sums and counts, 2,048 row ids, 41 mask words, 652 words of 16-bit ids,
    8 warps' 7 candidates of 8 bytes."""
    words = 2 * 4 * 1408 + 2048 + 41 + 652
    assert group_smem(4, 1408, 1303, 7) == words * 4 + 8 * 7 * 8 == 56_468
    assert group_smem(1, 22016, 22016, 7) == 231_552  # the widest tree a block takes


@pytest.mark.parametrize("what,bw,B,G", [
    ("D652 classic (1b)", 1408, 1303, 4),
    ("D652 sharded classic 1x1 (1f)", 1408, 1408, 4),
    ("D652 sharded classic 1x4 shard (1f)", 384, 384, 4),
    ("G steps down from 4", 1968, 1963, 4),
    ("G = 3", 1976, 1971, 3),
    ("G = 2", 3712, 3707, 2),
    ("G = 1", 3720, 3715, 1),
    ("config 4 classic", 20096, 19999, 1),
    ("the widest tree the kernel takes", 22016, 22016, 1),
])
def test_group_size_at_the_paths_widths(what, bw, B, G):
    assert GROUP_MAX == 4 and GROUP_MIN_BLOCKS == 3
    assert counts_group(bw, B, 7, LIMIT) == G, what
    assert _fits(G, bw, B)


def test_group_size_steps_down_with_the_width():
    """G never grows with the width; every G > 1 fits its blocks an SM (each
    with its reserve) and G + 1 does not, up to GROUP_MAX."""
    prev = GROUP_MAX
    for bw in range(128, 24000, 64):
        B = bw - 5
        G = counts_group(bw, B, 7, LIMIT)
        assert 1 <= G <= prev
        n = [GROUP_MIN_BLOCKS * (group_smem(g, bw, B, 7) + GROUP_BLOCK_RESERVE)
             for g in (G, G + 1)]
        assert G == 1 or n[0] <= LIMIT + GROUP_BLOCK_RESERVE
        assert G == GROUP_MAX or n[1] > LIMIT + GROUP_BLOCK_RESERVE
        prev = G
    assert prev == 1


def test_limits_the_routers_keep():
    """The single-device limit stays B = 22,016 at bw ~ B (the plane's width
    B rounded up to 128), the sharded one bwl 22,064; the wide classic tree
    (B 22,199, bw 22,272) lies past both."""
    def B_at(B):
        return _fits(1, -(-B // 128) * 128, B)

    assert B_at(22016) and not B_at(22017)
    assert _fits(1, 22064, 22064) and not _fits(1, 22068, 22068)
    assert not B_at(22199) and not _fits(1, 22272, 22272)


@pytest.fixture(scope="module")
def fx():
    db, ref = reference_like_db(num_leaves=24, kmer_size=6, ref_length=8_000,
                                mean_posting_len=6.0, seed=61)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 50, length=80, mutation_rate=0.05, seed=62)
    reads += [("amb", reads[0][1][:30] + b"N" + reads[0][1][31:]),
              ("amb2", b"R" + reads[1][1][1:50] + b"Y" + reads[1][1][51:]),
              ("short", b"AC"), ("nohit", b"T" * 30)]
    return db, tree, reads, ReferencePlacer(db, tree).place(reads)


@pytest.mark.parametrize("cfg", [dict(plane_mode="classic"), dict(lookup_where="device")])
def test_classic_placer_matches_jax(fx, cfg):
    """The classic steps (the fused counts kernel's plain version on the CPU)
    against ``JaxPlacer`` under the same config and the oracle."""
    db, tree, reads, oracle = fx
    port = TorchPlacer(db, tree, config=PlacerConfig(**cfg), device="cpu")
    assert not port._shifted
    reset_launch_counts()
    out = port.place(reads)
    assert not any(launch_counts().values())
    assert_jplace_close(oracle, out)
    assert_jplace_close(JaxPlacer(db, tree, config=JaxConfig(**cfg)).place(reads), out)


@pytest.mark.parametrize("n_model", [1, 2])
def test_sharded_classic_placer_matches_jax(fx, n_model):
    """The sharded classic shards (1f's plain version on the CPU) against
    ``ShardedJaxPlacer`` on the same mesh and the oracle."""
    db, tree, reads, oracle = fx
    port = ShardedTorchPlacer(db, tree, make_mesh(1, n_model, devices=[torch.device("cpu")] * 8),
                              config=PlacerConfig(plane_mode="classic"))
    jp = jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(1, n_model),
                                       config=JaxConfig(plane_mode="classic"))
    assert port.route == "dense" and not port._shifted
    reset_launch_counts()
    out = port.place(reads)
    assert not any(launch_counts().values())
    assert_jplace_close(oracle, out)
    assert_jplace_close(jp.place(reads), out)
    assert np.isfinite([p.score for q in out.placed_seqs for p in q.placements]).all()
