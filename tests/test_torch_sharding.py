"""The column-sharded big-tree path of the port on the CPU, held to the JAX package.

* Kernel 3's sums (``accumulate_packed_sums``): its plain version bit-equal to
  the Pallas kernel ``segment_accumulate_packed`` in interpret mode.
* The mesh over repeated CPU devices (the analog of the conftest's virtual
  8-CPU JAX mesh).
* Database partitioning: ``shard_tiles_columns`` and ``shard_db_by_hash``
  array for array against the JAX package's.
* The tile step, both payloads, against ``_sharded_tiles_bytes_step``
  (interpret mode) on the same inputs: scores and log_sum within rtol 1e-6;
  n, zero_sum and the overflow-window counts equal; live top-K indices equal
  wherever the scores are not tied.
* ``ShardedTorchPlacer`` on meshes 1x1 to 4x2 against ``ShardedJaxPlacer(
  accumulate="matmul", dense_db="off")`` and the scalar oracle, score sets
  within 1e-4 (``tools/jplace_diff.py`` semantics), through the cases of
  ``tests/test_sharding.py``; ``dense_db`` "auto" and "on" on the dense route
  (``tests/test_torch_sharded_dense.py`` holds that route in full).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.core.alphabet import DNA
from epik_tpu.core.tree import parse_newick, to_newick
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db, reads_from_reference, reference_like_db
from epik_tpu.io.db import PhyloKmerDB
from epik_tpu.io.jplace import jplace_writer as jax_jplace_writer
from epik_tpu.ops.pallas.accumulate import segment_accumulate_packed
from epik_tpu.parallel import sharding as jax_sharding
from epik_tpu.parallel.mesh import make_mesh as jax_make_mesh

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.pipeline import run_pipeline
from epik_tpu_torch.engine.staging import pack_reads
from epik_tpu_torch.io.jplace import jplace_writer
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.accumulate_packed import accumulate_packed_sums, packed_sums_plain
from epik_tpu_torch.parallel import sharding
from epik_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from epik_tpu_torch.parallel.sharding import ShardedTorchPlacer
from epik_tpu_torch.tools.jplace_diff import jplace_diff
from test_pipeline import _ListReader
from test_torch_placer import assert_jplace_close
from torch_fixtures import packed_cells

CPU8 = [torch.device("cpu")] * 8
MESHES = [(1, 1), (1, 2), (2, 2), (4, 2)]


def _port(db, tree, n_data, n_model, **kw):
    return ShardedTorchPlacer(db, tree, make_mesh(n_data, n_model, devices=CPU8),
                              config=PlacerConfig(dense_db="off", **kw))


def _jax(db, tree, n_data, n_model):
    return jax_sharding.ShardedJaxPlacer(
        db, tree, jax_make_mesh(n_data, n_model),
        config=JaxConfig(dense_db="off", accumulate="matmul"))


def _both_close(db, tree, reads, out, jax_p):
    """The port against the oracle and the JAX placer, 1e-4 on score sets."""
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    assert_jplace_close(jax_p.place(reads), out)


@pytest.fixture(scope="module")
def fx():
    """``TestShardedPairPlane._fixture``: 48 leaves, k=8, mean 6 postings per
    key (the two-level split engages), 101 bp reads, short and no-hit."""
    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=61)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 40, length=101, mutation_rate=0.05, seed=62)
    reads += [("short", b"AC"), ("nohit", b"T" * 30)]
    return db, ref, tree, reads


# ---- kernel 3's sums --------------------------------------------------------------


@pytest.mark.parametrize("B", [300, 1000])
def test_packed_sums_plain_matches_pallas(B):
    rng = np.random.default_rng(B)
    p, _ = packed_cells(rng, 16, 1024, B)
    p_t = torch.from_numpy(p)
    reset_launch_counts()
    mine = accumulate_packed_sums(p_t, B=B)
    assert not any(launch_counts().values())  # the plain version never counts
    assert mine.dtype == torch.float32 and mine.shape == (16, B)
    assert torch.equal(mine, packed_sums_plain(p_t, B).to(torch.float32))
    want = np.asarray(segment_accumulate_packed(jnp.asarray(p), B, interpret=True))
    np.testing.assert_array_equal(mine.numpy(), want)
    assert mine[3, 5] >= 64 * 64000  # one branch hit by 64 cells of the row (at least)


def test_packed_sums_wrapper_checks_inputs():
    p = torch.zeros((4, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*15"):
        accumulate_packed_sums(p, B=40000)
    with pytest.raises(ValueError):
        accumulate_packed_sums(p.long(), B=300)
    with pytest.raises(ValueError):
        accumulate_packed_sums(p[:, ::2], B=300)


# ---- the mesh -----------------------------------------------------------------------


def test_mesh_over_repeated_devices():
    mesh = make_mesh(n_data=2, n_model=4, devices=CPU8)
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 4}
    assert mesh.devices == ((torch.device("cpu"),) * 4,) * 2
    assert make_mesh(n_model=2, devices=CPU8).shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    with pytest.raises(ValueError):
        make_mesh(n_data=3, n_model=3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(n_model=3, devices=CPU8)


def test_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


# ---- database partitioning ----------------------------------------------------------


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_shard_tiles_columns_matches_jax(fx, n_model):
    db, _, tree, _ = fx
    B = tree.get_node_count()
    log_eps = -4.1
    mine = sharding.shard_tiles_columns(db, n_model, B, log_eps)
    want = jax_sharding.shard_tiles_columns(db, n_model, B, log_eps)
    assert len(mine) == len(want) == 9
    for a, b in zip(mine, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert mine[5] > 0  # the two-level split engages on this fixture


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_shard_db_by_hash_matches_jax(fx, n_model):
    db = fx[0]
    mine = sharding.shard_db_by_hash(db, n_model)
    want = jax_sharding.shard_db_by_hash(db, n_model)
    for name in ("packed", "postings", "row_off"):
        a, b = getattr(mine, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.seeds == want.seeds and mine.avg_plen == want.avg_plen
    assert np.array_equal(sharding._shard_of_key(db.keys, n_model),
                          jax_sharding._shard_of_key(db.keys, n_model))


# ---- the tile step --------------------------------------------------------------------


def _check_pack(got, want, K, atol=0.0):
    """Scores and log_sum within rtol 1e-6 (plus ``atol``); n, zero_sum and
    any columns past the pack (the overflow-window counts) equal; live top-K
    indices equal wherever a score is not tied with another of the row's top
    K."""
    assert got.shape == want.shape
    n = want[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(got[:, 2 * K + 1:], want[:, 2 * K + 1:])
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    assert live.any()
    np.testing.assert_allclose(got[:, :K][live], want[:, :K][live], rtol=1e-6, atol=atol)
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-6, atol=atol)
    s = want[:, :K]
    close = np.abs(s[:, :, None] - s[:, None, :]) <= 1e-6 * np.abs(s[:, :, None])
    tied = (close & live[:, None, :]).sum(axis=2) > 1
    untied = live & ~tied
    assert untied.any()
    np.testing.assert_array_equal(got[:, K:2 * K][untied], want[:, K:2 * K][untied])


def _rows_by_group(arr, n_data, n_model):
    """JAX arrays stacked over the model axis -> per-shard CPU tensors."""
    a = np.asarray(arr)
    return [[torch.from_numpy(np.ascontiguousarray(a[m]).view(np.int32))
             for m in range(n_model)] for _ in range(n_data)]


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 2), (1, 4)])
def test_tiles_step_packed_matches_jax(fx, n_data, n_model):
    """The packed tile step on the JAX placer's own tiles and staged batch."""
    db, _, tree, reads = fx
    jp = _jax(db, tree, n_data, n_model)
    assert jp._tiles_mode and jp._tile_pt_ov > 0
    seqs = list(dict.fromkeys(s for _, s in reads))
    pending = jp._place_async_tiles({s: ["x"] for s in seqs}, seqs)
    _, OV, fn_ov, arrays = pending.budgets
    want = np.asarray(fn_ov(OV)(*arrays))
    kw = fn_ov(OV).keywords
    R = kw["R"]
    tiles = _rows_by_group(arrays[0], n_data, n_model)
    tiles_ov = _rows_by_group(arrays[3], n_data, n_model)
    direct = torch.from_numpy(np.array(arrays[1]))
    buf = torch.from_numpy(np.array(arrays[2]))
    step_kw = {name: kw[name] for name in ("B", "bwl", "K", "k", "Lmax", "num_kmers", "PT",
                                           "log_eps", "tile_scale", "PT_OV", "OV", "N_OV")}
    got = np.stack([sharding.sharded_tiles_bytes_step(
        tiles[d], [direct] * n_model, buf[d * R:(d + 1) * R], tiles_ov[d], **step_kw).numpy()
        for d in range(n_data)])
    assert got.shape == want.shape == (n_data, R, 2 * kw["K"] + 4)
    assert want[..., -1].max() > 0  # windows with overflow postings
    _check_pack(got.reshape(n_data * R, -1), want.reshape(n_data * R, -1), kw["K"])


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 2), (1, 4)])
def test_tiles_step_f32_matches_jax(n_data, n_model):
    """The f32-payload tile step (kernel 4) on hand-built f32 tiles: random
    local branches and shifted scores, trash cells, a miss row."""
    rng = np.random.default_rng(10 * n_data + n_model)
    k, n_keys, PT, B, K = 6, 300, 8, 400, 7
    bwl = -(-B // (128 * n_model)) * 128
    trash = -(-(bwl + 1) // 128) * 128 - 1
    tiles = np.empty((n_model, n_keys + 1, 2 * PT), np.uint32)
    tiles[:, :, 0::2] = rng.integers(0, bwl, (n_model, n_keys + 1, PT))
    tiles[:, :, 1::2] = rng.uniform(0.01, 4.0, (n_model, n_keys + 1, PT)).astype(
        np.float32).view(np.uint32)
    pad = rng.random((n_model, n_keys + 1, PT)) > 0.6
    pad[:, n_keys] = True  # the miss row
    tiles[:, :, 0::2][pad] = trash
    tiles[:, :, 1::2][pad] = 0
    direct = rng.integers(0, n_keys + 1, 4**k).astype(np.int32)
    R_true, Lmax = 50, 40
    R = -(-(-(-R_true // n_data)) // 64) * 64  # reads per data group, as the placer pads
    codes = np.full((n_data * R, Lmax), 0xFF, np.uint8)
    lens = np.zeros(n_data * R, np.int64)
    lens[:R_true] = rng.integers(k, Lmax + 1, R_true)
    for i in range(R_true):
        codes[i, :lens[i]] = rng.integers(0, 4, lens[i])
    buf = pack_reads(codes, lens)
    kw = dict(B=B, bwl=bwl, K=K, k=k, Lmax=Lmax, num_kmers=n_keys, PT=PT, log_eps=-3.0)
    want = np.asarray(jax_sharding._sharded_tiles_bytes_step(
        tiles, direct, buf, mesh=jax_make_mesh(n_data, n_model), R=R, eps=1e-3,
        interpret=True, **kw))
    til = [torch.from_numpy(tiles[m].view(np.int32)) for m in range(n_model)]
    got = np.stack([sharding.sharded_tiles_bytes_step(
        til, [torch.from_numpy(direct)] * n_model,
        torch.from_numpy(buf[d * R:(d + 1) * R]), **kw).numpy() for d in range(n_data)])
    assert got.shape == want.shape == (n_data, R, 2 * K + 3)
    # f32 sums taken in another order than the Pallas kernel's: a few ulp of
    # the summed terms (~10), which log_sum = max + log10(sum) keeps in
    # absolute terms where it cancels to near 0
    _check_pack(got.reshape(n_data * R, -1), want.reshape(n_data * R, -1), K, atol=1e-6)


# ---- the placer -------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_sharded_tiles_matches_oracle(fx, n_data, n_model):
    """``test_sharding.py::test_sharded_tiles_matches_oracle``: the two-level
    split engages, and an ambiguous batch goes to the hash-sharded CSR whole."""
    db, _, tree, reads = fx
    port = _port(db, tree, n_data, n_model)
    assert port.route == "tiles" and port._tile_pt_ov > 0 and port._tile_n_ov > 0
    jax_p = _jax(db, tree, n_data, n_model)
    reset_launch_counts()
    _both_close(db, tree, reads, port.place(reads), jax_p)
    amb = reads[:6] + [("amb2", reads[0][1][:30] + b"N" + reads[0][1][31:])]
    pending = port.place_async(amb)
    assert pending.budget[0] == "csr" and pending.budget[2] > 0  # host-staged streams
    _both_close(db, tree, amb, port.place_wait(pending), jax_p)
    assert not any(launch_counts().values())  # the CPU runs the plain versions


def test_sharded_pipeline_matches_jax(fx, tmp_path):
    """run_pipeline over a 2x2 mesh with the port's reader-facing surface and
    jplace writer; ``tools/jplace_diff`` finds it equal to the JAX sharded
    placer's file at 1e-4, both ways."""
    db, _, tree, reads = fx
    reads = reads + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:])]
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


def test_hot_shard_overflow_retry():
    """``test_sharding.py::test_hot_shard_overflow_retry``: one 150-posting
    list on one hash shard overflows the uniform per-shard budget; both CSR
    stagings (the bytes step, and the host-staged streams that an IUPAC read
    selects) retry and match."""
    n_model = 4
    base = random_db(num_leaves=80, kmer_size=6, num_kmers=64, seed=77)
    rng = np.random.default_rng(78)
    B = parse_newick(base.tree()).get_node_count()
    keys = base.keys
    shard = jax_sharding._shard_of_key(keys, n_model)
    hot = np.zeros(keys.shape[0], bool)
    hot[int(np.flatnonzero(shard == 0)[0])] = True
    lens = np.where(hot, min(B, 150), 1).astype(np.int64)
    row_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(row_off[-1])
    branches = np.concatenate([rng.permutation(B)[:n].astype(np.uint32) for n in lens])
    db = PhyloKmerDB(sequence_type="nucl", kmer_size=6, omega=base.omega,
                     tree_newick=base.tree_newick, keys=keys, row_off=row_off,
                     branches=branches,
                     scores=rng.uniform(-3.5, -0.5, size=total).astype(np.float32),
                     version=base.version, num_entries_total=total,
                     num_entries_loaded=total)
    db.validate()
    hot_keys = keys[hot]
    recs = []
    for i in range(12):
        parts = [DNA.decode_key(int(hot_keys[rng.integers(hot_keys.shape[0])]), 6)
                 for _ in range(4)]
        parts.append(DNA.decode_key(i, 6))
        recs.append((f"hot{i}", "".join(parts).encode()))
    tree = parse_newick(db.tree())
    jax_p = _jax(db, tree, 2, n_model)
    for batch in (recs, recs + [("amb", recs[0][1][:3] + b"N" + recs[0][1][4:])]):
        port = _port(db, tree, 2, n_model)
        assert port.route == "csr"  # a posting list past 128: no tiles
        _both_close(db, tree, batch, port.place(batch), jax_p)
        assert port.overflow_retries > 0


def test_two_level_overflow_retry():
    """A read whose windows hit overflow keys far beyond the static OV
    budget is re-dispatched with a bigger budget and still matches."""
    rng = np.random.default_rng(201)
    k = 6
    hot = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
    entries = {}
    for w in range(len(hot) - k + 1):
        entries.setdefault(hot[w:w + k], [
            (int(b), float(s)) for b, s in zip(rng.permutation(60)[:17],
                                               rng.uniform(-2.4, -0.5, 17))])
    filler = set()
    while len(filler) < 2000:
        filler.add(DNA.decode_key(int(rng.integers(0, 4**k)), k))
    for f in filler:
        if f not in entries:
            entries[f] = [(int(rng.integers(0, 60)), -1.0)]
    nwk = "(" + ",".join(f"L{i}:0.1" for i in range(60)) + ");"
    db = build_db(entries, nwk, kmer_size=k)
    tree = parse_newick(db.tree())
    reads = [("hot", hot.encode()), ("cold", DNA.decode_key(3, k).encode() * 10)]
    port = _port(db, tree, 1, 2)
    assert port.route == "tiles" and port._tile_pt_ov > 0
    _both_close(db, tree, reads, port.place(reads), _jax(db, tree, 1, 2))
    assert port.overflow_retries > 0


def test_fewer_reads_than_shards(fx):
    db, _, tree, _ = fx
    recs = [("only", b"ACGTAC" * 4)]
    _both_close(db, tree, recs, _port(db, tree, 4, 2).place(recs), _jax(db, tree, 4, 2))


def test_reads_shorter_than_k_take_csr(fx):
    """A batch in which no read has k characters: the host-staged CSR step."""
    db, _, tree, _ = fx
    recs = [("s1", b"AC"), ("s2", b"ACGTA"), ("s3", b"T")]
    port = _port(db, tree, 2, 2)
    pending = port.place_async(recs)
    assert pending.budget[0] == "csr"
    _both_close(db, tree, recs, port.place_wait(pending), _jax(db, tree, 2, 2))


def test_long_reads_leave_packed_tiles(fx):
    """400 bp reads break the packed exactness gate: the batch takes the CSR
    bytes step whole."""
    db, ref, tree, _ = fx
    long_reads = reads_from_reference(ref, 6, length=400, mutation_rate=0.05, seed=76)
    port = _port(db, tree, 1, 2)
    seqs = [s for _, s in long_reads]
    assert port._prepare_tiles({}, seqs) is None
    pending = port.place_async(long_reads)
    assert pending.budget[0] == "csr" and pending.budget[2] == 0  # the bytes step
    _both_close(db, tree, long_reads, port.place_wait(pending), _jax(db, tree, 1, 2))


def test_empty_batch(fx):
    db, _, tree, _ = fx
    assert _port(db, tree, 1, 2).place([]).placed_seqs == []


@pytest.mark.parametrize("dense_db", ["auto", "on"])
def test_dense_route_raises(fx, dense_db):
    """``dense_db`` "auto" (the plane fits) and "on" take the column-sharded
    dense route on a 2x2 mesh and place within 1e-4 of the JAX placer's dense
    route and of the oracle; "on" raises ValueError only where the plane is
    over the budget. (``tests/test_torch_sharded_dense.py`` holds the route
    to JAX piece by piece.)"""
    db, _, tree, reads = fx
    port = ShardedTorchPlacer(db, tree, make_mesh(2, 2, devices=CPU8),
                              config=PlacerConfig(dense_db=dense_db))
    assert port.route == "dense" and port._paired
    jax_p = jax_sharding.ShardedJaxPlacer(db, tree, jax_make_mesh(2, 2),
                                          config=JaxConfig(dense_db=dense_db))
    assert jax_p._dense_db and jax_p._paired
    _both_close(db, tree, reads, port.place(reads), jax_p)
    with pytest.raises(ValueError, match="over the budget"):
        ShardedTorchPlacer(db, tree, make_mesh(2, 2, devices=CPU8),
                           config=PlacerConfig(dense_db="on", dense_db_budget=1 << 10))
