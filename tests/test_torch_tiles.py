"""The big-tree posting-tile path of the port on the CPU, held to the JAX package.

* The tile build: tile arrays, the permuted direct table and the tile scalars
  bit-equal to ``JaxPlacer._dev_tiles`` and its companions, both payloads.
* Kernel 3 (packed accumulate + finish): its plain version against the
  Pallas kernel ``segment_accumulate_packed_topk`` in interpret mode -- the
  integer sums bit-equal to ``segment_accumulate_packed``, scores within
  1e-5, live indices, n and zero_sum equal.
* Kernel 4 without counts: its plain version against ``segment_accumulate_sums``
  (sums rtol 1e-5, atol 1e-4: the MXU contraction adds in another order).
* The tile step against ``_place_batch_tiles_bytes`` on the JAX placer's own
  tiles and staged batch, both payloads.
* Every case of ``tests/test_jax_engine.py::TestTilesPath`` at placer level,
  against ``JaxPlacer(dense_db="off", accumulate="matmul")`` and the scalar
  oracle with ``assert_jplace_close`` (1e-4).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.core.alphabet import DNA
from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import JaxPlacer
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db, random_reads, reads_from_reference
from epik_tpu.io.build import reference_like_db
from epik_tpu.ops.pallas.accumulate import (
    segment_accumulate_packed,
    segment_accumulate_packed_topk,
    segment_accumulate_sums,
)

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.outputs import _SplitPending
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.step import place_batch_tiles_bytes
from epik_tpu_torch.engine.tiles import tile_state_from_numpy
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels.accumulate_packed import (
    accumulate_packed_topk,
    accumulate_packed_topk_plain,
    packed_sums_plain,
)
from epik_tpu_torch.kernels.accumulate_sums import accumulate_sums, accumulate_sums_plain
from epik_tpu_torch.ops.tokenize import tokenize_packed
from test_torch_placer import assert_jplace_close
from torch_fixtures import MIXED_ROW, cell_order_sums, packed_cells, score_cells, score_rows

LOG_EPS = -4.2597


def _jax(db, tree, **kw):
    p = JaxPlacer(db, tree, config=JaxConfig(dense_db="off", accumulate="matmul", **kw))
    assert p._tiles_mode
    return p


def _port(db, tree, **kw):
    p = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", **kw), device="cpu")
    assert p.route == "tiles"
    return p


def _both_close(db, tree, out_port, reads, jax_p):
    """The port against the oracle and the JAX placer, 1e-4 on score sets."""
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out_port)
    assert_jplace_close(jax_p.place(reads), out_port)


@pytest.fixture(scope="module")
def fx():
    """``TestTilesPath._fixture``: 96 leaves, k=10, mean 6 postings per key
    (the two-level split engages), 121 bp and 80 bp reads, short and no-hit."""
    db, ref = reference_like_db(num_leaves=96, kmer_size=10, ref_length=40_000,
                                mean_posting_len=6.0, seed=71)
    tree = parse_newick(db.tree())
    reads = reads_from_reference(ref, 50, length=121, mutation_rate=0.05, seed=72)
    reads += reads_from_reference(ref, 6, length=80, mutation_rate=0.4, seed=73)
    reads += [("short", b"AC"), ("nohit", b"T" * 30)]
    jax_packed = _jax(db, tree)
    jax_f32 = _jax(db, tree, tile_payload="f32")
    jax_packed._dev_tiles  # the JAX placer builds its tiles at first use
    jax_f32._dev_tiles
    return db, ref, tree, reads, jax_packed, jax_f32, _port(db, tree)


def _jax_tile_state(jp):
    return tile_state_from_numpy(
        np.asarray(jp._dev_tiles),
        np.asarray(jp._dev_tiles_ov) if jp._dev_tiles_ov is not None else None,
        np.asarray(jp._dev_direct), pt=jp._tile_pt, pt_ov=jp._tile_pt_ov,
        n_ov=jp._tile_n_ov, frac_over=jp._tile_frac_over, scale=jp._tile_scale,
        n_keys=jp.db.num_kmers, device="cpu")


@pytest.mark.parametrize("payload", ["packed", "f32"])
def test_tile_state_bit_equal(fx, payload):
    db, _, tree, _, jax_packed, jax_f32, port = fx
    jp = jax_packed if payload == "packed" else jax_f32
    ts = port.tiles if payload == "packed" else _port(db, tree, tile_payload="f32").tiles
    assert ts.packed == (payload == "packed") == jp._tile_packed
    np.testing.assert_array_equal(ts.tiles.numpy(), np.asarray(jp._dev_tiles).view(np.int32))
    np.testing.assert_array_equal(ts.direct.numpy(), np.asarray(jp._dev_direct))
    assert (ts.pt, ts.pt_ov, ts.n_ov) == (jp._tile_pt, jp._tile_pt_ov, jp._tile_n_ov)
    assert ts.frac_over == jp._tile_frac_over and ts.scale == jp._tile_scale
    if payload == "packed":
        assert ts.pt_ov > 0  # the two-level split engages on this fixture
        np.testing.assert_array_equal(ts.tiles_ov.numpy(), np.asarray(jp._dev_tiles_ov))
    else:
        assert ts.tiles_ov is None and jp._dev_tiles_ov is None


def test_tokenize_packed_uses_permuted_direct(fx):
    _, _, _, reads, jax_packed, _, port = fx
    seqs = [s for _, s in reads[:8]]
    fn, arrays, *_ = jax_packed._stage_bytes(seqs)
    buf = np.array(arrays[2])
    kw = fn.keywords
    rows, lens = tokenize_packed(torch.from_numpy(buf), port.tiles.direct, k=kw["k"],
                                 Lmax=kw["Lmax"], num_kmers=kw["num_kmers"])
    from epik_tpu.engine.placer import device_tokenize_packed
    want_rows, want_lens = device_tokenize_packed(
        jnp.asarray(buf), arrays[1], k=kw["k"], Lmax=kw["Lmax"],
        num_kmers=kw["num_kmers"])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    assert (rows.numpy() < port.tiles.n_ov).any()  # windows with overflow rows


@pytest.mark.parametrize("R,PP,B,K,k", [(16, 1024, 300, 7, 10), (8, 512, 45, 12, 6),
                                        (24, 1536, 1303, 7, 10)])
def test_packed_kernel_plain_matches_pallas(R, PP, B, K, k):
    rng = np.random.default_rng(PP + B)
    p, m = packed_cells(rng, R, PP, B)
    scale = 15023.0
    sq = packed_sums_plain(torch.from_numpy(p), B).numpy()
    np.testing.assert_array_equal(
        sq, np.asarray(segment_accumulate_packed(jnp.asarray(p), B, interpret=True)))
    mine = accumulate_packed_topk_plain(torch.from_numpy(p), torch.from_numpy(m), B=B,
                                        K=K, k=k, log_eps=LOG_EPS, scale=scale).numpy()
    ref = np.asarray(segment_accumulate_packed_topk(
        jnp.asarray(p), jnp.asarray(m), B, K, k=k, log_eps=LOG_EPS, scale=scale,
        interpret=True))
    assert mine.shape == ref.shape == (R, 2 * K + 3)
    n = ref[:, 2 * K + 1].astype(int)
    assert n[0] == 0 and n[1] == 2
    np.testing.assert_array_equal(mine[:, 2 * K + 1:], ref[:, 2 * K + 1:])  # n, zero_sum
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    # the -inf slots: distinct untouched branches here, bw - 1 in the TPU kernel
    np.testing.assert_array_equal(mine[:, K:2 * K][live], ref[:, K:2 * K][live])
    np.testing.assert_allclose(mine[:, :K][live], ref[:, :K][live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[:, 2 * K], ref[:, 2 * K], rtol=1e-5)
    np.testing.assert_array_equal(mine[2, K:2 * K], np.arange(10, 10 + K))  # ties


def test_packed_wrapper_cpu_uses_plain_and_checks_inputs():
    rng = np.random.default_rng(1)
    p, m = packed_cells(rng, 8, 64, 200)
    p_t, m_t = torch.from_numpy(p), torch.from_numpy(m)
    kw = dict(B=200, K=7, k=10, log_eps=LOG_EPS, scale=15023.0)
    reset_launch_counts()
    assert torch.equal(accumulate_packed_topk(p_t, m_t, **kw),
                       accumulate_packed_topk_plain(p_t, m_t, **kw))
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="2\\*\\*15"):
        accumulate_packed_topk(p_t, m_t, **{**kw, "B": 40000})
    with pytest.raises(ValueError):
        accumulate_packed_topk(p_t.long(), m_t, **kw)
    with pytest.raises(ValueError):
        accumulate_packed_topk(p_t, m_t, **{**kw, "K": 65})


@pytest.mark.parametrize("R,PP,B,engineered", [
    pytest.param(16, 1024, 300, False, id="16-1024-300"),
    pytest.param(8, 512, 1303, False, id="8-512-1303"),
    pytest.param(16, 1024, 300, True, id="16-1024-300-engineered"),
    pytest.param(16, 2048, 19999, True, id="16-2048-19999-engineered"),
    pytest.param(16, 512, 60000, True, id="16-512-60000-engineered"),
])
def test_sums_kernel_plain_matches_pallas(R, PP, B, engineered):
    """Kernel 4's plain version without counts against the Pallas kernel in
    interpret mode and against a loop that adds each row's cells in order:
    row 3 of the random cells, every engineered row bit for bit."""
    rng = np.random.default_rng(R + B)
    if engineered:
        b, s = score_rows(rng, R, PP, B)
    else:
        b, s = score_cells(rng, R, PP, B)
    mine = accumulate_sums(torch.from_numpy(b), torch.from_numpy(s), B=B).numpy()
    ref = np.asarray(segment_accumulate_sums(jnp.asarray(b), jnp.asarray(s), B,
                                             interpret=True))
    # the one-hot matmul adds in another order than cell order, and the
    # mixed-magnitude row is built so that the order shows in its sums
    rows = np.arange(R) != MIXED_ROW if engineered else slice(None)
    np.testing.assert_allclose(mine[rows], ref[rows], rtol=1e-5, atol=1e-4)
    want, _ = cell_order_sums(b, s, B)
    check = slice(None) if engineered else 3
    np.testing.assert_array_equal(mine[check].view(np.int32), want[check].view(np.int32))


@pytest.mark.parametrize("payload", ["packed", "f32"])
def test_tile_step_matches_jax(fx, payload):
    """The whole tile step on the JAX placer's tiles and staged batch."""
    _, _, _, reads, jax_packed, jax_f32, _ = fx
    jp = jax_packed if payload == "packed" else jax_f32
    seqs = list(dict.fromkeys(s for _, s in reads))
    fn, arrays, _, R_true, K, *retry = jp._stage_bytes(seqs)
    kw = fn.keywords
    want = np.asarray(fn(*arrays))
    ts = _jax_tile_state(jp)
    got = place_batch_tiles_bytes(
        ts.tiles, ts.direct, torch.from_numpy(np.array(arrays[2])), ts.tiles_ov,
        B=kw["B"], K=K, k=kw["k"], Lmax=kw["Lmax"], num_kmers=kw["num_kmers"],
        PT=kw["PT"], log_eps=kw["log_eps"], packed=kw["packed"],
        scale=kw["tile_scale"], PT_OV=kw.get("PT_OV", 0), OV=kw.get("OV", 0),
        N_OV=kw.get("N_OV", 0)).numpy()
    assert got.shape == want.shape
    assert (kw.get("PT_OV", 0) > 0) == (payload == "packed") == bool(retry)
    if retry:  # the overflow-window counts ride in the last column
        np.testing.assert_array_equal(got[:, -1], want[:, -1])
    n = want[:, 2 * K + 1].astype(int)
    np.testing.assert_array_equal(got[:, 2 * K + 1:2 * K + 3], want[:, 2 * K + 1:2 * K + 3])
    live = np.arange(K)[None, :] < np.minimum(n, K)[:, None]
    assert live[:R_true].any()
    np.testing.assert_array_equal(got[:, K:2 * K][live], want[:, K:2 * K][live])
    np.testing.assert_allclose(got[:, :K][live], want[:, :K][live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, 2 * K], want[:, 2 * K], rtol=1e-5)


def test_matches_oracle_and_jax(fx):
    db, _, tree, reads, jax_packed, _, port = fx
    assert port.tiles.pt_ov > 0, (port.tiles.pt, port.tiles.pt_ov)
    _both_close(db, tree, port.place(reads), reads, jax_packed)


def test_long_reads_leave_packed_tiles():
    """400 bp reads break the packed exactness gate: the batch takes the
    CSR step whole and still matches the oracle and the JAX placer."""
    db, ref = reference_like_db(num_leaves=48, kmer_size=10, ref_length=20_000,
                                mean_posting_len=6.0, seed=75)
    tree = parse_newick(db.tree())
    port = _port(db, tree)
    long_reads = reads_from_reference(ref, 4, length=400, mutation_rate=0.05, seed=76)
    assert port._place_async_tiles({}, [s for _, s in long_reads]) is None
    out = port.place(long_reads)
    assert port._csr_cache is not None  # the CSR state was built for it
    _both_close(db, tree, out, long_reads, _jax(db, tree))


def test_two_level_overflow_retry():
    """A read whose windows hit overflow keys far beyond the static OV budget
    is re-dispatched with a bigger budget and still matches."""
    rng = np.random.default_rng(201)
    k = 6
    hot = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
    entries = {}
    for w in range(len(hot) - k + 1):
        entries.setdefault(hot[w : w + k], [
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
    port = _port(db, tree)
    reads = [("hot", hot.encode()), ("cold", DNA.decode_key(3, k).encode() * 10)]
    out = port.place(reads)
    assert port.tiles.pt_ov > 0
    assert port.overflow_retries > 0, (port.tiles.pt, port.tiles.pt_ov)
    _both_close(db, tree, out, reads, _jax(db, tree))


def test_amb_batch_splits_tiles_plus_csr(fx):
    db, _, tree, reads, jax_packed, _, port = fx
    reads = reads[:8] + [("amb", reads[0][1][:40] + b"N" + reads[0][1][41:]),
                         ("amb2", reads[1][1][:3] + b"R" + reads[1][1][4:])]
    pending = port.place_async(reads)
    assert isinstance(pending, _SplitPending)
    assert len(pending.idx_amb) == 2 and len(pending.idx_clean) == 8
    assert pending.amb.budget[0] == "csr"
    _both_close(db, tree, port.place_wait(pending), reads, jax_packed)


def test_all_amb_batch_falls_back_whole(fx):
    db, _, tree, reads, jax_packed, _, port = fx
    amb = [("a1", reads[0][1][:40] + b"N" + reads[0][1][41:]),
           ("a2", reads[1][1][:10] + b"Y" + reads[1][1][11:])]
    pending = port.place_async(amb)
    assert not isinstance(pending, _SplitPending) and pending.budget[0] == "csr"
    _both_close(db, tree, port.place_wait(pending), amb, jax_packed)


def test_threshold_boundary_score_places(fx):
    """A posting at exactly log10(eps) stays touched (q clipped to >= 1, the
    f32 payload's 1e-37 nudge)."""
    db0, _, tree, _, _, _, _ = fx
    db = dataclasses.replace(db0, scores=db0.scores.copy())
    db.scores[0] = np.float32(np.log10(np.float32(1.5 / 4) ** db.kmer_size))
    read = [("r", DNA.decode_key(int(db.keys[0]), db.kmer_size).encode())]
    for payload in ("packed", "f32"):
        port = _port(db, tree, tile_payload=payload)
        _both_close(db, tree, port.place(read), read,
                    _jax(db, tree, tile_payload=payload))


def test_f32_payload_matches_oracle(fx):
    db, _, tree, reads, _, jax_f32, _ = fx
    port = _port(db, tree, tile_payload="f32")
    assert not port.tiles.packed and port.tiles.pt_ov == 0
    _both_close(db, tree, port.place(reads), reads, jax_f32)


def test_packed_payload_selected_and_matches_f32(fx):
    db, _, tree, reads, _, _, port = fx
    assert port.tiles.packed
    assert_jplace_close(_port(db, tree, tile_payload="f32").place(reads), port.place(reads))


def test_packed_rejects_wide_branch_ids():
    db = random_db(num_leaves=20000, kmer_size=10, num_kmers=64, mean_posting_len=4.0,
                   seed=75, unique_branches=False)
    tree = parse_newick(db.tree())
    with pytest.raises(ValueError, match="tile_payload"):
        TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", tile_payload="packed"),
                    device="cpu")
    # "auto" takes the f32 payload for such a tree
    assert not _port(db, tree).tiles.packed


def test_hot_kmer_over_128_goes_to_csr():
    """max posting length 64 < L <= 128 takes the tiles; one key past 128
    sends every batch to the CSR step. Both match the oracle and JAX."""
    db = random_db(num_leaves=80, kmer_size=8, num_kmers=512, mean_posting_len=60.0,
                   seed=74)
    lens = np.diff(db.row_off)
    assert 64 < int(lens.max()) <= 128
    tree = parse_newick(db.tree())
    reads = random_reads(20, length=40, seed=75)
    port = _port(db, tree)
    assert port.tiles.pt_ov > 0
    _both_close(db, tree, port.place(reads), reads, _jax(db, tree))

    hot = np.argmax(lens)
    extra = 130 - int(lens[hot])
    rng = np.random.default_rng(76)
    B = tree.get_node_count()
    ins = int(db.row_off[hot + 1])
    db2 = dataclasses.replace(
        db,
        row_off=np.concatenate([db.row_off[: hot + 1], db.row_off[hot + 1 :] + extra]),
        branches=np.insert(db.branches, ins, rng.permutation(B)[:extra].astype(np.uint32)),
        scores=np.insert(db.scores, ins, np.full(extra, -1.0, np.float32)),
        num_entries_total=db.num_entries_total + extra,
        num_entries_loaded=db.num_entries_loaded + extra,
    )
    assert int(np.diff(db2.row_off).max()) > 128
    port2 = TorchPlacer(db2, tree, config=PlacerConfig(dense_db="off"), device="cpu")
    assert port2.route == "csr"
    jax2 = JaxPlacer(db2, tree, config=JaxConfig(dense_db="off", accumulate="matmul"))
    assert not jax2._tiles_mode
    _both_close(db2, tree, port2.place(reads), reads, jax2)


def test_pair_fused_tiles_raise(fx):
    db, _, tree, _, _, _, port = fx
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 6"):
        TorchPlacer(db, tree, config=PlacerConfig(dense_db="off", pair_plane="on"),
                    device="cpu", state=port.tiles)
