"""The CSR fallback of the port on the CPU, held to the JAX package.

* The cuckoo table: ``packed()`` bit-equal to ``epik_tpu/ops/hashtable.py``'s
  for the same seed; the torch ``lookup`` equal to the JAX one on hits,
  misses and padding sentinels.
* ``ragged_expand`` equal to the JAX one, within and past the budget.
* Kernel 4 with counts: its plain version against the Pallas kernel
  ``segment_accumulate`` in interpret mode (sums rtol 1e-5, atol 1e-4: the
  MXU contraction adds in another order; counts equal).
* ``accumulate_exact_dense``, ``accumulate_amb_firsthit`` and the whole CSR
  step against the JAX functions on the same staged batch.
* Placer level: the CSR route (and CSR batches of the tiles route) against
  ``JaxPlacer`` and the scalar oracle with ``assert_jplace_close`` (1e-4),
  including the P/PA budget-overflow retry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.core.alphabet import DNA
from epik_tpu.core.tree import parse_newick
from epik_tpu.engine.placer import (
    JaxPlacer,
    _pack_outputs,
    _place_batch_device,
    accumulate_amb_firsthit as jax_amb_firsthit,
    accumulate_exact_dense as jax_exact_dense,
)
from epik_tpu.engine.placer import PlacerConfig as JaxConfig
from epik_tpu.engine.reference import ReferencePlacer
from epik_tpu.io.build import build_db, random_db
from epik_tpu.ops import hashtable as jax_hashtable
from epik_tpu.ops.expand import ragged_expand as jax_ragged_expand
from epik_tpu.ops.pallas.accumulate import segment_accumulate

from epik_tpu_torch.engine.config import PlacerConfig
from epik_tpu_torch.engine.outputs import unpack_outputs
from epik_tpu_torch.engine.placer import TorchPlacer
from epik_tpu_torch.engine.staging import _bucket, pad_i32, pad_u64_split
from epik_tpu_torch.engine.step import place_batch_csr
from epik_tpu_torch.kernels.accumulate_sums import accumulate_sums_counts
from epik_tpu_torch.ops import hashtable
from epik_tpu_torch.ops.csr import (
    ORDER_INF,
    accumulate_amb_firsthit,
    accumulate_exact_dense,
    pack_outputs,
)
from epik_tpu_torch.ops.expand import ragged_expand
from test_torch_placer import TREE, assert_jplace_close
from torch_fixtures import MIXED_ROW, cell_order_sums, score_cells, score_rows

CSR = dict(dense_db="off", dense_db_budget=1)  # neither the plane nor the tiles fit


def _reads(db, rng, n, windows=(1, 6)):
    """Reads built from DB keys (most windows hit), plus ambiguous, no-hit and
    shorter-than-k reads."""
    k = db.kmer_size
    recs = []
    for i in range(n):
        parts = [DNA.decode_key(int(db.keys[rng.integers(db.num_kmers)]), k)
                 for _ in range(rng.integers(*windows))]
        recs.append((f"q{i}", "".join(parts).encode()))
    return recs + [("amb", b"ANGTCA" + recs[0][1]), ("amb2", recs[1][1][:4] + b"RY"),
                   ("nohit", b"TTTTTT"), ("short", b"AC")]


@pytest.fixture(scope="module")
def fx():
    """``TestMatmulAccumulate``'s database: 24 leaves, k=6, 2048 keys."""
    db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=23)
    tree = parse_newick(db.tree())
    reads = _reads(db, np.random.default_rng(24), 20)
    jax_p = JaxPlacer(db, tree, config=JaxConfig(accumulate="matmul", **CSR))
    assert not jax_p._tiles_mode and not jax_p._dense_db and jax_p._dense
    port = TorchPlacer(db, tree, config=PlacerConfig(accumulate="matmul", **CSR),
                       device="cpu")
    assert port.route == "csr"
    return db, tree, reads, jax_p, port


def test_cuckoo_table_bit_equal(fx):
    db, _, _, jax_p, port = fx
    lens = np.diff(db.row_off)
    mine = hashtable.build_table(db.keys, np.arange(db.num_kmers, dtype=np.uint32), lens)
    np.testing.assert_array_equal(mine.packed(), jax_p.table.packed())
    assert (mine.seed1, mine.seed2) == (jax_p.table.seed1, jax_p.table.seed2)
    np.testing.assert_array_equal(port.csr.table.numpy(), jax_p.table.packed())
    # a table whose buckets overflow into the eviction walk
    keys = np.unique(np.random.default_rng(5).integers(0, 1 << 40, 5000,
                                                       dtype=np.uint64))
    args = (keys, np.arange(keys.size, dtype=np.uint32), np.ones(keys.size, np.uint32))
    np.testing.assert_array_equal(
        hashtable.build_table(*args, load_factor=0.99).packed(),
        jax_hashtable.build_table(*args, load_factor=0.99).packed())


def test_lookup_matches_jax(fx):
    db, _, _, jax_p, port = fx
    rng = np.random.default_rng(6)
    hits = db.keys[rng.integers(0, db.num_kmers, 300)]
    misses = rng.integers(0, 4**6, 300).astype(np.uint64)
    keys = np.concatenate([hits, misses])
    hi, lo = pad_u64_split(keys, keys.size + 40)  # 40 sentinel padding keys
    cs = port.csr
    found, off, length = hashtable.lookup(cs.table, cs.seed1, cs.seed2,
                                          torch.from_numpy(hi.astype(np.int64)),
                                          torch.from_numpy(lo.astype(np.int64)))
    w_found, w_off, w_len = jax_hashtable.lookup(
        jax_p._dev_table, jax_p.table.seed1, jax_p.table.seed2, jnp.asarray(hi),
        jnp.asarray(lo))
    np.testing.assert_array_equal(found.numpy(), np.asarray(w_found))
    assert found.numpy()[:300].all() and not found.numpy()[-40:].any()
    np.testing.assert_array_equal(length.numpy(), np.asarray(w_len))
    np.testing.assert_array_equal(off.numpy()[found.numpy()],
                                  np.asarray(w_off)[np.asarray(w_found)])
    np.testing.assert_array_equal(off.numpy()[:300],
                                  np.searchsorted(db.keys, hits))  # payload = row


def test_fmix32_matches_numpy():
    x = np.concatenate([np.random.default_rng(7).integers(0, 1 << 32, 1000, dtype=np.uint64),
                        [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF]]).astype(np.uint32)
    got = hashtable._fmix32_t(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, hashtable._fmix32(x).astype(np.int64))


@pytest.mark.parametrize("budget", [8, 64, 400])
def test_ragged_expand_matches_jax(budget):
    lens = np.random.default_rng(budget).integers(0, 9, 40)
    lens[[0, 7, 8]] = 0
    win, elem, total = ragged_expand(torch.from_numpy(lens), budget)
    w_win, w_elem, w_total = jax_ragged_expand(jnp.asarray(lens, jnp.int32), budget)
    np.testing.assert_array_equal(win.numpy(), np.asarray(w_win))
    np.testing.assert_array_equal(elem.numpy(), np.asarray(w_elem))
    assert int(total) == int(w_total) == lens.sum()


@pytest.mark.parametrize("R,PP,B,engineered", [
    pytest.param(16, 1024, 300, False, id="16-1024-300"),
    pytest.param(8, 512, 1303, False, id="8-512-1303"),
    pytest.param(16, 1024, 300, True, id="16-1024-300-engineered"),
    pytest.param(16, 1536, 1303, True, id="16-1536-1303-engineered"),
    pytest.param(16, 1024, 40000, True, id="16-1024-40000-engineered"),
])
def test_sums_counts_plain_matches_pallas(R, PP, B, engineered):
    """Kernel 4's plain version with counts against the Pallas kernel in
    interpret mode and, on the engineered rows (trash interleaved, long runs
    on one branch, one owner warp, tile edges, mixed magnitudes, -0.0),
    bit for bit against a loop that adds each row's cells in order: the
    contract the CUDA kernel is held to."""
    rng = np.random.default_rng(R * B)
    if engineered:
        b, s = score_rows(rng, R, PP, B)
    else:
        b, s = score_cells(rng, R, PP, B)
    S, C = accumulate_sums_counts(torch.from_numpy(b), torch.from_numpy(s), B=B)
    w_S, w_C = segment_accumulate(jnp.asarray(b), jnp.asarray(s), B, interpret=True)
    # the one-hot matmul adds in another order than cell order, and the
    # mixed-magnitude row is built so that the order shows in its sums
    rows = np.arange(R) != MIXED_ROW if engineered else slice(None)
    np.testing.assert_allclose(S.numpy()[rows], np.asarray(w_S)[rows], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(C.numpy(), np.asarray(w_C))
    assert C.numpy()[0, B - 1] == PP
    if engineered:
        want_S, want_C = cell_order_sums(b, s, B)
        np.testing.assert_array_equal(S.numpy().view(np.int32), want_S.view(np.int32))
        np.testing.assert_array_equal(C.numpy(), want_C)
        assert C.numpy()[5].sum() == 0  # the all-trash row


def _stage(port, seqs, P, PA):
    """The CSR staging of ``TorchPlacer._place_async_csr`` as numpy arrays."""
    R = len(seqs)
    tok = port._tokenize(seqs)
    m_signed = tok.seq_lengths - port.k + 1
    m_f32 = np.where(m_signed >= 0, m_signed.astype(np.float32),
                     np.float32(2.0**64) + m_signed.astype(np.float32)).astype(np.float32)
    E = _bucket(tok.exact_keys.shape[0], 16)
    A = _bucket(tok.amb_keys.shape[0], 16)
    e_hi, e_lo = pad_u64_split(tok.exact_keys, E)
    a_hi, a_lo = pad_u64_split(tok.amb_keys, A)
    return dict(e_hi=e_hi, e_lo=e_lo, e_read=pad_i32(tok.exact_read, E, R),
                a_hi=a_hi, a_lo=a_lo, a_read=pad_i32(tok.amb_read, A, R),
                a_order=pad_i32(tok.amb_order, A, ORDER_INF), m_f32=m_f32)


@pytest.mark.parametrize("P,PA", [(512, 64), (512, 8)])
def test_csr_step_matches_jax(fx, P, PA):
    """The step's parts and the whole step on one staged batch; PA = 8 is
    below the batch's ambiguous postings, so both report the same overflow
    total."""
    db, _, reads, jax_p, port = fx
    seqs = list(dict.fromkeys(s for _, s in reads))
    R, B, K = len(seqs), port.B, min(7, port.B)
    st = _stage(port, seqs, P, PA)
    t = {name: torch.from_numpy(a.astype(np.int64) if a.dtype != np.float32 else a)
         for name, a in st.items()}
    j = {name: jnp.asarray(a) for name, a in st.items()}
    cs = port.csr
    tbl, s1, s2 = jax_p._dev_table, jax_p.table.seed1, jax_p.table.seed2
    post, row_off = jax_p._dev_postings, jax_p._dev_row_off

    S, C, mx = accumulate_exact_dense(cs.table, cs.seed1, cs.seed2, cs.post_b, cs.post_s,
                                      cs.row_off, t["e_hi"], t["e_lo"], t["e_read"],
                                      R=R, B=B, PP=P)
    w_S, w_C, w_mx = jax_exact_dense(tbl, post, row_off, j["e_hi"], j["e_lo"],
                                     j["e_read"], R=R, B=B, PP=P, seed1=s1, seed2=s2,
                                     interpret=True)
    np.testing.assert_array_equal(C.numpy(), np.asarray(w_C))
    np.testing.assert_allclose(S.numpy(), np.asarray(w_S), rtol=1e-5, atol=1e-4)
    assert int(mx) == int(w_mx)

    first, V, a_tot = accumulate_amb_firsthit(
        cs.table, cs.seed1, cs.seed2, cs.post_b, cs.post_s, cs.row_off, t["a_hi"],
        t["a_lo"], t["a_read"], t["a_order"], R=R, B=B, PA=PA, k=port.k,
        eps=float(port.eps))
    w_first, w_V, w_a_tot = jax_amb_firsthit(
        tbl, post, row_off, j["a_hi"], j["a_lo"], j["a_read"], j["a_order"], R=R, B=B,
        PA=PA, k=port.k, seed1=s1, seed2=s2, eps=float(port.eps))
    np.testing.assert_array_equal(first.numpy(), np.asarray(w_first))
    assert (first.numpy() < ORDER_INF).any()
    np.testing.assert_allclose(V.numpy(), np.asarray(w_V), rtol=1e-6)
    assert int(a_tot) == int(w_a_tot)

    kw = dict(R=R, B=B, K=K, P=P, PA=PA, k=port.k, log_eps=float(port.log_eps),
              eps=float(port.eps))
    got = place_batch_csr(cs.table, cs.seed1, cs.seed2, cs.post_b, cs.post_s,
                          cs.row_off, t["e_hi"], t["e_lo"], t["e_read"], t["a_hi"],
                          t["a_lo"], t["a_read"], t["a_order"], t["m_f32"], **kw).numpy()
    want = np.asarray(_place_batch_device(
        tbl, post, row_off, j["e_hi"], j["e_lo"], j["e_read"], j["a_hi"], j["a_lo"],
        j["a_read"], j["a_order"], j["m_f32"], seed1=s1, seed2=s2, dense=True,
        interpret=True, **kw))
    assert got.shape == want.shape == (R + 1, 4 * K + 2)
    mine, ref = unpack_outputs(got, K), unpack_outputs(want, K)
    assert mine[6:] == ref[6:]  # the budget totals
    assert mine[6] <= P and (mine[7] > PA) == (PA == 8)
    np.testing.assert_array_equal(mine[4], ref[4])  # n
    np.testing.assert_array_equal(mine[5], ref[5])  # zero_sum
    live = np.arange(K)[None, :] < np.minimum(ref[4], K)[:, None]
    np.testing.assert_array_equal(mine[1][live], ref[1][live])  # idx
    np.testing.assert_array_equal(mine[2][live], ref[2][live])  # counts
    np.testing.assert_allclose(mine[0][live], ref[0][live], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mine[3][live], ref[3][live], rtol=1e-4, atol=1e-6)


def test_unpack_outputs_large_totals_exact():
    K, R = 7, 4
    outs = (torch.zeros((R, K)), torch.zeros((R, K), dtype=torch.int64),
            torch.zeros((R, K), dtype=torch.int32), torch.zeros((R, K)),
            torch.zeros(R, dtype=torch.int32), torch.zeros(R, dtype=torch.bool))
    big = 16_777_219  # 2**24 + 3: one f32 would round it
    packed = pack_outputs(outs, torch.tensor(big), torch.tensor(big + 1)).numpy()
    *_, e_total, a_total = unpack_outputs(packed, K)
    assert e_total == big and a_total == big + 1
    w_outs = tuple(jnp.asarray(o.numpy()) for o in outs)
    np.testing.assert_array_equal(
        packed, np.asarray(_pack_outputs(w_outs, jnp.int32(big), jnp.int32(big + 1))))


def test_csr_route_matches_oracle_and_jax(fx):
    db, tree, reads, jax_p, port = fx
    out = port.place(reads)
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    assert_jplace_close(jax_p.place(reads), out)
    # exact counts come out of the CSR step (the shifted paths report -1)
    assert (out.counts[out.keep] >= 0).all()


def test_budget_overflow_retry():
    """A tiny posting-budget headroom forces the P and PA retries."""
    db = random_db(num_leaves=24, kmer_size=6, num_kmers=1024, mean_posting_len=24.0,
                   seed=26)
    tree = parse_newick(db.tree())
    reads = _reads(db, np.random.default_rng(27), 6, windows=(8, 9))
    port = TorchPlacer(db, tree, config=PlacerConfig(budget_headroom=0.01, **CSR),
                       device="cpu")
    out = port.place(reads)
    assert port.route == "csr" and port.overflow_retries > 0
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    jax_p = JaxPlacer(db, tree, config=JaxConfig(accumulate="matmul",
                                                 budget_headroom=0.01, **CSR))
    assert_jplace_close(jax_p.place(reads), out)


def test_below_threshold_scores_take_csr():
    """Scores below log10(eps) void the shifted scoring of planes and tiles:
    with the dense plane off, the placer routes every batch to CSR, whose
    counts-based correction matches the oracle."""
    db = build_db({"ACG": [(0, 0.0), (2, -2.0)], "CGT": [(1, -0.5)],
                   "GTA": [(0, -1.2), (1, -0.3), (2, -0.7)]}, TREE, kmer_size=3)
    tree = parse_newick(TREE)
    port = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device="cpu")
    assert port.route == "csr"
    reads = [("a", b"ACGTACGT"), ("b", b"ACGNTA"), ("c", b"TTTT"), ("d", b"AC")]
    out = port.place(reads)
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), out)
    jax_p = JaxPlacer(db, tree, config=JaxConfig(dense_db="off", accumulate="matmul"))
    assert not jax_p._tiles_mode
    assert_jplace_close(jax_p.place(reads), out)


def test_tiles_route_sends_unstageable_batches_to_csr():
    """A batch whose reads are all shorter than k cannot take the tile step:
    it goes to the CSR step whole (the dense route raises for it instead)."""
    db = random_db(num_leaves=24, kmer_size=6, num_kmers=2048, seed=23)
    tree = parse_newick(db.tree())
    port = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device="cpu")
    assert port.route == "tiles"
    reads = [("a", b"ACG"), ("b", b""), ("c", b"ACGTA")]
    pending = port.place_async(reads)
    assert pending.budget[0] == "csr"
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), port.place_wait(pending))


def test_empty_database_takes_csr():
    db = build_db({}, TREE, kmer_size=3)
    tree = parse_newick(TREE)
    port = TorchPlacer(db, tree, config=PlacerConfig(dense_db="off"), device="cpu")
    assert port.route == "csr"
    reads = [("a", b"ACGTACGT"), ("b", b"ACGNTA")]
    assert_jplace_close(ReferencePlacer(db, tree).place(reads), port.place(reads))
