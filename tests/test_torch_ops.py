"""Host staging, tables and device ops of the port, held to the JAX package on
the CPU: the slot tokenizer bit-equal to ``device_tokenize_combo``, the
ambiguous first-hit to ``dense_amb_from_rows`` / ``_apply_amb`` (whose add the
fused kernel 1 now does: ``amb_deltas`` gives the rows it adds), and the
numpy copies (``pack_reads``, ``enumerate_pairs``, ``build_combo_table``,
``_bucket_lmax``) equal to the originals."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.core.alphabet import DNA
from epik_tpu.engine import placer as jp
from epik_tpu.io.build import reference_like_db

from epik_tpu_torch.engine import staging, tables
from epik_tpu_torch.ops.dense import ORDER_INF, amb_deltas, dense_amb_from_rows
from epik_tpu_torch.ops.tokenize import tokenize_combo

K = 5


@pytest.fixture(scope="module")
def tabs():
    db, ref = reference_like_db(num_leaves=32, kmer_size=K, ref_length=4_000,
                                mean_posting_len=4.0, seed=13)
    n = db.num_kmers
    direct = np.full(4**K, n, np.int32)
    direct[db.keys.astype(np.int64)] = np.arange(n, dtype=np.int32)
    pu, pv, key11 = jp.enumerate_pairs(db.keys, K, direct, n)
    direct11 = np.full(4 ** (K + 1), -1, np.int32)
    direct11[key11] = n + 1 + np.arange(pu.shape[0], dtype=np.int32)
    return db, ref, direct, direct11


def _packed_batch(ref, seed, n_pad=3):
    """Reads of every length class (odd/even W, shorter than k, interior and
    leading IUPAC characters), plus n_pad all-padding rows, packed as the
    JAX placer packs them."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTNRY", np.uint8)
    ref_arr = np.frombuffer(ref, np.uint8)
    seqs = []
    for i in range(40):
        L = int(rng.integers(1, 40))
        start = int(rng.integers(0, len(ref_arr) - 40))
        s = bytearray(ref_arr[start : start + L])
        if i % 3 == 0 and L > 4:
            s[int(rng.integers(1, L - 1))] = ord("N")
        if i % 7 == 0:
            s[0] = ord("R")
        if i % 5 == 0:
            s = bytearray(letters[rng.integers(0, 7, L)].tobytes())
        seqs.append(bytes(s))
    lens = np.array([len(s) for s in seqs] + [0] * n_pad, np.int64)
    Lmax = int(-(-lens.max() // 8) * 8)
    R = len(lens)
    flat = np.frombuffer(b"".join(seqs), np.uint8)
    starts = np.concatenate([[0], np.cumsum(lens[: len(seqs)])])
    mat = np.zeros((R, Lmax), np.uint8)
    mat[np.repeat(np.arange(len(seqs)), lens[: len(seqs)]),
        np.arange(flat.size) - np.repeat(starts[:-1], lens[: len(seqs)])] = flat
    return DNA.char_code[mat], lens, Lmax


def test_pack_reads_equal(tabs):
    _, ref, _, _ = tabs
    codes, lens, _ = _packed_batch(ref, 1)
    np.testing.assert_array_equal(staging.pack_reads(codes, lens), jp.pack_reads(codes, lens))


@pytest.mark.parametrize("L", [1, 8, 150, 512, 513, 2000, 6345, 65535])
def test_bucket_lmax_equal(L):
    assert staging._bucket_lmax(L) == jp._bucket_lmax(L)
    assert staging._bucket(L, 8) == jp._bucket(L, 8)


def test_tables_equal(tabs):
    db, _, direct, direct11 = tabs
    n = db.num_kmers
    np.testing.assert_array_equal(tables.direct_table(db.keys, K, n), direct)
    for a, b in zip(tables.enumerate_pairs(db.keys, K, direct, n),
                    jp.enumerate_pairs(db.keys, K, direct, n)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tables.build_combo_table(direct, direct11, K, n),
                                  jp.build_combo_table(direct, direct11, K, n))


@pytest.mark.parametrize("seed", [4, 5])
def test_tokenize_combo_bit_equal(tabs, seed):
    db, ref, direct, direct11 = tabs
    n = db.num_kmers
    combo = jp.build_combo_table(direct, direct11, K, n)
    codes, lens, Lmax = _packed_batch(ref, seed)
    buf = jp.pack_reads(codes, lens)
    rows_j, lens_j = jp.device_tokenize_combo(jnp.asarray(buf), jnp.asarray(combo),
                                              k=K, Lmax=Lmax, num_kmers=n)
    rows_t, lens_t = tokenize_combo(torch.from_numpy(buf), torch.from_numpy(combo),
                                    k=K, Lmax=Lmax)
    assert rows_t.dtype == torch.int32 and lens_t.dtype == torch.int32
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))


def _amb_case(seed, n_rows=60, bw=256, B=200, R=12, Amax=16):
    rng = np.random.default_rng(seed)
    plane = rng.uniform(1e-3, 4.2, (n_rows, bw)).astype(np.float32)
    plane[rng.random((n_rows, bw)) > 0.25] = 0.0
    plane[:, B:] = 0.0
    plane[-1] = 0.0  # zero row
    arows = rng.integers(0, n_rows, (R, Amax)).astype(np.int32)
    arows[rng.random((R, Amax)) < 0.4] = n_rows - 1
    arows[0] = n_rows - 1  # a read with no ambiguous key
    Sp = rng.uniform(0.0, 20.0, (R, bw)).astype(np.float32)
    return plane, arows, Sp, B


@pytest.mark.parametrize("seed", [0, 1])
def test_amb_first_hit_equal(seed):
    plane, arows, _, B = _amb_case(seed)
    first, sel = dense_amb_from_rows(torch.from_numpy(plane), torch.from_numpy(arows), B=B)
    first_j, sel_j = jp.dense_amb_from_rows(jnp.asarray(plane), jnp.asarray(arows),
                                            R=arows.shape[0], B=B, Amax=arows.shape[1])
    np.testing.assert_array_equal(first.numpy(), np.asarray(first_j))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(sel_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_amb_matches_jax(seed):
    """``amb_deltas`` + the add the fused kernel does (the plain version's
    ``Sp[reads] + delta``) against ``_apply_amb(shifted=True)``; the reads
    with no ambiguous row get no delta row, and ``_apply_amb`` adds 0 there."""
    plane, arows, Sp, B = _amb_case(seed)
    k, eps = 10, np.float32(5.499e-5)
    log_eps = float(np.float32(math.log10(eps)))
    want, _ = jp._apply_amb(jnp.asarray(Sp[:, :B]), None, jnp.asarray(plane),
                            jnp.asarray(arows), R=arows.shape[0], B=B,
                            Amax=arows.shape[1], k=k, eps=float(eps),
                            log_eps=log_eps, shifted=True)
    zero_row = plane.shape[0] - 1
    reads, delta = amb_deltas(torch.from_numpy(plane), torch.from_numpy(arows),
                              zero_row=zero_row, B=B, k=k, eps=float(eps), log_eps=log_eps)
    np.testing.assert_array_equal(reads.numpy(),
                                  np.flatnonzero((arows != zero_row).any(axis=1)))
    assert 0 not in reads.tolist() and delta.shape == (reads.numel(), B)
    got = torch.from_numpy(Sp[:, :B].copy())
    got[reads] = got[reads] + delta
    # exp of the first-hit score: torch's and XLA's f32 exp may differ in the
    # last ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[0], Sp[0, :B])  # untouched read


@pytest.mark.parametrize("seed", [0, 1])
def test_amb_deltas_match_jax_contribution(seed):
    """The delta rows alone equal ``_apply_amb``'s contribution on zero sums,
    are 0 exactly where no ambiguous row hits, and a batch with no ambiguous
    row gives none."""
    plane, arows, _, B = _amb_case(seed)
    k, eps = 10, np.float32(5.499e-5)
    log_eps = float(np.float32(math.log10(eps)))
    R = arows.shape[0]
    contrib, _ = jp._apply_amb(jnp.zeros((R, B), jnp.float32), None, jnp.asarray(plane),
                               jnp.asarray(arows), R=R, B=B, Amax=arows.shape[1], k=k,
                               eps=float(eps), log_eps=log_eps, shifted=True)
    contrib = np.asarray(contrib)
    zero_row = plane.shape[0] - 1
    reads, delta = amb_deltas(torch.from_numpy(plane), torch.from_numpy(arows),
                              zero_row=zero_row, B=B, k=k, eps=float(eps), log_eps=log_eps)
    np.testing.assert_allclose(delta.numpy(), contrib[reads.numpy()], rtol=1e-6, atol=1e-6)
    first, _ = dense_amb_from_rows(torch.from_numpy(plane), torch.from_numpy(arows[reads]),
                                   B=B)
    np.testing.assert_array_equal(delta.numpy() == 0, first.numpy() == ORDER_INF)
    others = np.setdiff1d(np.arange(R), reads.numpy())
    np.testing.assert_array_equal(contrib[others], 0.0)
    none_r, none_d = amb_deltas(torch.from_numpy(plane),
                                torch.full((4, 3), zero_row, dtype=torch.int32),
                                zero_row=zero_row, B=B, k=k, eps=float(eps), log_eps=log_eps)
    assert none_r.numel() == 0 and none_d.shape == (0, B)
