"""The pair-plane slot tokenizer kernel (``kernels/tokenize.py::
tokenize_combo_fused``, ``kernels/csrc/tokenize.cu``) against its plain
version, ``ops/tokenize.py::tokenize_combo`` with
``engine/step.py::window_counts``.

On the CPU: the wrapper returns the plain version; a numpy model of the
kernel's arithmetic (one 32-bit word of codes a slot, its 2-bit groups
reversed; a window of bad bits) equals it on every case; the wrapper raises
past the kernel's k limit; the ctypes prototype matches the C signature.

On the card (the tests marked ``cuda`` skip without one): the kernel is
bit-equal to the plain version on every case, on long reads and on a
16,381-read batch, two launches alike, one launch counted a call, and the
pair-plane step is the kernel and ``_shifted_finish``, bit for bit. The file
imports no jax, so those run where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tokenize_kernel.py
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from epik_tpu_torch.engine.staging import pack_reads
from epik_tpu_torch.engine.step import window_counts
from epik_tpu_torch.kernels import launch_counts, reset_launch_counts
from epik_tpu_torch.kernels._build import CSRC, _PROTOTYPES
from epik_tpu_torch.kernels.tokenize import MAX_K, tokenize_combo_fused
from epik_tpu_torch.ops.tokenize import tokenize_combo

#: (name, k, Lmax, R): odd and even W (W = Lmax - k + 1 is even for odd k),
#: a bucketed long read, W = 1, one read
CASES = [("illumina", 10, 152, 40), ("even_w", 9, 152, 40), ("short_k5", 5, 40, 48),
         ("w1", 8, 8, 12), ("long", 10, 640, 12), ("one_read", 10, 152, 1)]
#: the card also takes long reads, the k limit and the path's batch
CARD_CASES = CASES + [("long_5120", 10, 5120, 16), ("long_4096_even_w", 11, 4096, 8),
                      ("k12", 12, 152, 64), ("k13", 13, 64, 64), ("batch", 10, 152, 16381)]


def _reads(rng, k: int, Lmax: int, R: int):
    """Packed reads (``staging.pack_reads``): lengths up to Lmax, some
    shorter than k (Q1) and an all-padding row; non-exact characters at read
    starts, ends and middles, and runs of them; padding non-exact, as the
    placer stages it."""
    lens = rng.integers(max(1, Lmax - 7), Lmax + 1, R)
    lens[1::6] = rng.integers(1, k, len(lens[1::6]))  # shorter than k
    if R > 3:
        lens[3] = 0  # a padding row of the sharded batch geometry
    codes = rng.integers(0, 4, (R, Lmax)).astype(np.uint8)
    for i in range(R):
        L = int(lens[i])
        if L == 0:
            continue
        where = (0, L - 1, L // 2, None)[i % 4]
        if where is not None:
            codes[i, where] = 4
        if i % 5 == 0:
            codes[i, rng.random(Lmax) < 0.1] = 4
        if i % 7 == 0:
            codes[i, L // 3: L // 3 + k + 2] = 4
    codes[np.arange(Lmax)[None, :] >= lens[:, None]] = 4
    return pack_reads(codes, lens)


def _case(name: str, k: int, Lmax: int, R: int, seed: int):
    """(buf, combo) numpy: the reads of :func:`_reads`, or for ``random``
    names any bytes at all (every bit of every code, bad bit and length);
    combo's cells hold their own index, so a wrong index shows."""
    rng = np.random.default_rng([seed, k, Lmax, R])
    if name.startswith("random"):
        buf = rng.integers(0, 256, (R, Lmax // 4 + Lmax // 8 + 2)).astype(np.uint8)
    else:
        buf = _reads(rng, k, Lmax, R)
    return buf, np.arange(4 ** (k + 1) + 4**k + 1, dtype=np.int32)


def _kernel_model(buf: np.ndarray, combo: np.ndarray, k: int, Lmax: int):
    """``csrc/tokenize.cu``'s arithmetic, slot by slot, in numpy."""
    R = buf.shape[0]
    L4, L8 = Lmax // 4, Lmax // 8
    W = Lmax - k + 1
    c0 = 2 * np.arange((W + 1) // 2, dtype=np.int64)

    def word_at(region, i):  # 4 bytes from byte i, little-endian; 0 past the end
        w = np.zeros((R, c0.size), np.int64)
        for b in range(4):
            j = i + b
            byte = region[:, np.minimum(j, region.shape[1] - 1)].astype(np.int64)
            w |= np.where(j < region.shape[1], byte, 0) << (8 * b)
        return w

    codes = word_at(buf[:, :L4], c0 >> 2) >> (2 * (c0 & 3))
    rev = sum(((codes >> (2 * t)) & 3) << (2 * (15 - t)) for t in range(16))
    key11 = rev >> (32 - 2 * (k + 1))
    bad = word_at(buf[:, L4:L4 + L8], c0 >> 3) >> (c0 & 7)
    ok0 = (bad & ((1 << k) - 1)) == 0
    ok1 = (c0 + 1 < W) & (((bad >> 1) & ((1 << k) - 1)) == 0)
    n11 = 4 ** (k + 1)
    idx = np.where(ok0 & ok1, key11,
                   np.where(ok0, n11 + (key11 >> 2),
                            np.where(ok1, n11 + (key11 & (4**k - 1)), n11 + 4**k)))
    lens = buf[:, L4 + L8].astype(np.int32) | (buf[:, L4 + L8 + 1].astype(np.int32) << 8)
    ms = (lens - (k - 1)).astype(np.float32)
    return combo[idx], lens, np.where(ms >= 0, ms, ms + np.float32(2.0**64))


def _assert_bits_equal(got, want):
    rows, lens, m = got
    rows_w, lens_w, m_w = want
    assert rows.dtype == torch.int32 and lens.dtype == torch.int32
    assert m.dtype == torch.float32
    assert torch.equal(rows, rows_w) and torch.equal(lens, lens_w)
    assert torch.equal(m.view(torch.int32), m_w.view(torch.int32))


def _plain(buf, combo, k, Lmax):
    rows, lens = tokenize_combo(buf, combo, k=k, Lmax=Lmax)
    return rows, lens, window_counts(lens, k)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name,k,Lmax,R", CASES + [("random", 10, 152, 24),
                                                   ("random_even_w", 9, 40, 24)],
                         ids=lambda v: str(v))
def test_cpu_path_is_the_plain_version(name, k, Lmax, R, seed):
    """The wrapper on the CPU is ``tokenize_combo`` + ``window_counts``, and the
    kernel's arithmetic modelled in numpy gives the same rows, lengths and
    window counts (the m wrap of reads shorter than k included)."""
    buf, combo = _case(name, k, Lmax, R, seed)
    buf_t, combo_t = torch.from_numpy(buf), torch.from_numpy(combo)
    reset_launch_counts()
    got = tokenize_combo_fused(buf_t, combo_t, k=k, Lmax=Lmax)
    assert not any(launch_counts().values())  # the plain version never counts
    want = _plain(buf_t, combo_t, k, Lmax)
    _assert_bits_equal(got, want)
    _assert_bits_equal(tuple(torch.from_numpy(np.ascontiguousarray(a))
                             for a in _kernel_model(buf, combo, k, Lmax)), want)
    assert got[0].shape == (R, (Lmax - k + 2) // 2)
    if R > 3 and not name.startswith("random"):  # the cases hold a Q1 read and a miss slot
        assert (got[2] == 2.0**64).any() and (got[0] == 4 ** (k + 1) + 4**k).any()


@pytest.mark.parametrize("k", [0, MAX_K + 1, 31])
def test_k_limit_raises(k):
    buf = torch.zeros((2, 152 // 4 + 152 // 8 + 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="k="):
        tokenize_combo_fused(buf, torch.zeros(8, dtype=torch.int32), k=k, Lmax=152)


def test_bad_inputs_raise():
    buf, combo = (torch.from_numpy(a) for a in _case("illumina", 10, 152, 4, 0))
    with pytest.raises(ValueError, match="buf"):
        tokenize_combo_fused(buf[:, :-1].contiguous(), combo, k=10, Lmax=152)
    with pytest.raises(ValueError, match="combo"):
        tokenize_combo_fused(buf, combo[:-1], k=10, Lmax=152)
    with pytest.raises(ValueError, match="Lmax"):
        tokenize_combo_fused(buf, combo, k=10, Lmax=150)


def test_prototype_matches_the_c_signature():
    """``_PROTOTYPES`` gives ``epik_tokenize_combo`` one argument type per
    parameter of its C definition: a pointer for each pointer, an int for
    each int."""
    src = (CSRC / "tokenize.cu").read_text()
    params = re.search(r'extern "C" int epik_tokenize_combo\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
    assert _PROTOTYPES["epik_tokenize_combo"] == kinds


# ---- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,Lmax,R", CARD_CASES + [("random", 10, 152, 2000),
                                                        ("random_even_w", 11, 152, 64)],
                         ids=lambda v: str(v))
def test_kernel_bit_equal(cuda, name, k, Lmax, R):
    """Rows, lengths and the bits of m_f32 equal the plain version's (run on
    the card), and two launches give the same result."""
    buf, combo = _case(name, k, Lmax, R, 7)
    buf_t, combo_t = torch.from_numpy(buf).to(cuda), torch.from_numpy(combo).to(cuda)
    got = tokenize_combo_fused(buf_t, combo_t, k=k, Lmax=Lmax)
    again = tokenize_combo_fused(buf_t, combo_t, k=k, Lmax=Lmax)
    want = _plain(buf_t, combo_t, k, Lmax)
    torch.cuda.synchronize()
    _assert_bits_equal(got, want)
    _assert_bits_equal(again, got)


@pytest.mark.cuda
def test_launches_count_one_a_call(cuda):
    buf, combo = (torch.from_numpy(a).to(cuda) for a in _case("illumina", 10, 152, 40, 3))
    reset_launch_counts()
    for _ in range(3):
        tokenize_combo_fused(buf, combo, k=10, Lmax=152)
    tokenize_combo(buf, combo, k=10, Lmax=152)  # the plain version never counts
    tokenize_combo_fused(buf[:0], combo, k=10, Lmax=152)  # no read, no launch
    torch.cuda.synchronize()
    assert {n: c for n, c in launch_counts().items() if c} == {"tokenize_combo_fused": 3}


@pytest.mark.cuda
def test_pair_plane_step_is_the_kernel_and_shifted_finish(cuda):
    """The dense pair-plane step on the card is the tokenizer kernel and
    ``_shifted_finish`` on its rows and window counts, bit for bit, and
    equals the same finish on the plain tokenizer's: IUPAC reads (delta rows),
    reads shorter than k and an odd W's single slot among them."""
    from epik_tpu_torch.core.tree import parse_newick
    from epik_tpu_torch.engine.placer import TorchPlacer
    from epik_tpu_torch.engine.step import _shifted_finish, place_batch_dense_paired
    from epik_tpu_torch.io.build import reads_from_reference, reference_like_db

    db, ref = reference_like_db(num_leaves=48, kmer_size=8, ref_length=30_000,
                                mean_posting_len=6.0, seed=31)
    reads = reads_from_reference(ref, 200, length=101, mutation_rate=0.05, seed=32)
    seqs = list(dict.fromkeys(s for _, s in reads))
    seqs += [seqs[0][:40] + b"N" + seqs[0][41:], b"AC", b"T" * 30, b"ACGTACGTACGTACGT"]
    port = TorchPlacer(db, parse_newick(db.tree()), device=cuda)
    assert port._paired
    buf, arows, Amax, Lmax, _ = port._stage_bytes(seqs)
    assert Amax > 0
    st, k = port.state, port.k
    buf_t, arows_t = torch.from_numpy(buf).to(cuda), torch.from_numpy(arows).to(cuda)
    kw = dict(B=port.B, K=port._K(), Amax=Amax, k=k, log_eps=float(port.log_eps),
              eps=float(port.eps), gather=port._gather)
    reset_launch_counts()
    step = place_batch_dense_paired(st.plane, st.combo, buf_t, arows_t, Lmax=Lmax,
                                    num_kmers=st.n_keys, **kw)
    assert launch_counts()["tokenize_combo_fused"] == 1
    rows, _, m_f32 = tokenize_combo_fused(buf_t, st.combo, k=k, Lmax=Lmax)
    got = _shifted_finish(st.plane, rows, m_f32, arows_t, zero_row=st.n_keys,
                          pair_rows=True, **kw)
    rows_p, _, m_p = _plain(buf_t, st.combo, k, Lmax)
    plain = _shifted_finish(st.plane, rows_p, m_p, arows_t, zero_row=st.n_keys,
                            pair_rows=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, step) and torch.equal(plain, step)
