"""The port's radix index and codes tokenizer on the CPU, held to the JAX package.

``epik_tpu_torch/ops/radix_lookup.py`` keeps a numpy copy of
``epik_tpu/ops/radix_lookup.py``'s build and ports its three device lookups to
torch ops over one int64 key; ``ops/tokenize.py::tokenize_codes`` ports
``device_tokenize_codes``. On keys and reads made from a seed:

* ``build_radix`` gives the original's arrays, form and dispatch statics;
* each lookup form (low-pair-overlap at key widths 35, 30 and 18 with 3-key
  buckets; packed at width 30 without the split; generic at width 39) gives
  the JAX function's rows and ``np.searchsorted``'s, bit for bit;
* the bucket and low bits of an int64 key equal the JAX limbs' split on both
  sides of shift 16;
* the window keys and validity of ``tokenize_codes`` equal the JAX limbs
  recombined (``a * 2**16 + b``) for amino k = 6, 8, 9 and DNA k = 14;
* ``enumerate_pairs_generic`` gives the original's sorted pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epik_tpu.engine import placer as jax_placer
from epik_tpu.ops import radix_lookup as jax_radix

from epik_tpu_torch.engine.tables import enumerate_pairs_generic
from epik_tpu_torch.ops import radix_lookup as radix
from epik_tpu_torch.ops.tokenize import tokenize_codes

#: (key_bits, keys drawn, allow_split, form): amino k = 8 and 9 widths, narrower ones, each form
CASES = [
    (35, 120_000, True, "lowpair"),  # amino k = 8: shift 11, spill bits in v1
    (30, 20_000, True, "lowpair"),
    (18, 4_000, True, "lowpair"),
    (30, 20_000, False, "packed"),
    (39, 5_000, True, "generic"),  # amino k = 9: shift > 16
]
IDS = [f"{c[3]}{c[0]}" for c in CASES]


def _keys(key_bits: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 1 << key_bits, n, dtype=np.uint64))


def _queries(keys: np.ndarray, key_bits: int, seed: int) -> np.ndarray:
    """Stored keys, random keys (mostly misses) and the boundary positions."""
    rng = np.random.default_rng(seed)
    return np.concatenate([keys[rng.integers(0, keys.size, 3000)],
                           rng.integers(0, 1 << key_bits, 3000, dtype=np.uint64),
                           keys[:2], keys[-2:]])


def _searchsorted_rows(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    return np.where(keys[pos] == q, pos, keys.size)


@pytest.mark.parametrize("key_bits,n,allow_split,form", CASES, ids=IDS)
def test_build_radix_equals_jax(key_bits, n, allow_split, form):
    keys = _keys(key_bits, n, key_bits)
    mine = radix.build_radix(keys, key_bits, allow_split=allow_split)
    want = jax_radix.build_radix(keys, key_bits, allow_split=allow_split)
    assert (mine.lowpair, mine.packed) == (want.lowpair, want.packed)
    assert {"lowpair": mine.lowpair, "packed": mine.packed and not mine.lowpair,
            "generic": not (mine.lowpair or mine.packed)}[form]
    assert mine.dispatch_args() == want.dispatch_args()
    for name in ("off", "low", "offc", "low2", "v1", "lp"):
        a, b = getattr(mine, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("shift", "max_bucket", "off_bits", "lp_shift", "lp_nb"):
        assert getattr(mine, name) == getattr(want, name), name
    if key_bits == 35:
        assert mine.lp_shift == 11 and 3 * mine.lp_shift > 31  # the spill bits
        assert np.bincount((keys >> np.uint64(11)).astype(np.int64)).max() == 3
    dev = radix.DeviceRadix.from_index(mine, "cpu")
    assert dev.form == form
    for got, ref in zip(mine.device_arrays("cpu"), want.device_arrays()):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("key_bits,n,allow_split,form", CASES, ids=IDS)
def test_lookup_equals_jax_and_searchsorted(key_bits, n, allow_split, form):
    """Each form's rows against the JAX function of that form (through its
    dispatch) and against the sorted keys' positions, bit for bit; the form's
    own function gives the dispatch's rows."""
    keys = _keys(key_bits, n, key_bits)
    q = _queries(keys, key_bits, key_bits + 1)
    idx = radix.build_radix(keys, key_bits, allow_split=allow_split)
    jidx = jax_radix.build_radix(keys, key_bits, allow_split=allow_split)
    shift, n_probe, off_bits = idx.dispatch_args()
    a = jnp.asarray((q >> np.uint64(16)).astype(np.uint32))
    b = jnp.asarray((q & np.uint64(0xFFFF)).astype(np.uint32))
    want = np.asarray(jax_radix.radix_lookup_dispatch(
        *jidx.device_arrays(), a, b, shift=shift, n_probe=n_probe, off_bits=off_bits,
        n_keys=keys.size))
    key_t = torch.from_numpy(q.astype(np.int64)).reshape(-1, 4)
    arr1, arr2 = idx.device_arrays("cpu")
    got = radix.radix_lookup_dispatch(arr1, arr2, key_t, shift=shift, n_probe=n_probe,
                                      off_bits=off_bits, n_keys=keys.size)
    assert got.dtype == torch.int32 and got.shape == key_t.shape
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    np.testing.assert_array_equal(want, _searchsorted_rows(keys, q))
    if form == "lowpair":
        own = radix.radix_lookup_lp(arr1, arr2, key_t, shift=idx.lp_shift, nb=idx.lp_nb,
                                    n_keys=keys.size)
    elif form == "packed":
        own = radix.radix_lookup_packed(arr1, arr2, key_t, shift=idx.shift,
                                        off_bits=idx.off_bits, n_keys=keys.size)
    else:
        own = radix.radix_lookup(arr1, arr2, key_t, shift=idx.shift, n_probe=idx.max_bucket,
                                 n_keys=keys.size)
    assert torch.equal(own, got)


@pytest.mark.parametrize("shift", [0, 4, 11, 15, 16, 19, 24])
def test_bucket_and_low_bits_equal_the_limbs(shift):
    """The int64 key's (bucket, lo) equal ``_split_bucket_lo`` of its limbs."""
    rng = np.random.default_rng(shift)
    # keys up to 2**47 whose bucket fits the JAX function's int32
    q = rng.integers(0, 1 << min(47, shift + 31), 2000, dtype=np.uint64)
    q[:2] = [0, (1 << min(47, shift + 31)) - 1]
    a = jnp.asarray((q >> np.uint64(16)).astype(np.uint32))
    b = jnp.asarray((q & np.uint64(0xFFFF)).astype(np.uint32))
    want_b, want_l = jax_radix._split_bucket_lo(a, b, shift)
    got_b, got_l = radix._split_bucket_lo(torch.from_numpy(q.astype(np.int64)), shift)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def _codes_buffer(rng, R: int, Lmax: int, sigma: int) -> tuple[np.ndarray, np.ndarray]:
    """A codes buffer: exact codes, invalid (0xFF) and ambiguity (0x80+) codes
    sprinkled in, reads of every length up to Lmax (some shorter than k),
    padding invalid, and the trailing uint16 lengths."""
    lens = rng.integers(0, Lmax + 1, R)
    lens[0], lens[1] = Lmax, 3
    codes = rng.integers(0, sigma, (R, Lmax)).astype(np.uint8)
    codes[rng.random((R, Lmax)) < 0.01] = 0xFF
    codes[rng.random((R, Lmax)) < 0.01] = 0x81
    codes[np.arange(Lmax)[None, :] >= lens[:, None]] = 0xFF
    buf = np.concatenate([codes, np.zeros((R, 2), np.uint8)], axis=1)
    buf[:, Lmax] = lens & 0xFF
    buf[:, Lmax + 1] = lens >> 8
    return buf, lens


@pytest.mark.parametrize("sigma,k,Lmax", [(20, 6, 96), (20, 8, 152), (20, 9, 96),
                                          (4, 14, 160), (4, 23, 264)])
def test_tokenize_codes_equals_jax(sigma, k, Lmax):
    buf, lens = _codes_buffer(np.random.default_rng(k), 40, Lmax, sigma)
    a, b, ok_j, lens_j = jax_placer.device_tokenize_codes(jnp.asarray(buf), k=k, sigma=sigma,
                                                          Lmax=Lmax)
    key, ok, lens_t = tokenize_codes(torch.from_numpy(buf), k=k, sigma=sigma, Lmax=Lmax)
    want = np.asarray(a).astype(np.int64) * 65536 + np.asarray(b).astype(np.int64)
    assert key.dtype == torch.int64 and key.shape == (40, Lmax - k + 1)
    np.testing.assert_array_equal(key.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(lens_t.numpy(), lens)
    assert int(key.max()) < sigma ** k and ok.any() and not ok.all()


@pytest.mark.parametrize("sigma,k", [(20, 5), (4, 14)])
def test_enumerate_pairs_generic_equals_jax(sigma, k):
    rng = np.random.default_rng(sigma + k)
    keys = np.unique(rng.integers(0, sigma ** k, 30_000 if sigma == 4 else 60_000,
                                  dtype=np.uint64))
    got = enumerate_pairs_generic(keys, k, sigma)
    want = jax_placer.enumerate_pairs_generic(keys, k, sigma)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].size > 0 and np.all(np.diff(got[2].astype(np.int64)) > 0)
