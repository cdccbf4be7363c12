"""Host-side batch staging, copied as numpy from ``epik_tpu/engine/placer.py``:
``_bucket``/``_bucket_lmax`` (:163-179), ``pack_reads`` (:882), the staging
helpers ``_pad_u64_split``/``_key_matrix``/``_pad_i32`` (:2310-2335) and the parts of
``HostStaging`` (:1598-1735) that the ported paths use.

One difference: the JAX package asks ``native_available()``, which never
builds the native host library; here :meth:`HostStaging._native` calls
``load_native()`` once, so the library is built when it is missing. Without
it (no compiler, or a library that does not load) the numpy paths run: they
are host code computing the same arrays, not a device fallback.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from ..core.kmers import BatchTokens, tokenize_batch

__all__ = ["HostStaging", "_bucket", "_bucket_lmax", "key_matrix", "pack_reads",
           "pad_i32", "pad_u64_split", "wrapped_m"]

#: padding key of the CSR step's key stream: never a real key, always a miss
SENTINEL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _bucket(n: int, lo: int) -> int:
    """Round up to a power of two (bounded jit-cache growth)."""
    return 1 << max(lo.bit_length() - 1, (max(n, 1) - 1).bit_length())


def _bucket_lmax(lmax_true: int) -> int:
    """Bucketed padded read length.

    Short reads (the reference's amplicon/Illumina regime) keep the tight
    8-multiple.  Long reads (nanopore, 2-10 kb) use a granularity of 1/16 of
    the magnitude (<= 12.5% window padding)."""
    if lmax_true <= 512:
        return -(-lmax_true // 8) * 8
    gran = 1 << (lmax_true.bit_length() - 4)
    return -(-lmax_true // gran) * gran


def wrapped_m(m_signed: np.ndarray) -> np.ndarray:
    """The correction term's window count as f32, size_t-wrapped (quirk Q1):
    float32(2**64 - small) == float32(2**64), so the wrap collapses."""
    return np.where(
        m_signed >= 0, m_signed.astype(np.float32),
        np.float32(float(1 << 64)) + m_signed.astype(np.float32),
    ).astype(np.float32)


def pack_reads(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Host half of the packed read upload (DNA fast path).

    ``codes``: (R, Lmax) uint8 alphabet codes (exact < 4, others non-exact;
    0-padding bytes map to the invalid code), Lmax a multiple of 8.
    Packs 2 bits/char + 1 bad-bit/char + a uint16 length per read into ONE
    (R, Lmax//4 + Lmax//8 + 2) uint8 buffer."""
    R, L = codes.shape
    ex = codes < 4
    c = np.where(ex, codes, 0).astype(np.uint8)
    c2 = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
          | (c[:, 3::4] << 6))
    bb = np.packbits(~ex, axis=1, bitorder="little")
    ll = np.empty((R, 2), np.uint8)
    ll[:, 0] = lens & 0xFF
    ll[:, 1] = lens >> 8
    return np.concatenate([c2, bb, ll], axis=1)


def pad_u64_split(keys: np.ndarray, size: int):
    """uint64 keys padded to ``size`` with the sentinel key, split into
    (hi, lo) uint32 halves."""
    padded = np.full(size, SENTINEL_KEY, dtype=np.uint64)
    padded[: keys.shape[0]] = keys
    hi = (padded >> np.uint64(32)).astype(np.uint32)
    lo = (padded & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def key_matrix(keys: np.ndarray, read: np.ndarray, R: int, width: int):
    """(R, width) per-read key matrix in processing order, sentinel-padded,
    split into (hi, lo) uint32 halves (``JaxPlacer._key_matrix``)."""
    M = np.full((R, width), SENTINEL_KEY, dtype=np.uint64)
    if keys.size:
        counts = np.bincount(read, minlength=R)
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        cols = np.arange(keys.shape[0]) - starts[read]
        M[read, cols] = keys
    hi = (M >> np.uint64(32)).astype(np.uint32)
    lo = (M & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def pad_i32(arr: np.ndarray, size: int, fill: int) -> np.ndarray:
    padded = np.full(size, fill, dtype=np.int32)
    padded[: arr.shape[0]] = arr
    return padded


class HostStaging:
    """Host-side batch staging: read packing, the host tokenizer for
    ambiguous reads, and key -> plane row resolution.

    Requires attributes: ``db``, ``k``, ``alphabet``, ``config``."""

    def _init_staging(self):
        self._lazy_lock = threading.Lock()
        self._native_lib = None  # resolved on first use
        self._native_tried = False
        self._tok_pool = None

    def _native(self):
        """The native host library, built if missing; None when unusable."""
        if not self._native_tried:
            with self._lazy_lock:
                if not self._native_tried:
                    try:
                        self._native_lib = native.load_native()
                    except OSError:  # a library that this host cannot load
                        self._native_lib = None
                    self._native_tried = True
        return self._native_lib

    def _pack_reads_fast(self, seqs, lens_arr, Lmax: int, R: int):
        """(packed buf, amb_mask) via the native one-pass stager when built,
        else the numpy path."""
        if self._native() is not None:
            return native.native_pack_reads(seqs, lens_arr, self.alphabet, Lmax, R)
        R_true = len(seqs)
        flat = np.frombuffer(b"".join(seqs), np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens_arr)])
        mat = np.zeros((R, Lmax), np.uint8)
        mat[np.repeat(np.arange(R_true), lens_arr),
            np.arange(flat.size) - np.repeat(starts[:-1], lens_arr)] = flat
        codes = self.alphabet.char_code[mat]
        amb_mask = ((codes >= 0x80) & (codes != 0xFF)).any(axis=1)[:R_true]
        lens_pad = np.zeros(R, np.int64)
        lens_pad[:R_true] = lens_arr
        return pack_reads(codes, lens_pad), amb_mask

    def _tokenize(self, seqs):
        """Native C++ tokenizer when built; numpy single-pass otherwise.

        With ``config.host_threads > 1`` the batch splits into chunks
        tokenized concurrently (ctypes releases the GIL during the C call)
        and the streams are re-merged with read ids offset."""
        tok = native.native_tokenize_batch if self._native() is not None else tokenize_batch
        nt = self.config.host_threads
        if nt <= 1 or len(seqs) < 2 * nt:
            return tok(seqs, self.k, self.alphabet)
        chunk = -(-len(seqs) // nt)
        parts = [seqs[i : i + chunk] for i in range(0, len(seqs), chunk)]
        outs = list(self._pool(nt).map(lambda p: tok(p, self.k, self.alphabet), parts))
        off = 0
        e_keys, e_read, a_keys, a_read, a_order = [], [], [], [], []
        for t in outs:
            e_keys.append(t.exact_keys)
            e_read.append(t.exact_read + off)
            a_keys.append(t.amb_keys)
            a_read.append(t.amb_read + off)
            a_order.append(t.amb_order)
            off += t.num_reads
        cat = np.concatenate
        return BatchTokens(
            num_reads=off,
            num_windows=cat([t.num_windows for t in outs]),
            seq_lengths=cat([t.seq_lengths for t in outs]),
            exact_keys=cat(e_keys) if e_keys else np.empty(0, np.uint64),
            exact_read=cat(e_read).astype(np.int32),
            amb_keys=cat(a_keys) if a_keys else np.empty(0, np.uint64),
            amb_read=cat(a_read).astype(np.int32),
            amb_order=cat(a_order).astype(np.int32),
        )

    def _pool(self, nt: int) -> ThreadPoolExecutor:
        if self._tok_pool is None:
            with self._lazy_lock:
                if self._tok_pool is None:
                    self._tok_pool = ThreadPoolExecutor(max_workers=nt)
        return self._tok_pool

    def _host_rows(self, keys: np.ndarray) -> np.ndarray:
        """Resolve keys -> dense plane row indices on the host: binary search
        over the sorted key array; misses map to the zero row n_keys."""
        dbk = self.db.keys
        n = dbk.shape[0]
        if keys.size == 0:
            return np.empty(0, np.int32)
        nt = max(1, self.config.host_threads)
        if nt > 1 and keys.size >= 1 << 16:
            chunk = -(-keys.size // nt)
            parts = [keys[i : i + chunk] for i in range(0, keys.size, chunk)]
            # np.searchsorted releases the GIL, so chunks run concurrently
            idx = np.concatenate(
                list(self._pool(nt).map(lambda q: np.searchsorted(dbk, q), parts))
            )
        else:
            idx = np.searchsorted(dbk, keys)
        idx_c = np.minimum(idx, n - 1)
        return np.where(dbk[idx_c] == keys, idx_c, n).astype(np.int32)

    def _amb_rows(self, seqs, amb_mask: np.ndarray, R: int):
        """The ambiguous first-hit rows of the device-tokenizer steps (quirks
        Q6/Q7): the reads of ``amb_mask`` host-tokenized, their ambiguous keys
        as an (R, Amax) plane-row matrix in processing order. Returns (arows,
        Amax); Amax is 0, an (R, 0) matrix, when no read holds an ambiguous
        key."""
        if not amb_mask.any():
            return np.zeros((R, 0), np.int32), 0
        idxs = np.flatnonzero(amb_mask)
        tok = self._tokenize([seqs[i] for i in idxs])
        if not tok.amb_keys.size:
            return np.zeros((R, 0), np.int32), 0
        a_read = idxs[tok.amb_read]
        Amax = _bucket(int(np.bincount(a_read, minlength=R).max()), 8)
        return self._rows_matrix(tok.amb_keys, a_read, R, Amax), Amax

    def _rows_matrix(self, keys: np.ndarray, read: np.ndarray, R: int, width: int):
        """(R, width) per-read plane-row matrix in processing order; padding
        slots hold the all-zero row index."""
        zero_row = self.db.keys.shape[0]
        M = np.full((R, width), zero_row, dtype=np.int32)
        if keys.size:
            rows = self._host_rows(keys)
            counts = np.bincount(read, minlength=R)
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            cols = np.arange(keys.shape[0]) - starts[read]
            M[read, cols] = rows
        return M
