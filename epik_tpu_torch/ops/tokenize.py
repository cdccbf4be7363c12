"""On-device window tokenizers, as torch ops.

Ports ``epik_tpu/engine/placer.py::_tokenize_core`` (:923),
``device_tokenize_packed`` (:903, the posting-tile path) and
``device_tokenize_combo`` (:1038, the pair-plane path) with the same slot
layout, the same miss index and the same odd-tail padding, and
``device_tokenize_codes`` (:1269, the generic-alphabet path) with the radix
lookups of ``_place_batch_dense_codes`` (:1306) and
``_place_batch_dense_codes_paired`` (:1372). Keys are built in int64 (torch
covers few ops for uint32): 4**(k+1) <= 4**13, and sigma**k < 2**48 on the
codes path, fit with room to spare.
"""

from __future__ import annotations

import torch

from .radix_lookup import DeviceRadix

__all__ = ["tokenize_codes", "tokenize_combo", "tokenize_core", "tokenize_packed",
           "tokenize_radix", "tokenize_radix_paired"]


def tokenize_core(buf: torch.Tensor, *, k: int, Lmax: int):
    """Unpack the packed read buffer (``staging.pack_reads``) into window
    keys and validity.

    Returns (key (R, W) int64, ok (R, W) bool, codes (R, Lmax) int64,
    lens (R,) int32) with W = Lmax - k + 1."""
    R = buf.shape[0]
    L4, L8 = Lmax // 4, Lmax // 8
    dev = buf.device
    c2 = buf[:, :L4].to(torch.int32)
    bb = buf[:, L4 : L4 + L8].to(torch.int32)
    lens = buf[:, L4 + L8].to(torch.int32) + 256 * buf[:, L4 + L8 + 1].to(torch.int32)
    sh2 = torch.arange(0, 8, 2, dtype=torch.int32, device=dev)
    sh1 = torch.arange(8, dtype=torch.int32, device=dev)
    codes = ((c2[:, :, None] >> sh2) & 3).reshape(R, Lmax).to(torch.int64)
    bad = ((bb[:, :, None] >> sh1) & 1).reshape(R, Lmax)
    W = Lmax - k + 1
    key = torch.zeros((R, W), dtype=torch.int64, device=dev)
    for j in range(k):
        key = key * 4 + codes[:, j : j + W]
    # window is exact iff all k characters are exact: sliding sum of the
    # bad indicator via an exclusive cumsum difference
    cs = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(bad, dim=1)], dim=1)
    ok = (cs[:, k : k + W] - cs[:, :W]) == 0
    return key, ok, codes, lens


def tokenize_packed(buf: torch.Tensor, direct: torch.Tensor, *, k: int, Lmax: int,
                    num_kmers: int):
    """One row per window through the direct-address table ``direct``
    (4**k int32 key -> row; on the tiles path the permuted table of the tile
    build). Windows holding any non-exact character take the miss row
    ``num_kmers``.

    Returns (rows (R, W) int32, lens (R,) int32)."""
    key, ok, _, lens = tokenize_core(buf, k=k, Lmax=Lmax)
    rows = torch.where(ok, direct[key], num_kmers)
    return rows.to(torch.int32), lens


def _pad_cols(x: torch.Tensor, width: int, value) -> torch.Tensor:
    """Right-pad the columns of ``x`` to ``width`` with ``value``."""
    extra = width - x.shape[1]
    if extra == 0:
        return x
    pad = torch.full((x.shape[0], extra), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def tokenize_combo(buf: torch.Tensor, combo: torch.Tensor, *, k: int, Lmax: int):
    """Paired tokenizer with the unified combo table: ONE element gather per
    2-window slot (see ``tables.build_combo_table``).

    Returns (slot_rows (R, ceil(W/2)) int32, lens (R,) int32). The JAX
    version's ``num_kmers`` argument is dropped: the combo table holds the
    miss row itself."""
    key, ok, c, lens = tokenize_core(buf, k=k, Lmax=Lmax)
    R, W = key.shape
    Wp = (W + 1) // 2
    n11 = 4 ** (k + 1)
    miss_idx = 4 ** (k + 1) + 4**k
    # per-slot pieces (slot j = windows 2j, 2j+1); pad the odd tail
    keyp = _pad_cols(key, 2 * Wp, 0)
    okp2 = _pad_cols(ok, 2 * Wp, False)
    kp = keyp[:, 0::2]
    ks = keyp[:, 1::2]
    op = okp2[:, 0::2]
    os_ = okp2[:, 1::2]
    if W >= 2:
        key11 = key[:, : W - 1] * 4 + c[:, k : k + W - 1]
        ok11 = ok[:, : W - 1] & ok[:, 1:]
        k11 = _pad_cols(key11, 2 * Wp - 1, 0)[:, 0::2]
        o11 = _pad_cols(ok11, 2 * Wp - 1, False)[:, 0::2]
    else:
        k11 = torch.zeros((R, Wp), dtype=torch.int64, device=buf.device)
        o11 = torch.zeros((R, Wp), dtype=torch.bool, device=buf.device)
    fb_key = torch.where(op, kp, ks)
    fb_ok = op | os_
    idx = torch.where(o11, k11, torch.where(fb_ok, n11 + fb_key,
                                            torch.full_like(fb_key, miss_idx)))
    rows = combo[idx]
    return rows.contiguous(), lens


def tokenize_codes(buf: torch.Tensor, *, k: int, sigma: int, Lmax: int):
    """Window keys of a codes buffer (the generic-alphabet path).

    ``buf``: (R, Lmax + 2) uint8 -- alphabet codes (exact < ``sigma``, every
    other code invalidates its windows) and a trailing little-endian uint16
    read length. The key of a window is its k codes in base ``sigma``, the
    JAX version's two uint32 limbs ``a * 2**16 + b`` in one int64; a window
    is valid iff it holds no invalid code (an exclusive cumsum of
    ``codes >= sigma``).

    Returns (key (R, W) int64, ok (R, W) bool, lens (R,) int32) with
    W = Lmax - k + 1."""
    R = buf.shape[0]
    dev = buf.device
    codes = buf[:, :Lmax].to(torch.int64)
    lens = buf[:, Lmax].to(torch.int32) + 256 * buf[:, Lmax + 1].to(torch.int32)
    bad = codes >= sigma
    c = torch.where(bad, 0, codes)
    W = Lmax - k + 1
    key = torch.zeros((R, W), dtype=torch.int64, device=dev)
    for j in range(k):
        key = key * sigma + c[:, j : j + W]
    cs = torch.cat([torch.zeros((R, 1), dtype=torch.int64, device=dev),
                    torch.cumsum(bad, dim=1)], dim=1)
    ok = (cs[:, k : k + W] - cs[:, :W]) == 0
    return key, ok, lens


def tokenize_radix(buf: torch.Tensor, radix: DeviceRadix, *, k: int, sigma: int, Lmax: int,
                   num_kmers: int):
    """One plane row per window of a codes buffer: the window keys of
    :func:`tokenize_codes` through the radix index; a miss and a window
    holding an invalid code take the zero row ``num_kmers``.

    Returns (rows (R, W) int32, lens (R,) int32)."""
    key, ok, lens = tokenize_codes(buf, k=k, sigma=sigma, Lmax=Lmax)
    rows = torch.where(ok, radix.lookup(key, num_kmers), num_kmers)
    return rows, lens


def tokenize_radix_paired(buf: torch.Tensor, radix: DeviceRadix, pair_radix: DeviceRadix, *,
                          k: int, sigma: int, Lmax: int, num_kmers: int, n_pairs: int):
    """One plane row per 2-window slot over the codes pair plane: slot j
    takes pair row ``num_kmers + 1 + p`` when windows 2j and 2j+1 are both
    valid and their (k+1)-mer is the p-th pair key, else the first hitting
    window's row of the two (at most one hits: every suffix extension of
    every key is a pair), else the zero row. The (k+1)-mer keys are built
    for the even slots only, from the k-mer keys and one more code; an odd
    W leaves a last slot with one window.

    Returns (slot_rows (R, ceil(W/2)) int32, lens (R,) int32)."""
    key, ok, lens = tokenize_codes(buf, k=k, sigma=sigma, Lmax=Lmax)
    rows = torch.where(ok, radix.lookup(key, num_kmers), num_kmers)
    W = rows.shape[1]
    Wp = (W + 1) // 2
    rows_p = _pad_cols(rows, 2 * Wp, num_kmers)
    r1, r2 = rows_p[:, 0::2], rows_p[:, 1::2]
    single = torch.where(r1 != num_kmers, r1, r2)
    nf = W // 2  # slots holding two windows
    if nf == 0:
        return single, lens
    c = buf[:, k : k + 2 * nf : 2].to(torch.int64)
    key11 = key[:, 0 : 2 * nf : 2] * sigma + torch.where(c >= sigma, 0, c)
    ok11 = ok[:, 0 : 2 * nf : 2] & ok[:, 1 : 2 * nf : 2]
    pidx = pair_radix.lookup(key11, n_pairs)
    prow = torch.where(ok11 & (pidx < n_pairs), num_kmers + 1 + pidx, single[:, :nf])
    return torch.cat([prow, single[:, nf:]], dim=1), lens
