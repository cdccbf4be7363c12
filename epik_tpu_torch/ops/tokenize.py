"""On-device window tokenizers, as torch ops.

Ports ``epik_tpu/engine/placer.py::_tokenize_core`` (:923),
``device_tokenize_packed`` (:903, the posting-tile path) and
``device_tokenize_combo`` (:1038, the pair-plane path) with the same slot
layout, the same miss index and the same odd-tail padding. Keys are built in
int64 (torch covers few ops for uint32); 4**(k+1) <= 4**13 fits with room to
spare.
"""

from __future__ import annotations

import torch

__all__ = ["tokenize_combo", "tokenize_core", "tokenize_packed"]


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
