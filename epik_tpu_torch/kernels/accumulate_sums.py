"""Kernel 4: segment accumulate over (branch, score) cells, with or without counts.

* ``accumulate_sums(b, s, B=)`` -> f32 (R, B) sums: the TPU kernel
  ``epik_tpu/ops/pallas/accumulate.py::segment_accumulate_sums`` (the
  f32-payload posting-tile step);
* ``accumulate_sums_counts(b, s, B=)`` -> (f32 (R, B) sums, int32 (R, B)
  counts): the TPU kernel ``segment_accumulate`` (the CSR fallback's
  ``accumulate_exact_dense``);
* ``accumulate_sums_counts_csr(b, s, read_ptr, R=, B=)`` -> the same sums and
  counts over flat cells, read r's being ``[read_ptr[r], read_ptr[r+1])``:
  the scatter engine's ``accumulate_exact`` (``epik_tpu/engine/placer.py``
  :362), an XLA scatter-add into (R+1, B) in JAX, which adds each (read,
  branch) in cell order on the CPU.

All three run one CUDA source (``csrc/accumulate_sums.cu``) with a counts
flag and a row-pointer flag, and count their launches apart. Cells whose
branch is ``>= B`` (the trash column ``tile_width(B) - 1`` of padding cells)
add nothing to any returned column. Each sum is taken in increasing cell
order, in the kernel as in the plain version, so the two are bit-equal.

The kernel is bound by bytes: it reads each cell once and writes each sum
and count once. A block keeps one branch tile of one read in shared memory
and adds each kept cell once, in cell order, with no float atomics: the
(R, PP) forms partition the read's cells among their warps by branch; the
row-pointer form sorts each chunk of cells by branch with a stable block
radix sort and adds each branch's run in order, one block an SM taking reads
in turn, each tile written back by bulk asynchronous copies while the next
read's first chunk is loaded and sorted. The CUDA source cuts the
branch range and sizes the block itself, from the card's shared memory per
block: one tile at B = 19,999 with counts, and for the row-pointer form up
to B ~ 23,900 (4-bit sort passes past ~20,320, where 5-bit ones would take
two tiles). :func:`plan` asks it what it takes at a width.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ._build import check, library

__all__ = ["Plan", "accumulate_sums", "accumulate_sums_counts", "accumulate_sums_counts_csr",
           "accumulate_sums_counts_csr_plain", "accumulate_sums_plain", "plan"]


class Plan(NamedTuple):
    """How the kernel cuts one call: ``n_tiles`` branch tiles of ``tile_w``
    branches, one block of ``threads`` threads and ``smem`` bytes of shared
    memory per (read, tile); ``radix_bits``, the bits a pass of the
    row-pointer form's sort takes (0 for the (R, PP) forms)."""

    tile_w: int
    n_tiles: int
    threads: int
    smem: int
    radix_bits: int


def plan(B: int, counts: bool, device=None, *, row_ptr: bool = False) -> Plan:
    """The tiles and block the kernel takes at width ``B`` on ``device`` (a
    CUDA device; default the current one), as its CUDA source plans them:
    the (R, PP) forms, or ``row_ptr`` the row-pointer form (counts only),
    whose block holds its radix sort's storage beside the tile."""
    out = (ctypes.c_int * 5)()
    lib = library()
    with torch.cuda.device(device):
        err = lib.epik_accumulate_sums_layout(B, int(counts), int(row_ptr), out)
    check(err, "accumulate_sums plan")
    return Plan(*out)


_count_lock = threading.Lock()


def _cell_order_sums(read: torch.Tensor, b: torch.Tensor, s: torch.Tensor, *, R: int,
                     B: int, counts: bool):
    """Sums (and counts) of flat cells in cell order: ``read`` int64, ``b``
    and ``s`` the cells' read ids, branch ids and scores, each read's cells in
    the order they are to be added. Cells whose branch lies outside [0, B)
    add nothing. A stable sort by (read, branch) keeps each group's cells in
    cell order; round j then adds every group's j-th cell, one plain f32 add
    per (read, branch), so the sums come out in cell order."""
    dev = b.device
    keep = (b >= 0) & (b < B)
    key = read[keep] * B + b[keep].long()
    val = s[keep]
    key, order = torch.sort(key, stable=True)
    val = val[order]
    m = key.numel()
    S = torch.zeros(R * B, dtype=torch.float32, device=dev)
    if m:
        pos = torch.arange(m, dtype=torch.int64, device=dev)
        new = torch.ones(m, dtype=torch.bool, device=dev)
        new[1:] = key[1:] != key[:-1]
        rank = pos - torch.cummax(torch.where(new, pos, 0), 0).values
        for j in range(int(rank.max()) + 1):
            sel = rank == j
            k_j = key[sel]
            S[k_j] = S[k_j] + val[sel]
    S = S.view(R, B)
    if not counts:
        return S
    C = torch.bincount(key, minlength=R * B).to(torch.int32).view(R, B)
    return S, C


def accumulate_sums_plain(b: torch.Tensor, s: torch.Tensor, *, B: int,
                          counts: bool = False):
    """Plain version: each row's cells summed in cell order
    (:func:`_cell_order_sums`). Returns S, or (S, C)."""
    R, PP = b.shape
    read = torch.arange(R, dtype=torch.int64, device=b.device).repeat_interleave(PP)
    return _cell_order_sums(read, b.reshape(-1), s.reshape(-1), R=R, B=B, counts=counts)


def accumulate_sums_counts_csr_plain(b: torch.Tensor, s: torch.Tensor,
                                     read_ptr: torch.Tensor, *, R: int, B: int):
    """Plain version of the row-pointer form: read r's cells are
    ``[read_ptr[r], read_ptr[r+1])`` of the flat ``b``/``s``, summed in cell
    order. Reads the row pointer on the host. Returns (S, C)."""
    lo, hi = int(read_ptr[0]), int(read_ptr[R])
    lens = (read_ptr[1:] - read_ptr[:-1]).to(torch.int64)
    read = torch.arange(R, dtype=torch.int64, device=b.device).repeat_interleave(lens)
    return _cell_order_sums(read, b[lo:hi], s[lo:hi], R=R, B=B, counts=True)


def _check_args(b: torch.Tensor, s: torch.Tensor, B: int) -> None:
    if b.dtype != torch.int32 or b.dim() != 2 or not b.is_contiguous():
        raise ValueError(f"b must be contiguous 2-D int32, got {b.dtype} "
                         f"{tuple(b.shape)}")
    if s.dtype != torch.float32 or s.shape != b.shape or not s.is_contiguous():
        raise ValueError(f"s must be contiguous float32 {tuple(b.shape)}, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if b.device != s.device:
        raise ValueError(f"b on {b.device} but s on {s.device}")
    if B < 1:
        raise ValueError(f"B={B} must be >= 1")


def _launch(b: torch.Tensor, s: torch.Tensor, B: int, counts: bool):
    R, PP = b.shape
    S = torch.empty((R, B), dtype=torch.float32, device=b.device)
    C = torch.empty((R, B), dtype=torch.int32, device=b.device) if counts else None
    if R == 0:
        return S, C
    lib = library()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        err = lib.epik_accumulate_sums(
            b.data_ptr(), s.data_ptr(), S.data_ptr(),
            C.data_ptr() if counts else None, R, PP, B, int(counts), stream)
    check(err, "accumulate_sums_counts" if counts else "accumulate_sums")
    return S, C


def _check_csr_args(b: torch.Tensor, s: torch.Tensor, read_ptr: torch.Tensor, R: int,
                    B: int) -> None:
    if b.dtype != torch.int32 or b.dim() != 1 or not b.is_contiguous():
        raise ValueError(f"b must be contiguous 1-D int32, got {b.dtype} "
                         f"{tuple(b.shape)}")
    if s.dtype != torch.float32 or s.shape != b.shape or not s.is_contiguous():
        raise ValueError(f"s must be contiguous float32 {tuple(b.shape)}, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if (read_ptr.dtype != torch.int64 or read_ptr.shape != (R + 1,)
            or not read_ptr.is_contiguous()):
        raise ValueError(f"read_ptr must be contiguous int64 ({R + 1},), got "
                         f"{read_ptr.dtype} {tuple(read_ptr.shape)}")
    if not b.device == s.device == read_ptr.device:
        raise ValueError(f"b on {b.device}, s on {s.device}, read_ptr on {read_ptr.device}")
    if R < 0 or B < 1:
        raise ValueError(f"R={R} must be >= 0 and B={B} >= 1")


def accumulate_sums(b: torch.Tensor, s: torch.Tensor, *, B: int) -> torch.Tensor:
    """b int32 (R, PP) branch ids, s f32 (R, PP) scores -> f32 (R, B) sums."""
    _check_args(b, s, B)
    if b.device.type == "cpu":
        return accumulate_sums_plain(b, s, B=B)
    if b.device.type != "cuda":
        raise ValueError(f"accumulate_sums: no kernel for device {b.device}")
    S, _ = _launch(b, s, B, counts=False)
    with _count_lock:
        accumulate_sums.launches += 1
    return S


def accumulate_sums_counts(b: torch.Tensor, s: torch.Tensor, *, B: int):
    """As :func:`accumulate_sums`, plus int32 (R, B) cell counts."""
    _check_args(b, s, B)
    if b.device.type == "cpu":
        return accumulate_sums_plain(b, s, B=B, counts=True)
    if b.device.type != "cuda":
        raise ValueError(f"accumulate_sums_counts: no kernel for device {b.device}")
    S, C = _launch(b, s, B, counts=True)
    with _count_lock:
        accumulate_sums_counts.launches += 1
    return S, C


def accumulate_sums_counts_csr(b: torch.Tensor, s: torch.Tensor, read_ptr: torch.Tensor, *,
                               R: int, B: int):
    """Flat cells ``b`` int32 (P,) and ``s`` f32 (P,), with ``read_ptr`` int64
    (R+1,) nondecreasing offsets into them (read r's cells are
    ``[read_ptr[r], read_ptr[r+1])``, each read below 2**31 cells) -> (S f32
    (R, B), C int32 (R, B)), each sum taken in cell order. The kernel reads
    the row pointer on the card: the wrapper does not check its values."""
    _check_csr_args(b, s, read_ptr, R, B)
    if b.device.type == "cpu":
        return accumulate_sums_counts_csr_plain(b, s, read_ptr, R=R, B=B)
    if b.device.type != "cuda":
        raise ValueError(f"accumulate_sums_counts_csr: no kernel for device {b.device}")
    S = torch.empty((R, B), dtype=torch.float32, device=b.device)
    C = torch.empty((R, B), dtype=torch.int32, device=b.device)
    if R > 0:
        lib = library()
        with torch.cuda.device(b.device):
            stream = torch.cuda.current_stream(b.device).cuda_stream
            err = lib.epik_accumulate_sums_csr(b.data_ptr(), s.data_ptr(), read_ptr.data_ptr(),
                                               S.data_ptr(), C.data_ptr(), R, B, stream)
        check(err, "accumulate_sums_counts_csr")
        with _count_lock:
            accumulate_sums_counts_csr.launches += 1
    return S, C


#: kernel launches since the last reset (CUDA only; the plain path never counts)
accumulate_sums.launches = 0
accumulate_sums_counts.launches = 0
accumulate_sums_counts_csr.launches = 0
