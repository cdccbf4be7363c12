"""Kernel 4: segment accumulate over (branch, score) cells, with or without counts.

* ``accumulate_sums(b, s, B=)`` -> f32 (R, B) sums: the TPU kernel
  ``epik_tpu/ops/pallas/accumulate.py::segment_accumulate_sums`` (the
  f32-payload posting-tile step);
* ``accumulate_sums_counts(b, s, B=)`` -> (f32 (R, B) sums, int32 (R, B)
  counts): the TPU kernel ``segment_accumulate`` (the CSR fallback's
  ``accumulate_exact_dense``).

Both run one CUDA source (``csrc/accumulate_sums.cu``) with a counts flag and
count their launches apart. Cells whose branch is ``>= B`` (the trash column
``tile_width(B) - 1`` of padding cells) add nothing to any returned column.
Each sum is taken in increasing cell order, in the kernel as in the plain
version, so the two are bit-equal.

The kernel is bound by bytes: it reads each cell once and writes each sum
and count once. A block keeps one branch tile of one read in shared memory
and partitions the read's cells among its warps by branch, so that each
kept cell is added once, in cell order, with no float atomics. The CUDA
source cuts the branch range and sizes the block itself, from the card's
shared memory per block: one tile at B = 19,999 with counts.
:func:`plan` asks it what it takes at a width.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ._build import check, library

__all__ = ["Plan", "accumulate_sums", "accumulate_sums_counts", "accumulate_sums_plain",
           "plan"]


class Plan(NamedTuple):
    """How the kernel cuts one call: ``n_tiles`` branch tiles of ``tile_w``
    branches, one block of ``threads`` threads and ``smem`` bytes of shared
    memory per (read, tile)."""

    tile_w: int
    n_tiles: int
    threads: int
    smem: int


def plan(B: int, counts: bool, device=None) -> Plan:
    """The tiles and block the kernel takes at width ``B`` on ``device`` (a
    CUDA device; default the current one), as its CUDA source plans them."""
    out = (ctypes.c_int * 4)()
    lib = library()
    with torch.cuda.device(device):
        err = lib.epik_accumulate_sums_layout(B, int(counts), out)
    check(err, "accumulate_sums plan")
    return Plan(*out)


_count_lock = threading.Lock()


def accumulate_sums_plain(b: torch.Tensor, s: torch.Tensor, *, B: int,
                          counts: bool = False):
    """Plain version: one column at a time, vectorised over the reads. A
    read's cells of one column hit one branch, so each add is a plain f32
    add and the sums come out in cell order. Returns S, or (S, C)."""
    R, PP = b.shape
    width = max(B, int(b.max()) + 1) if b.numel() else B
    base = torch.arange(R, dtype=torch.int64, device=b.device) * width
    S = torch.zeros(R * width, dtype=torch.float32, device=b.device)
    C = torch.zeros(R * width, dtype=torch.int32, device=b.device) if counts else None
    ones = torch.ones(R, dtype=torch.int32, device=b.device)
    for c in range(PP):
        idx = base + b[:, c].long()
        S.index_add_(0, idx, s[:, c])
        if counts:
            C.index_add_(0, idx, ones)
    S = S.view(R, width)[:, :B]
    return (S, C.view(R, width)[:, :B]) if counts else S


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


#: kernel launches since the last reset (CUDA only; the plain path never counts)
accumulate_sums.launches = 0
accumulate_sums_counts.launches = 0
