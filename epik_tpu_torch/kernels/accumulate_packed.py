"""Kernel 3: packed posting-tile accumulate, fused with the placement finish or alone.

``accumulate_packed_topk(p, m_f32, B=, K=, k=, log_eps=, scale=)`` computes
what the TPU kernel ``epik_tpu/ops/pallas/accumulate.py::
segment_accumulate_packed_topk`` computes on the big-tree path: per read, the
exact integer sums ``Sq[b]`` of ``q`` over the cells ``(branch << 16) | q``
of branch ``b``, then ``Sp = Sq / scale`` and the finish into the slim pack
``[scores K | idx K | log_sum | n | zero_sum]``, float32 (R, 2K+3).

``csrc/accumulate_packed_topk.cu`` records the design: persistent blocks, and
a finish over the branches each read touches only. Its sums are integers, so
they do not depend on the order of the adds; the finish is the one of
``finish_topk`` (``csrc/finish_row.cuh``), so the pack is bit-equal to the
plain version below.

``accumulate_packed_sums(p, B=)`` computes the sums alone, as float32 (R, B):
what the TPU kernel ``segment_accumulate_packed`` computes on the
column-sharded tile step (``epik_tpu/parallel/sharding.py::
_sharded_tiles_bytes_step``), whose finish merges the shards outside the
kernel. Its CUDA kernel is the first half of the fused one, with the sums
written out; they are integers below 2**24, so the f32 output is exact and
bit-equal to the plain version.
"""

from __future__ import annotations

import math
import threading

import torch

from ._build import check, library
from .finish import MAX_K, finish_topk_plain

__all__ = ["MAX_PACKED_BRANCHES", "accumulate_packed_sums", "accumulate_packed_topk",
           "accumulate_packed_topk_plain", "packed_sums_plain", "tile_width"]

#: the packed cell holds the branch id in 15 bits (the cell stays >= 0)
MAX_PACKED_BRANCHES = 1 << 15

_count_lock = threading.Lock()


def tile_width(B: int) -> int:
    """The TPU kernels' padded branch width: B + 1 rounded up to 128. Its
    last column, ``tile_width(B) - 1``, is the trash branch of padding cells
    (``epik_tpu/ops/pallas/accumulate.py::trash_branch``)."""
    return -(-(B + 1) // 128) * 128


def packed_sums_plain(p: torch.Tensor, B: int) -> torch.Tensor:
    """Exact int64 sums ``Sq`` (R, B) of the packed cells ``p`` int32 (R, PP):
    ``q = p & 0xFFFF`` added at column ``p >> 16``; the trash column is
    sliced away."""
    Sq = torch.zeros((p.shape[0], tile_width(B)), dtype=torch.int64, device=p.device)
    Sq.scatter_add_(1, (p >> 16).long(), (p & 0xFFFF).long())
    return Sq[:, :B]


def accumulate_packed_topk_plain(p: torch.Tensor, m_f32: torch.Tensor, *, B: int,
                                 K: int, k: int, log_eps: float,
                                 scale: float) -> torch.Tensor:
    """Plain version: the integer sums, one f32 divide by ``scale`` (a 0-dim
    tensor on the same device: PyTorch's CUDA divide by a CPU scalar
    multiplies by the reciprocal), then ``finish_topk_plain``."""
    scale_t = torch.tensor(scale, dtype=torch.float32, device=p.device)
    Sp = packed_sums_plain(p, B).to(torch.float32) / scale_t
    return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def _check_args(p: torch.Tensor, m_f32: torch.Tensor, B: int, K: int,
                scale: float) -> None:
    if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
        raise ValueError(f"p must be contiguous 2-D int32, got {p.dtype} "
                         f"{tuple(p.shape)}")
    if (m_f32.dtype != torch.float32 or m_f32.shape != (p.shape[0],)
            or not m_f32.is_contiguous()):
        raise ValueError(f"m_f32 must be contiguous float32 ({p.shape[0]},), "
                         f"got {m_f32.dtype} {tuple(m_f32.shape)}")
    if p.device != m_f32.device:
        raise ValueError(f"p on {p.device} but m_f32 on {m_f32.device}")
    if tile_width(B) - 1 >= MAX_PACKED_BRANCHES:
        raise ValueError(f"B={B}: packed cells need branch ids < 2**15 "
                         f"(padded width {tile_width(B)})")
    if not 1 <= K <= min(MAX_K, B):
        raise ValueError(f"K={K} must lie in [1, min({MAX_K}, B={B})]")
    # a touched branch (q >= 1) must keep Sp = Sq / scale > 0
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"scale={scale} must be finite and positive")


def accumulate_packed_topk(p: torch.Tensor, m_f32: torch.Tensor, *, B: int, K: int,
                           k: int, log_eps: float, scale: float,
                           return_sums: bool = False):
    """p int32 (R, PP) packed cells (trash cells ``(tile_width(B)-1) << 16``),
    m_f32 f32 (R,) window counts -> f32 (R, 2K+3) slim pack; with
    ``return_sums`` also the integer sums Sq (R, B) (int32 from the kernel,
    int64 from the plain version), to check them."""
    _check_args(p, m_f32, B, K, scale)
    if p.device.type == "cpu":
        pack = accumulate_packed_topk_plain(p, m_f32, B=B, K=K, k=k,
                                            log_eps=log_eps, scale=scale)
        return (pack, packed_sums_plain(p, B)) if return_sums else pack
    if p.device.type != "cuda":
        raise ValueError(f"accumulate_packed_topk: no kernel for device {p.device}")
    R, PP = p.shape
    out = torch.empty((R, 2 * K + 3), dtype=torch.float32, device=p.device)
    sq = (torch.empty((R, B), dtype=torch.int32, device=p.device) if return_sums
          else None)
    if R > 0:
        lib = library()
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            err = lib.epik_accumulate_packed_topk(
                p.data_ptr(), m_f32.data_ptr(), out.data_ptr(),
                sq.data_ptr() if return_sums else None, R, PP, B, K, k,
                float(log_eps), float(scale), stream)
        check(err, "accumulate_packed_topk")
        with _count_lock:
            accumulate_packed_topk.launches += 1
    return (out, sq) if return_sums else out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
accumulate_packed_topk.launches = 0


def accumulate_packed_sums(p: torch.Tensor, *, B: int) -> torch.Tensor:
    """p int32 (R, PP) packed cells (trash cells ``(tile_width(B)-1) << 16``)
    -> f32 (R, B) exact integer sums of q per (read, branch)."""
    if p.dtype != torch.int32 or p.dim() != 2 or not p.is_contiguous():
        raise ValueError(f"p must be contiguous 2-D int32, got {p.dtype} "
                         f"{tuple(p.shape)}")
    if B < 1 or tile_width(B) - 1 >= MAX_PACKED_BRANCHES:
        raise ValueError(f"B={B}: packed cells need 1 <= B and branch ids < 2**15 "
                         f"(padded width {tile_width(B)})")
    if p.device.type == "cpu":
        return packed_sums_plain(p, B).to(torch.float32)
    if p.device.type != "cuda":
        raise ValueError(f"accumulate_packed_sums: no kernel for device {p.device}")
    R, PP = p.shape
    out = torch.empty((R, B), dtype=torch.float32, device=p.device)
    if R > 0:
        lib = library()
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            err = lib.epik_accumulate_packed_sums(p.data_ptr(), out.data_ptr(), R, PP, B,
                                                  stream)
        check(err, "accumulate_packed_sums")
        with _count_lock:
            accumulate_packed_sums.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
accumulate_packed_sums.launches = 0
