"""Kernel 1: row gather + sum, ``Sp[r] = sum_w plane[rows[r, w]]``, alone or
with the placement finish fused into it.

Replaces the TPU kernel ``epik_tpu/ops/pallas/rowgather_mq.py::
rowgather_sum_mq`` (the function of ``engine/placer.py::dense_sums_shifted``).
On the H100 it is bound by HBM bytes: each window slot reads one plane row of
``bw * 4`` bytes. The CUDA source (``csrc/rowgather_sum.cu``) says how its
design meets that.

* :func:`rowgather_sum` -- the (R, bw) sums;
* :func:`rowgather_sum_topk` -- the dense main path's whole device step after
  the tokenizer: the sums, each ambiguous read's first-hit delta row added,
  and the finish of ``finish_topk`` into the slim (R, 2K+3) pack, in one
  kernel, so the sums never reach device memory.

Each dispatches on the tensors' device: the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors (or an error).
"""

from __future__ import annotations

import threading

import torch

from ._build import check, library
from .finish import MAX_K, finish_topk_plain

__all__ = ["rowgather_sum", "rowgather_sum_plain", "rowgather_sum_topk",
           "rowgather_sum_topk_plain"]

_count_lock = threading.Lock()


def rowgather_sum_plain(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 adds in window order, one row after another (the
    kernel's exact order, so the two are bit-equal)."""
    R, W = rows.shape
    acc = torch.zeros((R, plane.shape[1]), dtype=torch.float32, device=plane.device)
    for w in range(W):
        acc += plane.index_select(0, rows[:, w])
    return acc


def _check_args(plane: torch.Tensor, rows: torch.Tensor) -> None:
    if plane.dtype != torch.float32 or plane.dim() != 2 or not plane.is_contiguous():
        raise ValueError(f"plane must be contiguous 2-D float32, got {plane.dtype} "
                         f"{tuple(plane.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous 2-D int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if plane.device != rows.device:
        raise ValueError(f"plane on {plane.device} but rows on {rows.device}")
    if plane.shape[1] % 4 or plane.data_ptr() % 16:
        raise ValueError("plane rows must be whole, 16-byte aligned float4s")


def rowgather_sum(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """plane f32 (n_rows, bw), rows int32 (R, W) -> f32 (R, bw).

    Every index must lie in [0, n_rows); misses point at an all-zero row."""
    _check_args(plane, rows)
    if plane.device.type == "cpu":
        return rowgather_sum_plain(plane, rows)
    if plane.device.type != "cuda":
        raise ValueError(f"rowgather_sum: no kernel for device {plane.device}")
    R, W = rows.shape
    bw = plane.shape[1]
    out = torch.empty((R, bw), dtype=torch.float32, device=plane.device)
    if R == 0:
        return out
    lib = library()
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        err = lib.epik_rowgather_sum(plane.data_ptr(), rows.data_ptr(),
                                     out.data_ptr(), R, W, bw, stream)
    check(err, "rowgather_sum")
    with _count_lock:
        rowgather_sum.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum.launches = 0


def rowgather_sum_topk_plain(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, B: int, K: int, k: int,
                             log_eps: float) -> torch.Tensor:
    """Plain version: ``finish_topk_plain(rowgather_sum_plain(plane, rows)[:, :B]
    + delta)``, ``delta`` holding ``amb_delta`` at the rows ``amb_read`` and
    zeros elsewhere."""
    Sp = rowgather_sum_plain(plane, rows)[:, :B]
    if amb_read is not None:
        delta = torch.zeros_like(Sp)
        delta[amb_read] = amb_delta
        Sp = Sp + delta
    return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B: int, K: int) -> None:
    _check_args(plane, rows)
    R = rows.shape[0]
    dev = plane.device
    if (m_f32.dtype != torch.float32 or m_f32.shape != (R,) or not m_f32.is_contiguous()
            or m_f32.device != dev):
        raise ValueError(f"m_f32 must be contiguous float32 ({R},) on {dev}, got "
                         f"{m_f32.dtype} {tuple(m_f32.shape)} on {m_f32.device}")
    if not 1 <= B <= plane.shape[1]:
        raise ValueError(f"B={B} must lie in [1, bw={plane.shape[1]}]")
    if not 1 <= K <= min(MAX_K, B):
        raise ValueError(f"K={K} must lie in [1, min({MAX_K}, B={B})]")
    if (amb_read is None) != (amb_delta is None):
        raise ValueError("amb_read and amb_delta come together or not at all")
    if amb_read is not None:
        A = amb_read.shape[0] if amb_read.dim() == 1 else -1
        if amb_read.dtype not in (torch.int32, torch.int64) or A < 0 or amb_read.device != dev:
            raise ValueError(f"amb_read must be 1-D int32/int64 on {dev}, got "
                             f"{amb_read.dtype} {tuple(amb_read.shape)} on {amb_read.device}")
        if (amb_delta.dtype != torch.float32 or amb_delta.shape != (A, B)
                or not amb_delta.is_contiguous() or amb_delta.device != dev):
            raise ValueError(f"amb_delta must be contiguous float32 ({A}, {B}) on {dev}, "
                             f"got {amb_delta.dtype} {tuple(amb_delta.shape)} on "
                             f"{amb_delta.device}")


def rowgather_sum_topk(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                       amb_read, amb_delta, *, B: int, K: int, k: int,
                       log_eps: float) -> torch.Tensor:
    """plane f32 (n_rows, bw), rows int32 (R, W), m_f32 f32 (R,) window
    counts; ``amb_read`` (A,) the reads with an ambiguous first-hit delta row
    and ``amb_delta`` f32 (A, B) those rows (both None when there are none)
    -> f32 (R, 2K+3) slim pack.

    Every index must lie in [0, n_rows), misses pointing at an all-zero row;
    ``amb_read`` holds distinct reads. The kernel's block holds the (bw) sums
    and B ids in shared memory (B up to about 28,000 at bw ~ B); a launch
    past that raises from its CUDA error."""
    _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B, K)
    R, W = rows.shape
    if plane.device.type == "cpu":
        return rowgather_sum_topk_plain(plane, rows, m_f32, amb_read, amb_delta, B=B,
                                        K=K, k=k, log_eps=log_eps)
    if plane.device.type != "cuda":
        raise ValueError(f"rowgather_sum_topk: no kernel for device {plane.device}")
    out = torch.empty((R, 2 * K + 3), dtype=torch.float32, device=plane.device)
    if R == 0:
        return out
    slot = None
    if amb_read is not None and amb_read.numel() > 0:
        slot = torch.full((R,), -1, dtype=torch.int32, device=plane.device)
        slot[amb_read] = torch.arange(amb_read.numel(), dtype=torch.int32,
                                      device=plane.device)
    lib = library()
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        err = lib.epik_rowgather_sum_topk(
            plane.data_ptr(), rows.data_ptr(), m_f32.data_ptr(),
            slot.data_ptr() if slot is not None else None,
            amb_delta.data_ptr() if slot is not None else None, out.data_ptr(),
            R, W, plane.shape[1], B, K, k, float(log_eps), stream)
    check(err, "rowgather_sum_topk")
    with _count_lock:
        rowgather_sum_topk.launches += 1
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_topk.launches = 0
