"""Kernel 1: row gather + sum, ``Sp[r] = sum_w plane[rows[r, w]]``, alone, with
counts, or with the placement finish fused into it.

Replaces the TPU kernel ``epik_tpu/ops/pallas/rowgather_mq.py::
rowgather_sum_mq`` (the function of ``engine/placer.py::dense_sums_shifted``
and ``dense_sums_from_rows``). On the H100 it is bound by HBM bytes: each
window slot reads one plane row. The CUDA source (``csrc/rowgather_sum.cu``)
says how its design meets that.

* :func:`rowgather_sum` -- the (R, bw) f32 sums over an f32 plane, or over an
  int16 plane in exact int32, divided by the plane scale;
* :func:`rowgather_sum_counts` / :func:`rowgather_sum_counts_bf16` -- the
  classic plane's sums and exact counts of the cells != 0 (f32 and int32
  (R, bw)), over an f32 or a bf16 plane;
* :func:`rowgather_sum_topk` / :func:`rowgather_sum_topk_int16` -- the dense
  shifted steps' whole device work after the tokenizer: the sums (an int16
  plane's dequantized), each ambiguous read's first-hit delta row added, and
  the finish of ``finish_topk`` into the slim (R, 2K+3) pack, in one kernel,
  so the sums never reach device memory. Its block holds the bw sums and the
  B touched ids in shared memory: :func:`topk_fits` says whether a width
  launches on the card, and past it the steps run :func:`rowgather_sum` and
  ``finish_topk`` apart (the same bits).

Each dispatches on the tensors' device: the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors (or an error).
"""

from __future__ import annotations

import threading

import torch

from ._build import check, library
from .finish import MAX_K, finish_topk_plain

__all__ = ["rowgather_sum", "rowgather_sum_counts", "rowgather_sum_counts_bf16",
           "rowgather_sum_counts_plain", "rowgather_sum_plain", "rowgather_sum_topk",
           "rowgather_sum_topk_int16", "rowgather_sum_topk_plain", "topk_fits"]

_count_lock = threading.Lock()
#: the C entry points' plane cell codes
_CELL = {torch.float32: 0, torch.int16: 1, torch.bfloat16: 2}
#: the fused kernel's touched ids are 16 bits
_MAX_TOPK_B = 1 << 16


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _f32(x: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def rowgather_sum_plain(plane: torch.Tensor, rows: torch.Tensor,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version: adds in window order, one row after another (the
    kernel's exact order, so the two are bit-equal): f32 adds over an f32
    plane; over an int16 plane int32 adds, then the f32 sums divided by
    ``scale`` (a device tensor: PyTorch's CUDA divide by a CPU scalar
    multiplies by the reciprocal, which rounds differently)."""
    R, W = rows.shape
    quant = plane.dtype == torch.int16
    acc = torch.zeros((R, plane.shape[1]), dtype=torch.int32 if quant else torch.float32,
                      device=plane.device)
    for w in range(W):
        acc += plane.index_select(0, rows[:, w])
    return acc.to(torch.float32) / _f32(scale, plane.device) if quant else acc


def rowgather_sum_counts_plain(plane: torch.Tensor, rows: torch.Tensor):
    """Plain version of the classic sums: f32 adds of the cells widened to
    f32, in window order, and int32 counts of the cells != 0."""
    R, W = rows.shape
    S = torch.zeros((R, plane.shape[1]), dtype=torch.float32, device=plane.device)
    C = torch.zeros((R, plane.shape[1]), dtype=torch.int32, device=plane.device)
    for w in range(W):
        g = plane.index_select(0, rows[:, w])
        S += g.to(torch.float32)
        C += (g != 0).to(torch.int32)
    return S, C


def _check_args(plane: torch.Tensor, rows: torch.Tensor, dtypes) -> None:
    if plane.dtype not in dtypes or plane.dim() != 2 or not plane.is_contiguous():
        raise ValueError(f"plane must be contiguous 2-D {' or '.join(map(str, dtypes))}, "
                         f"got {plane.dtype} {tuple(plane.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous 2-D int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if plane.device != rows.device:
        raise ValueError(f"plane on {plane.device} but rows on {rows.device}")
    if plane.shape[1] % 4 or plane.data_ptr() % 16:
        raise ValueError("plane rows must be whole groups of 4 cells, 16-byte aligned")


def _check_scale(plane: torch.Tensor, scale) -> None:
    if (plane.dtype == torch.int16) != (scale is not None):
        raise ValueError("an int16 plane needs its scale, and only an int16 plane takes one")
    if scale is not None and not scale > 0.0:
        raise ValueError(f"scale={scale} must be positive")


def _no_kernel(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def rowgather_sum(plane: torch.Tensor, rows: torch.Tensor, *,
                  scale: float | None = None) -> torch.Tensor:
    """plane f32 (n_rows, bw), or int16 with its ``scale``; rows int32 (R, W)
    -> f32 (R, bw).

    Every index must lie in [0, n_rows); misses point at an all-zero row."""
    _check_args(plane, rows, (torch.float32, torch.int16))
    _check_scale(plane, scale)
    if plane.device.type == "cpu":
        return rowgather_sum_plain(plane, rows, scale)
    _no_kernel("rowgather_sum", plane.device)
    R, W = rows.shape
    bw = plane.shape[1]
    out = torch.empty((R, bw), dtype=torch.float32, device=plane.device)
    if R == 0:
        return out
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum(plane.data_ptr(), _CELL[plane.dtype], rows.data_ptr(),
                                     out.data_ptr(), R, W, bw, float(scale or 1.0),
                                     _stream(plane.device))
    check(err, "rowgather_sum")
    _count(rowgather_sum)
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum.launches = 0


def _sum_counts(fn, plane: torch.Tensor, rows: torch.Tensor, dtype):
    _check_args(plane, rows, (dtype,))
    if plane.device.type == "cpu":
        return rowgather_sum_counts_plain(plane, rows)
    _no_kernel(fn.__name__, plane.device)
    R, W = rows.shape
    bw = plane.shape[1]
    S = torch.empty((R, bw), dtype=torch.float32, device=plane.device)
    C = torch.empty((R, bw), dtype=torch.int32, device=plane.device)
    if R == 0:
        return S, C
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum_counts(plane.data_ptr(), _CELL[dtype], rows.data_ptr(),
                                            S.data_ptr(), C.data_ptr(), R, W, bw,
                                            _stream(plane.device))
    check(err, fn.__name__)
    _count(fn)
    return S, C


def rowgather_sum_counts(plane: torch.Tensor, rows: torch.Tensor):
    """The classic f32 plane (n_rows, bw), rows int32 (R, W) -> (S f32 (R, bw)
    window-order sums, C int32 (R, bw) counts of the cells != 0)."""
    return _sum_counts(rowgather_sum_counts, plane, rows, torch.float32)


def rowgather_sum_counts_bf16(plane: torch.Tensor, rows: torch.Tensor):
    """:func:`rowgather_sum_counts` over a bf16 plane (each cell widened to
    f32 exactly before its add)."""
    return _sum_counts(rowgather_sum_counts_bf16, plane, rows, torch.bfloat16)


rowgather_sum_counts.launches = 0
rowgather_sum_counts_bf16.launches = 0


def rowgather_sum_topk_plain(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, B: int, K: int, k: int,
                             log_eps: float, scale: float | None = None) -> torch.Tensor:
    """Plain version: ``finish_topk_plain(rowgather_sum_plain(plane, rows,
    scale)[:, :B] + delta)``, ``delta`` holding ``amb_delta`` at the rows
    ``amb_read`` and zeros elsewhere."""
    Sp = rowgather_sum_plain(plane, rows, scale)[:, :B]
    if amb_read is not None:
        delta = torch.zeros_like(Sp)
        delta[amb_read] = amb_delta
        Sp = Sp + delta
    return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def topk_smem(plane: torch.Tensor, B: int, K: int) -> tuple[int, int]:
    """(bytes of shared memory a fused launch at this width asks, bytes a
    block of it may take on the plane's card), from the CUDA source's own
    formula and the card's opt-in limit less the kernel's static shared
    memory. CUDA planes only."""
    lib = library()
    with torch.cuda.device(plane.device):
        need = lib.epik_rowgather_sum_topk_smem(plane.shape[1], B, K)
        limit = lib.epik_rowgather_sum_topk_smem_limit(_CELL[plane.dtype])
    if limit < 0:
        check(int(-limit), "rowgather_sum_topk")
    return need, limit


def topk_fits(plane: torch.Tensor, B: int, K: int) -> bool:
    """Whether the fused kernel takes a tree of B branches at the plane's
    width: B <= 2**16 (16-bit ids) and its shared memory within the card's
    limit (about B = 37,000 at bw ~ B). The plain version on the CPU has no
    limit."""
    if plane.device.type != "cuda":
        return True
    if B > _MAX_TOPK_B:
        return False
    need, limit = topk_smem(plane, B, K)
    return need <= limit


def _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B: int, K: int,
                     dtype, scale) -> None:
    _check_args(plane, rows, (dtype,))
    _check_scale(plane, scale)
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
    # the limit: 16-bit ids, and bw sums + ceil(B/32) mask words + B ids +
    # the candidates within the card's opt-in shared memory
    if dev.type == "cuda":
        if B > _MAX_TOPK_B:
            raise ValueError(f"B={B}: the fused kernel's ids are 16 bits (B <= {_MAX_TOPK_B})")
        need, limit = topk_smem(plane, B, K)
        if need > limit:
            raise ValueError(f"B={B} at bw={plane.shape[1]}, K={K}: the fused kernel asks "
                             f"{need} bytes of shared memory, over the {limit} bytes a "
                             f"block may take on {dev}; run rowgather_sum + finish_topk")


def _sum_topk(fn, plane, rows, m_f32, amb_read, amb_delta, *, B, K, k, log_eps, scale):
    R, W = rows.shape
    if plane.device.type == "cpu":
        return rowgather_sum_topk_plain(plane, rows, m_f32, amb_read, amb_delta, B=B,
                                        K=K, k=k, log_eps=log_eps, scale=scale)
    _no_kernel(fn.__name__, plane.device)
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
        err = lib.epik_rowgather_sum_topk(
            plane.data_ptr(), _CELL[plane.dtype], rows.data_ptr(), m_f32.data_ptr(),
            slot.data_ptr() if slot is not None else None,
            amb_delta.data_ptr() if slot is not None else None, out.data_ptr(),
            R, W, plane.shape[1], B, K, k, float(log_eps), float(scale or 1.0),
            _stream(plane.device))
    check(err, fn.__name__)
    _count(fn)
    return out


def rowgather_sum_topk(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                       amb_read, amb_delta, *, B: int, K: int, k: int,
                       log_eps: float) -> torch.Tensor:
    """plane f32 (n_rows, bw), rows int32 (R, W), m_f32 f32 (R,) window
    counts; ``amb_read`` (A,) the reads with an ambiguous first-hit delta row
    and ``amb_delta`` f32 (A, B) those rows (both None when there are none)
    -> f32 (R, 2K+3) slim pack.

    Every index must lie in [0, n_rows), misses pointing at an all-zero row;
    ``amb_read`` holds distinct reads. On the card, B must be within
    :func:`topk_fits`'s limit (a wider tree raises ValueError)."""
    _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B, K, torch.float32, None)
    return _sum_topk(rowgather_sum_topk, plane, rows, m_f32, amb_read, amb_delta, B=B,
                     K=K, k=k, log_eps=log_eps, scale=None)


def rowgather_sum_topk_int16(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, B: int, K: int, k: int,
                             log_eps: float, scale: float) -> torch.Tensor:
    """:func:`rowgather_sum_topk` over an int16 plane: the sums in exact
    int32, then ``f32(sum) / f32(scale)`` (each correctly rounded) before the
    delta add and the finish."""
    _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B, K, torch.int16, scale)
    return _sum_topk(rowgather_sum_topk_int16, plane, rows, m_f32, amb_read, amb_delta,
                     B=B, K=K, k=k, log_eps=log_eps, scale=scale)


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_topk.launches = 0
rowgather_sum_topk_int16.launches = 0
