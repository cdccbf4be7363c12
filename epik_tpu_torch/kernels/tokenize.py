"""The pair-plane slot tokenizer as one kernel.

``tokenize_combo_fused(buf, combo, k=, Lmax=)`` computes what
``ops/tokenize.py::tokenize_combo`` and ``engine/step.py::_m_f32`` compute
together on the dense pair-plane steps: from the packed read buffer
(``staging.pack_reads``) and the combo table (``tables.build_combo_table``),
one plane row per 2-window slot, each read's length and its window count
``m_f32`` (wrapped to 2**64 below k, quirk Q1). On the card that is one
launch (``csrc/tokenize.cu`` records the design) where the torch ops take
~60; its rows, lengths and counts are bit-equal to theirs, which remain the
plain version and run on the CPU.
"""

from __future__ import annotations

import threading

import torch

from ..ops.tokenize import tokenize_combo
from ._build import check, library

__all__ = ["MAX_K", "tokenize_combo_fused"]

#: the kernel builds a slot's (k+1)-mer key from one 32-bit word of codes
#: read at a 4-bit offset: 2 (k + 1) <= 28 bits (the pair plane stops at k = 12)
MAX_K = 13

_count_lock = threading.Lock()


def _check_args(buf: torch.Tensor, combo: torch.Tensor, k: int, Lmax: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the slot tokenizer takes 1 <= k <= {MAX_K}")
    if Lmax % 8 != 0 or Lmax < k:
        raise ValueError(f"Lmax={Lmax} must be a multiple of 8 and at least k={k}")
    width = Lmax // 4 + Lmax // 8 + 2
    if (buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] != width
            or not buf.is_contiguous()):
        raise ValueError(f"buf must be contiguous uint8 (R, {width}), got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    n = 4 ** (k + 1) + 4**k + 1
    if combo.dtype != torch.int32 or combo.shape != (n,) or not combo.is_contiguous():
        raise ValueError(f"combo must be the contiguous int32 ({n},) table of k={k}, got "
                         f"{combo.dtype} {tuple(combo.shape)}")
    if buf.device != combo.device:
        raise ValueError(f"buf on {buf.device} but combo on {combo.device}")


def tokenize_combo_fused(buf: torch.Tensor, combo: torch.Tensor, *, k: int, Lmax: int):
    """buf uint8 (R, Lmax/4 + Lmax/8 + 2) packed reads, combo int32 table ->
    (rows int32 (R, ceil(W/2)), lens int32 (R,), m_f32 float32 (R,)) with
    W = Lmax - k + 1."""
    _check_args(buf, combo, k, Lmax)
    if buf.device.type == "cpu":
        from ..engine.step import _m_f32  # engine.step imports this module

        rows, lens = tokenize_combo(buf, combo, k=k, Lmax=Lmax)
        return rows, lens, _m_f32(lens, k)
    if buf.device.type != "cuda":
        raise ValueError(f"tokenize_combo_fused: no kernel for device {buf.device}")
    R = buf.shape[0]
    rows = torch.empty((R, (Lmax - k + 2) // 2), dtype=torch.int32, device=buf.device)
    lens = torch.empty(R, dtype=torch.int32, device=buf.device)
    m_f32 = torch.empty(R, dtype=torch.float32, device=buf.device)
    if R > 0:
        lib = library()
        with torch.cuda.device(buf.device):
            stream = torch.cuda.current_stream(buf.device).cuda_stream
            err = lib.epik_tokenize_combo(buf.data_ptr(), combo.data_ptr(), rows.data_ptr(),
                                          lens.data_ptr(), m_f32.data_ptr(), R, Lmax, k, stream)
        check(err, "tokenize_combo_fused")
        with _count_lock:
            tokenize_combo_fused.launches += 1
    return rows, lens, m_f32


#: kernel launches since the last reset (CUDA only; the plain path never counts)
tokenize_combo_fused.launches = 0
