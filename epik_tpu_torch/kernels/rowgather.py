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
  (R, bw)), over an f32 or a bf16 plane.

  Both run one kernel template, the slice layout: the reads in
  :func:`locality_order` (stably by their least row id, so reads that share
  rows run together) and in 256-byte column slices, slice outermost, so a
  row that several reads name comes from the L2 after its first read; each
  read's sums (and counts) still land in its own row;
* :func:`rowgather_sum_posted` -- :func:`rowgather_sum`'s sums over a
  shifted f32 plane read from a row-compressed copy of its posted (non-zero)
  cells instead of its rows, bit for bit the same: the unfused shifted steps
  run it where the plane is sparse enough to hold the copy
  (``engine/state.py::build_posted``); one block a read, no read order;
  :func:`rowgather_sum_posted_topk`, the same gather with the ambiguous delta
  rows and the finish of ``finish_topk`` fused in, so the sums never reach
  device memory (where :func:`posted_topk_fits` takes the shape, which the
  steps then run in place of the posted gather and ``finish_topk``);
* :func:`rowgather_sum_topk` / :func:`rowgather_sum_topk_int16` -- the dense
  shifted steps' whole device work after the tokenizer: the sums (an int16
  plane's dequantized), each ambiguous read's first-hit delta row added, and
  the finish of ``finish_topk`` into the slim (R, 2K+3) pack, in one kernel,
  so the sums never reach device memory. The group layout's shifted form: a
  block takes G reads (:func:`shifted_group`) of the locality order, or of
  read order on the pair plane's rows, gathers them in 512-byte column
  slices into its shared memory (G x bw sums) and finishes them a warp a
  read.
  :func:`topk_fits` says whether a width launches on the card at all (G = 1:
  about B = 36,400 at bw ~ B), and :func:`shifted_fused` whether it beats
  :func:`rowgather_sum` and ``finish_topk`` apart (the same bits), which
  the steps run otherwise;
* :func:`rowgather_sum_counts_topk` / :func:`rowgather_sum_counts_topk_bf16` --
  the classic dense steps' whole device work after the tokenizer: the sums
  and exact counts over the classic f32 or bf16 plane, each ambiguous read's
  first hit added (``S + dS``, ``C + hit``), and the counts finish of
  ``finish_topk_counts`` into the full pack's (R, 4K+2) body, in one kernel,
  so neither S nor C reaches device memory. The group layout: a block takes
  G reads of the locality order, gathers them in 256-byte column slices into
  its shared memory (G x bw sums and counts) and finishes them a warp a
  read; :func:`counts_group` chooses G from the width. :func:`counts_topk_fits`
  says whether a width launches on the card at all (G = 1: about B = 22,000
  at bw ~ B), and past it the steps run :func:`rowgather_sum_counts` and
  ``finish_topk_counts`` apart (the same bits);
* :func:`rowgather_sum_cols` / :func:`rowgather_sum_counts_cols` -- one model
  shard of the column-sharded dense steps after the tokenizer: the sums over
  the shard's f32 plane (shifted, or classic with counts), each ambiguous
  read's first hit added, and the shard's column finish
  (``finish_cols.finish_cols_partial`` / ``_counts``) into its partial pack
  (R, 2 Kl + 3) ``[values | global ids | n_s | max_s | e_s]`` (and the
  classic form's candidate counts), in one kernel, so the shard's sums never
  reach device memory; both forms in the group layout at B = bwl.
  :func:`cols_fits` / :func:`counts_cols_fits` say whether a shard width
  launches on the card (about bwl = 36,400 / 22,000), and past it (the
  shifted form also past :func:`shifted_fused`'s width) the step runs the
  gather and the finish apart (the same bits but ``e_s``'s order of adds).

Each dispatches on the tensors' device: the plain PyTorch version for CPU
tensors, the CUDA kernel for CUDA tensors (or an error).
"""

from __future__ import annotations

import functools
import threading

import torch

from ._build import check, library
from .finish import MAX_K, finish_topk_counts_plain, finish_topk_plain
from .finish_cols import finish_cols_partial_counts_plain, finish_cols_partial_plain

__all__ = ["GROUP_BLOCK_RESERVE", "GROUP_MAX", "GROUP_MIN_BLOCKS", "GROUP_ROW_IDS",
           "GROUP_THREADS", "SHIFTED_COLS_MAX_BW", "SHIFTED_GROUP_MAX", "SHIFTED_TOPK_MAX_BW",
           "add_first_hits", "cols_fits", "cols_smem", "counts_cols_fits",
           "counts_group", "counts_topk_fits", "counts_topk_smem", "group_smem",
           "locality_order", "posted_fits", "posted_smem", "posted_topk_fits",
           "posted_topk_smem", "rowgather_sum", "rowgather_sum_cols",
           "rowgather_sum_cols_plain", "rowgather_sum_counts", "rowgather_sum_counts_bf16",
           "rowgather_sum_counts_cols", "rowgather_sum_counts_cols_plain",
           "rowgather_sum_counts_plain", "rowgather_sum_counts_topk",
           "rowgather_sum_counts_topk_bf16", "rowgather_sum_counts_topk_plain",
           "rowgather_sum_plain", "rowgather_sum_posted", "rowgather_sum_posted_plain",
           "rowgather_sum_posted_topk", "rowgather_sum_posted_topk_plain",
           "rowgather_sum_topk", "rowgather_sum_topk_int16",
           "rowgather_sum_topk_plain", "shifted_fused", "shifted_group", "topk_fits",
           "topk_smem"]

_count_lock = threading.Lock()
#: the C entry points' plane cell codes
_CELL = {torch.float32: 0, torch.int16: 1, torch.bfloat16: 2}
#: the fused kernel's touched ids are 16 bits
_MAX_TOPK_B = 1 << 16
#: the posted gather sorts its cells by a 16-bit column id
_POSTED_MAX_BW = 1 << 16
#: the group layout's block, as csrc/rowgather_sum.cu compiles it
#: (kGroupThreads, kGroupRowIds): threads, staged row ids
GROUP_THREADS = 256
GROUP_ROW_IDS = 2048
#: the choice of G: at most GROUP_MAX reads a block (the shifted form, with
#: half the bytes a read, SHIFTED_GROUP_MAX), as many as fit GROUP_MIN_BLOCKS
#: blocks within the card's shared memory (the kernel's register budget,
#: EPIK_GROUP_MIN_BLOCKS, both forms)
GROUP_MAX = 4
SHIFTED_GROUP_MAX = 8
GROUP_MIN_BLOCKS = 3
#: the shared memory an SM spends beside each block's dynamic bytes (the
#: kernel's 384 static bytes and the 1 KB the card reserves a block), rounded
#: up: an H100's SM holds its 227 KB block limit plus one such reserve
GROUP_BLOCK_RESERVE = 2048


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


def rowgather_sum(plane: torch.Tensor, rows: torch.Tensor, *, scale: float | None = None,
                  pair_rows: bool = False) -> torch.Tensor:
    """plane f32 (n_rows, bw), or int16 with its ``scale``; rows int32 (R, W)
    -> f32 (R, bw).

    Every index must lie in [0, n_rows); misses point at an all-zero row. The
    kernel gathers the row in 256-byte column slices, slice outermost, the
    reads in :func:`locality_order`, or in read order where ``pair_rows``
    (the rows index a pair plane); each read's sums land in its own row,
    added in window order, whatever the order. On an H100
    (``kernel_sweep.py``) the locality order took the wide shifted tree's
    rows (4,096 x 143, bw 40,064) from 21.7 to 20.1 ms in f32 and from 11.2
    to 10.5 in int16, and bought D652's pair rows (16,381 x 72) nothing
    (1.77 ms in read order, 1.78 in locality order), where the sort itself
    costs: 1.89-1.92 ms through this wrapper with it, 1.79 without
    (``step_times.py``). So pair rows, on one device and sharded, are
    gathered in read order and skip the sort."""
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
    perm = None if pair_rows else locality_order(rows)
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum(plane.data_ptr(), _CELL[plane.dtype], rows.data_ptr(),
                                     perm.data_ptr() if perm is not None else None,
                                     out.data_ptr(), R, W, bw, float(scale or 1.0),
                                     _stream(plane.device))
    check(err, "rowgather_sum")
    _count(rowgather_sum)
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum.launches = 0


def rowgather_sum_posted_plain(off: torch.Tensor, cells: torch.Tensor, rows: torch.Tensor,
                               bw: int) -> torch.Tensor:
    """Plain version: the posted cells of each window's row added to zeros,
    window after window (f32 adds, the kernel's order). Bit-equal to
    :func:`rowgather_sum_plain` over the shifted f32 plane the index was
    read from: that adds a 0.0 for every cell not posted, and x + 0.0 == x
    for the sums of a shifted plane, which are never below zero."""
    R, W = rows.shape
    acc = torch.zeros((R, bw), dtype=torch.float32, device=rows.device)
    cols = cells[:, 0].long()
    vals = cells[:, 1].contiguous().view(torch.float32)
    reads = torch.arange(R, device=rows.device)
    for w in range(W):
        r = rows[:, w].long()
        start = off[r]
        n = off[r + 1] - start
        total = int(n.sum())
        if total == 0:
            continue
        first = torch.cumsum(n, 0) - n  # each read's first place among the window's cells
        src = (torch.arange(total, device=rows.device)
               + torch.repeat_interleave(start - first, n))
        read = torch.repeat_interleave(reads, n)
        # a row's columns are distinct: no (read, column) twice in one window
        c = cols[src]
        acc[read, c] = acc[read, c] + vals[src]
    return acc


def posted_smem(bw: int, device: torch.device) -> tuple[int, int]:
    """(bytes of shared memory a :func:`rowgather_sum_posted` launch at width
    ``bw`` asks, bytes a block of it may take on ``device``), from the CUDA
    source. CUDA devices only."""
    return _posted_layout(torch.device(device), bw)


@functools.lru_cache(maxsize=None)
def _posted_layout(device: torch.device, bw: int) -> tuple[int, int]:
    lib = library()
    with torch.cuda.device(device):
        limit = lib.epik_rowgather_posted_smem_limit()
    if limit < 0:
        check(int(-limit), "the posted gather's shared memory limit")
    return lib.epik_rowgather_posted_smem(bw), limit


def posted_fits(bw: int, device) -> bool:
    """Whether :func:`rowgather_sum_posted` takes a plane ``bw`` columns wide
    on ``device``: column ids of the kernel's 16-bit sort keys, and a block's
    bw sums, its sorted cells and its window tile within the card's shared
    memory (about 53,000 columns on an H100). The plain version on the CPU
    has no limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    need, limit = posted_smem(bw, device)
    return bw <= _POSTED_MAX_BW and need <= limit


def _check_posted_args(off: torch.Tensor, cells: torch.Tensor, rows: torch.Tensor,
                       bw: int) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous 2-D int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if off.dtype != torch.int64 or off.dim() != 1 or not off.is_contiguous() or off.numel() < 2:
        raise ValueError(f"off must be contiguous 1-D int64 (n_rows + 1,), got {off.dtype} "
                         f"{tuple(off.shape)}")
    if (cells.dtype != torch.int32 or cells.dim() != 2 or cells.shape[1] != 2
            or not cells.is_contiguous()):
        raise ValueError(f"cells must be contiguous int32 (nnz, 2), got {cells.dtype} "
                         f"{tuple(cells.shape)}")
    if not (off.device == cells.device == rows.device):
        raise ValueError(f"off on {off.device}, cells on {cells.device}, rows on {rows.device}")
    if bw <= 0 or bw % 4:
        raise ValueError(f"bw={bw} must be a positive multiple of 4")


def rowgather_sum_posted(off: torch.Tensor, cells: torch.Tensor, rows: torch.Tensor, *,
                         bw: int) -> torch.Tensor:
    """The gather 1d over a shifted f32 plane's posted cells: off int64
    (n_rows + 1,) and cells int32 (nnz, 2) (column, f32 value bits; a row's
    cells in [off[row], off[row + 1]), the all-zero row's range empty), rows
    int32 (R, W) -> f32 (R, bw), bit for bit :func:`rowgather_sum` over the
    plane the index was read from (``engine/state.py::build_posted``).

    Every index must lie in [0, n_rows). The kernel (``csrc/
    rowgather_posted.cu``) reads each window's posted cells and no other
    cell: one block a read, its sums in shared memory, added in window
    order; on the card bw must be within :func:`posted_fits`'s limit (a
    wider plane raises ValueError)."""
    _check_posted_args(off, cells, rows, bw)
    if rows.device.type == "cpu":
        return rowgather_sum_posted_plain(off, cells, rows, bw)
    _no_kernel("rowgather_sum_posted", rows.device)
    if not posted_fits(bw, rows.device):
        need, limit = posted_smem(bw, rows.device)
        raise ValueError(f"bw={bw}: the posted gather takes at most {_POSTED_MAX_BW} columns "
                         f"and {limit} bytes of shared memory a block on {rows.device} (it "
                         f"asks {need}); run rowgather_sum")
    R, W = rows.shape
    out = torch.empty((R, bw), dtype=torch.float32, device=rows.device)
    if R == 0:
        return out
    lib = library()
    with torch.cuda.device(rows.device):
        err = lib.epik_rowgather_sum_posted(off.data_ptr(), cells.data_ptr(), rows.data_ptr(),
                                            out.data_ptr(), R, W, bw, _stream(rows.device))
    check(err, "rowgather_sum_posted")
    _count(rowgather_sum_posted)
    return out


rowgather_sum_posted.launches = 0


def rowgather_sum_posted_topk_plain(off: torch.Tensor, cells: torch.Tensor, rows: torch.Tensor,
                                    m_f32: torch.Tensor, amb_read, amb_delta, *, bw: int, B: int,
                                    K: int, k: int, log_eps: float) -> torch.Tensor:
    """Plain version: ``finish_topk_plain(rowgather_sum_posted_plain(off,
    cells, rows, bw)[:, :B] + delta)``, ``delta`` holding ``amb_delta`` at the
    rows ``amb_read`` and zeros elsewhere: the pack of the posted gather,
    the delta add and ``finish_topk`` apart."""
    Sp = _with_deltas(rowgather_sum_posted_plain(off, cells, rows, bw)[:, :B], amb_read,
                      amb_delta)
    return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def posted_topk_smem(bw: int, B: int, device: torch.device) -> tuple[int, int]:
    """(bytes of shared memory a :func:`rowgather_sum_posted_topk` launch at
    (bw, B) asks, bytes a block of it may take on ``device``), from the CUDA
    source. CUDA devices only."""
    return _posted_topk_layout(torch.device(device), bw, B)


@functools.lru_cache(maxsize=None)
def _posted_topk_layout(device: torch.device, bw: int, B: int) -> tuple[int, int]:
    lib = library()
    with torch.cuda.device(device):
        limit = lib.epik_rowgather_posted_topk_smem_limit()
    if limit < 0:
        check(int(-limit), "the fused posted gather's shared memory limit")
    return lib.epik_rowgather_posted_topk_smem(bw, B), limit


def posted_topk_fits(bw: int, B: int, device) -> bool:
    """Whether :func:`rowgather_sum_posted_topk` takes a plane ``bw`` columns
    wide and B branches on ``device``: the posted gather's 16-bit column ids,
    and a block's bw sums, B touched bits and the gather's staging (over which
    the finish lays its top-K candidates and touched list) within the card's
    shared memory (about 51,000 columns at B ~ bw on an H100, the posted
    gather's limit less the bits). The plain version on the CPU has no
    limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    need, limit = posted_topk_smem(bw, B, device)
    return bw <= _POSTED_MAX_BW and need <= limit


def rowgather_sum_posted_topk(off: torch.Tensor, cells: torch.Tensor, rows: torch.Tensor,
                              m_f32: torch.Tensor, amb_read, amb_delta, *, bw: int, B: int,
                              K: int, k: int, log_eps: float) -> torch.Tensor:
    """The posted gather with the finish fused in: off, cells, rows and bw
    as :func:`rowgather_sum_posted` takes them, m_f32 f32 (R,) window counts,
    ``amb_read`` (A,) the reads with an ambiguous first-hit delta row and
    ``amb_delta`` f32 (A, B) those rows (both None when there are none) -> f32
    (R, 2K+3) slim pack: scores, ids, n and zero_sum bit for bit those of
    :func:`rowgather_sum_posted`, the delta add and ``finish_topk`` apart,
    log_sum within rtol 1e-6 (its exp-sum adds in another order).

    Every index must lie in [0, n_rows); ``amb_read`` holds distinct reads.
    The kernel (``csrc/rowgather_posted.cu``, ``rowgather_posted_topk_kernel``)
    gathers a read as the posted gather does, one block a read, marking the
    columns it adds to; then keeps its sums in shared memory and finishes the
    read from them over the list of the touched branches (past the list's
    room, 5,410 at K = 7, one warp walks the marks); on the card the shape
    must be within :func:`posted_topk_fits`'s limit (past it raises
    ValueError)."""
    _check_posted_args(off, cells, rows, bw)
    dev = rows.device
    R = rows.shape[0]
    _check_finish_args(m_f32, R, B, K, bw, dev)
    _check_amb(amb_read, {"amb_delta": (amb_delta, torch.float32)}, B, dev)
    if dev.type == "cpu":
        return rowgather_sum_posted_topk_plain(off, cells, rows, m_f32, amb_read, amb_delta,
                                               bw=bw, B=B, K=K, k=k, log_eps=log_eps)
    _no_kernel("rowgather_sum_posted_topk", dev)
    if not posted_topk_fits(bw, B, dev):
        need, limit = posted_topk_smem(bw, B, dev)
        raise ValueError(f"bw={bw}, B={B}: the fused posted gather takes at most "
                         f"{_POSTED_MAX_BW} columns and {limit} bytes of shared memory a block "
                         f"on {dev} (it asks {need}); run rowgather_sum_posted + finish_topk")
    out = torch.empty((R, 2 * K + 3), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    amb, _held = _amb_args(amb_read, amb_delta, R, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.epik_rowgather_sum_posted_topk(
            off.data_ptr(), cells.data_ptr(), rows.data_ptr(), m_f32.data_ptr(), *amb,
            out.data_ptr(), R, rows.shape[1], bw, B, K, k, float(log_eps), _stream(dev))
    check(err, "rowgather_sum_posted_topk")
    _count(rowgather_sum_posted_topk)
    return out


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_posted_topk.launches = 0


def locality_order(rows: torch.Tensor) -> torch.Tensor:
    """rows int32 (R, W) -> int32 (R,): the reads sorted stably by their
    least row id (the key of the slice layout's read order; a miss is the
    plane's last, all-zero row, so it never leads a read that hits). Two
    reads that overlap on the reference by all but d of their W windows
    share the key with probability about (W - d) / (W + d); ties keep read
    order."""
    R, W = rows.shape
    if W == 0:
        return torch.arange(R, dtype=torch.int32, device=rows.device)
    return torch.sort(rows.amin(dim=1), stable=True).indices.to(torch.int32)


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
    perm = locality_order(rows)
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum_counts(plane.data_ptr(), _CELL[dtype], rows.data_ptr(),
                                            perm.data_ptr(), S.data_ptr(), C.data_ptr(), R,
                                            W, bw, _stream(plane.device))
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


def _with_deltas(Sp: torch.Tensor, amb_read, amb_delta) -> torch.Tensor:
    """``Sp`` plus ``amb_delta`` at the rows ``amb_read`` (0 added elsewhere)."""
    if amb_read is None:
        return Sp
    delta = torch.zeros_like(Sp)
    delta[amb_read] = amb_delta
    return Sp + delta


def rowgather_sum_topk_plain(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, B: int, K: int, k: int,
                             log_eps: float, scale: float | None = None) -> torch.Tensor:
    """Plain version: ``finish_topk_plain(rowgather_sum_plain(plane, rows,
    scale)[:, :B] + delta)``, ``delta`` holding ``amb_delta`` at the rows
    ``amb_read`` and zeros elsewhere."""
    Sp = _with_deltas(rowgather_sum_plain(plane, rows, scale)[:, :B], amb_read, amb_delta)
    return finish_topk_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps)


def group_smem(G: int, bw: int, B: int, K: int, counts: bool = True) -> int:
    """Bytes of dynamic shared memory of a group-layout block of G reads at
    (bw, B, K), the CUDA source's formula (``group_smem``): G x bw sums (and
    with ``counts`` G x bw counts), the staged row ids, ceil(B / 32) mask
    words, B 16-bit ids (padded to 4 bytes) and the warps' K candidates
    (value and id)."""
    words = (2 if counts else 1) * G * bw + GROUP_ROW_IDS + (B + 31) // 32 + (B + 1) // 2
    return words * 4 + GROUP_THREADS // 32 * K * 8


def _group_size(bw: int, B: int, K: int, limit: int, counts: bool) -> int:
    """The largest G up to the form's maximum of whose blocks an SM holds
    GROUP_MIN_BLOCKS (each with its reserve, within one block's limit and one
    reserve), else 1 (one block an SM; whether that fits is
    the fits functions' question)."""
    G = GROUP_MAX if counts else SHIFTED_GROUP_MAX
    while G > 1 and GROUP_MIN_BLOCKS * (group_smem(G, bw, B, K, counts)
                                        + GROUP_BLOCK_RESERVE) > limit + GROUP_BLOCK_RESERVE:
        G -= 1
    return G


def counts_group(bw: int, B: int, K: int, limit: int) -> int:
    """G, the reads a counts-form block (:func:`rowgather_sum_counts_topk`,
    :func:`rowgather_sum_counts_cols`) takes at (bw, B, K) on a card whose
    block may take ``limit`` bytes of shared memory: the largest G up to
    GROUP_MAX of whose blocks an SM holds GROUP_MIN_BLOCKS, else 1."""
    return _group_size(bw, B, K, limit, True)


def shifted_group(bw: int, B: int, K: int, limit: int) -> int:
    """G, the reads a shifted-form block (:func:`rowgather_sum_topk`,
    :func:`rowgather_sum_cols`) takes at (bw, B, K) on a card whose block may
    take ``limit`` bytes of shared memory: the largest G up to
    SHIFTED_GROUP_MAX of whose blocks an SM holds GROUP_MIN_BLOCKS, else 1."""
    return _group_size(bw, B, K, limit, False)


@functools.lru_cache(maxsize=None)
def _group_limit(device: torch.device) -> int:
    """Bytes a group-layout block may take on ``device``: the opt-in limit
    less the kernel's static shared memory (a property of the card, so it is
    asked once)."""
    with torch.cuda.device(device):
        limit = library().epik_rowgather_group_smem_limit()
    if limit < 0:
        check(int(-limit), "the group layout's shared memory limit")
    return limit


@functools.lru_cache(maxsize=None)
def _layout(device: torch.device, bw: int, B: int, K: int, counts: bool) -> tuple[int, int, int]:
    limit = _group_limit(device)
    G = _group_size(bw, B, K, limit, counts)
    return G, group_smem(G, bw, B, K, counts), limit


def _group_layout(plane: torch.Tensor, B: int, K: int, counts: bool) -> tuple[int, int, int]:
    """(G, bytes of the launch, bytes a block may take on the plane's card:
    the opt-in limit less the kernel's static shared memory) of a
    group-layout launch at the plane's width, worked out once a shape (the
    wrappers ask it on every call). CUDA planes only."""
    return _layout(plane.device, plane.shape[1], B, K, counts)


def topk_smem(plane: torch.Tensor, B: int, K: int) -> tuple[int, int]:
    """(bytes of shared memory a :func:`rowgather_sum_topk` launch at this
    width asks at the G :func:`shifted_group` chooses, bytes a block of it
    may take on the plane's card). CUDA planes only."""
    return _group_layout(plane, B, K, False)[1:]


def topk_fits(plane: torch.Tensor, B: int, K: int) -> bool:
    """Whether the fused kernel takes a tree of B branches at the plane's
    width: B <= 2**16 (16-bit ids) and a block of one read
    (bw sums, the row ids, ceil(B / 32) mask words, B ids) within the card's
    shared memory (about B = 36,400 at bw ~ B). The plain version on the CPU
    has no limit."""
    if plane.device.type != "cuda":
        return True
    if B > _MAX_TOPK_B:
        return False
    need, limit = topk_smem(plane, B, K)
    return need <= limit


#: the widest plane (columns) at which a shifted step runs its fused kernel
#: (rowgather_sum_topk[_int16]) rather than the unfused pair (rowgather_sum,
#: the delta add, finish_topk), and the widest shard at which a sharded
#: shifted step runs rowgather_sum_cols rather than rowgather_sum, the delta
#: add and finish_cols_partial. Set from both routes timed through their
#: public wrappers in turns on an H100 (kernel_sweep.py --only shifted: CUDA
#: events from an idle card, the host's work before the launches included,
#: and with the card busy ahead, the device's work alone), on the paths' rows
#: and on D652's unpaired rows over its plane cut or repeated to 1,024-19,712
#: columns. #1: the fused kernel ahead by 5-16% up to 1,664 columns (D652's
#: pair rows 2.02 ms against 2.29, 1,664 columns 2.96 against 3.13), behind
#: from 1,792 (3.38 against 3.31; config 4's 20,096 13.8 against 12.2). 1e,
#: whose pair ends in kernel A (0.24 ms) where #1's ends in finish_topk
#: (0.52 ms at D652's B): ahead at 384 columns (D652's 1x4 shard, 0.63
#: against 0.66; 0.54 against 0.62 device time), tied at 768 and 1,024
#: (1.19 against 1.19; 1.92 against 1.92), behind from 1,216 (2.44 against
#: 2.31), and tied on D652's 1x1 shard of 1,408 columns of pair rows (2.06
#: against 2.04; 1.94 against 1.96 device time), which therefore runs the
#: pair.
SHIFTED_TOPK_MAX_BW = 1664
SHIFTED_COLS_MAX_BW = 1024


def shifted_fused(bw: int, cols: bool = False) -> bool:
    """Whether a shifted step at plane width ``bw`` (``cols``: a sharded
    step's shard of ``bw`` columns) runs the fused kernel rather than its
    unfused pair, where both launch (:func:`topk_fits`, :func:`cols_fits`):
    the crossover measured on an H100, a rule of the width alone, decided
    before any launch."""
    return bw <= (SHIFTED_COLS_MAX_BW if cols else SHIFTED_TOPK_MAX_BW)


def _check_amb(amb_read, rows_of_read: dict, B: int, dev: torch.device) -> None:
    """``amb_read`` (A,) int32/int64 and, by name, each (A, B) tensor of the
    given dtype that comes with it (all None, or none)."""
    given = [amb_read is not None, *(t is not None for t, _ in rows_of_read.values())]
    if any(given) != all(given):
        raise ValueError(f"amb_read and {', '.join(rows_of_read)} come together or not at all")
    if amb_read is None:
        return
    A = amb_read.shape[0] if amb_read.dim() == 1 else -1
    if amb_read.dtype not in (torch.int32, torch.int64) or A < 0 or amb_read.device != dev:
        raise ValueError(f"amb_read must be 1-D int32/int64 on {dev}, got "
                         f"{amb_read.dtype} {tuple(amb_read.shape)} on {amb_read.device}")
    for name, (t, dtype) in rows_of_read.items():
        if t.dtype != dtype or t.shape != (A, B) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be contiguous {dtype} ({A}, {B}) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_finish_args(m_f32, R: int, B: int, K: int, bw: int, dev: torch.device) -> None:
    """m_f32 (R,) f32 on ``dev``, 1 <= B <= bw, 1 <= K <= min(MAX_K, B)."""
    if (m_f32.dtype != torch.float32 or m_f32.shape != (R,) or not m_f32.is_contiguous()
            or m_f32.device != dev):
        raise ValueError(f"m_f32 must be contiguous float32 ({R},) on {dev}, got "
                         f"{m_f32.dtype} {tuple(m_f32.shape)} on {m_f32.device}")
    if not 1 <= B <= bw:
        raise ValueError(f"B={B} must lie in [1, bw={bw}]")
    if not 1 <= K <= min(MAX_K, B):
        raise ValueError(f"K={K} must lie in [1, min({MAX_K}, B={B})]")


def _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B: int, K: int,
                     dtype, scale) -> None:
    _check_args(plane, rows, (dtype,))
    _check_scale(plane, scale)
    dev = plane.device
    _check_finish_args(m_f32, rows.shape[0], B, K, plane.shape[1], dev)
    _check_amb(amb_read, {"amb_delta": (amb_delta, torch.float32)}, B, dev)
    # the limit: 16-bit ids, and a block of one read (bw sums + the row ids +
    # ceil(B/32) mask words + B ids + the candidates) within the card's opt-in
    # shared memory
    if dev.type == "cuda":
        if B > _MAX_TOPK_B:
            raise ValueError(f"B={B}: the fused kernel's ids are 16 bits (B <= {_MAX_TOPK_B})")
        need, limit = topk_smem(plane, B, K)
        if need > limit:
            raise ValueError(f"B={B} at bw={plane.shape[1]}, K={K}: the fused kernel asks "
                             f"{need} bytes of shared memory, over the {limit} bytes a "
                             f"block may take on {dev}; run rowgather_sum + finish_topk")


def _amb_args(amb_read, amb_delta, R: int, dev: torch.device):
    """The group entry points' (amb, amb64, A, slot, delta) arguments and the
    tensors they point into: the ambiguous reads' ids and an int32 (R,)
    scratch that the launch fills with each read's row of the delta rows (or
    -1) on the stream, a memset and one small kernel where three PyTorch
    calls would sit on the host's path to the launch."""
    if amb_read is None or amb_read.numel() == 0:
        return (None, 0, 0, None, None), ()
    amb = amb_read.contiguous()
    slot = torch.empty((R,), dtype=torch.int32, device=dev)
    return ((amb.data_ptr(), int(amb.dtype == torch.int64), amb.numel(), slot.data_ptr(),
             amb_delta.data_ptr()), (amb, slot))


def _sum_topk(fn, plane, rows, m_f32, amb_read, amb_delta, *, B, K, k, log_eps, scale,
              pair_rows):
    R, W = rows.shape
    if plane.device.type == "cpu":
        return rowgather_sum_topk_plain(plane, rows, m_f32, amb_read, amb_delta, B=B,
                                        K=K, k=k, log_eps=log_eps, scale=scale)
    _no_kernel(fn.__name__, plane.device)
    out = torch.empty((R, 2 * K + 3), dtype=torch.float32, device=plane.device)
    if R == 0:
        return out
    amb, _held = _amb_args(amb_read, amb_delta, R, plane.device)
    perm = None if pair_rows else locality_order(rows)
    G = _group_layout(plane, B, K, False)[0]
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum_topk(
            plane.data_ptr(), _CELL[plane.dtype], rows.data_ptr(),
            perm.data_ptr() if perm is not None else None, m_f32.data_ptr(), *amb,
            out.data_ptr(), R, W, plane.shape[1], B, K, k, float(log_eps),
            float(scale or 1.0), G, _stream(plane.device))
    check(err, fn.__name__)
    _count(fn)
    return out


def rowgather_sum_topk(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                       amb_read, amb_delta, *, B: int, K: int, k: int, log_eps: float,
                       pair_rows: bool = False) -> torch.Tensor:
    """plane f32 (n_rows, bw), rows int32 (R, W), m_f32 f32 (R,) window
    counts; ``amb_read`` (A,) the reads with an ambiguous first-hit delta row
    and ``amb_delta`` f32 (A, B) those rows (both None when there are none)
    -> f32 (R, 2K+3) slim pack.

    Every index must lie in [0, n_rows), misses pointing at an all-zero row;
    ``amb_read`` holds distinct reads. On the card, B must be within
    :func:`topk_fits`'s limit (a wider tree raises ValueError). The kernel
    takes the reads in :func:`locality_order`, or in read order where
    ``pair_rows`` (the rows index a pair plane, which reads rarely share, as
    :func:`rowgather_sum` does), G of them a block (:func:`shifted_group`);
    each read's row of the pack is its own."""
    _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B, K, torch.float32, None)
    return _sum_topk(rowgather_sum_topk, plane, rows, m_f32, amb_read, amb_delta, B=B,
                     K=K, k=k, log_eps=log_eps, scale=None, pair_rows=pair_rows)


def rowgather_sum_topk_int16(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, B: int, K: int, k: int,
                             log_eps: float, scale: float,
                             pair_rows: bool = False) -> torch.Tensor:
    """:func:`rowgather_sum_topk` over an int16 plane: the sums in exact
    int32, then ``f32(sum) / f32(scale)`` (each correctly rounded) before the
    delta add and the finish."""
    _check_topk_args(plane, rows, m_f32, amb_read, amb_delta, B, K, torch.int16, scale)
    return _sum_topk(rowgather_sum_topk_int16, plane, rows, m_f32, amb_read, amb_delta,
                     B=B, K=K, k=k, log_eps=log_eps, scale=scale, pair_rows=pair_rows)


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_topk.launches = 0
rowgather_sum_topk_int16.launches = 0


def add_first_hits(S: torch.Tensor, C: torch.Tensor, amb_read, amb_dS, amb_hit):
    """The classic plane's ambiguous first hits added to the (R, B) sums and
    counts: ``S + dS`` and ``C + hit`` at the rows ``amb_read`` (the adds of
    ``_apply_amb(shifted=False)``; every other read would add 0), as new
    tensors."""
    if amb_read is None or amb_read.numel() == 0:
        return S, C
    S, C = S.clone(), C.clone()
    S[amb_read] = S[amb_read] + amb_dS
    C[amb_read] = C[amb_read] + amb_hit.to(torch.int32)
    return S, C


def rowgather_sum_counts_topk_plain(plane: torch.Tensor, rows: torch.Tensor,
                                    m_f32: torch.Tensor, amb_read, amb_dS, amb_hit, *,
                                    B: int, K: int, k: int, log_eps: float) -> torch.Tensor:
    """Plain version: ``rowgather_sum_counts_plain(plane, rows)[:, :B]``, the
    first hits added (:func:`add_first_hits`), then
    ``finish_topk_counts_plain`` into the full pack's (R, 4K+2) body."""
    S, C = rowgather_sum_counts_plain(plane, rows)
    S, C = add_first_hits(S[:, :B], C[:, :B], amb_read, amb_dS, amb_hit)
    return finish_topk_counts_plain(S, C, m_f32, K=K, k=k, log_eps=log_eps, full=True)


def counts_topk_smem(plane: torch.Tensor, B: int, K: int) -> tuple[int, int]:
    """(bytes of shared memory a :func:`rowgather_sum_counts_topk` launch at
    this width asks, at the G :func:`counts_group` chooses, bytes a block of
    it may take on the plane's card: the opt-in limit less the kernel's
    static shared memory). CUDA planes only."""
    return _group_layout(plane, B, K, True)[1:]


def counts_topk_fits(plane: torch.Tensor, B: int, K: int) -> bool:
    """Whether the classic plane's fused kernel takes a tree of B branches at
    the plane's width: B <= 2**16 (16-bit ids) and a block of one read (bw
    sums, bw counts, the row ids, B ids) within the card's shared memory
    (about B = 22,000 at bw ~ B). The plain version on the CPU has no
    limit."""
    if plane.device.type != "cuda":
        return True
    if B > _MAX_TOPK_B:
        return False
    need, limit = counts_topk_smem(plane, B, K)
    return need <= limit


def _check_counts_topk_args(plane, rows, m_f32, amb_read, amb_dS, amb_hit, B: int, K: int,
                            dtype) -> None:
    _check_args(plane, rows, (dtype,))
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
    _check_amb(amb_read, {"amb_dS": (amb_dS, torch.float32),
                          "amb_hit": (amb_hit, torch.bool)}, B, dev)
    # the limit: 16-bit ids, and a block of one read (bw sums + bw counts +
    # the row ids + ceil(B/32) mask words + B ids + the candidates) within the
    # card's opt-in shared memory
    if dev.type == "cuda":
        if B > _MAX_TOPK_B:
            raise ValueError(f"B={B}: the fused kernel's ids are 16 bits (B <= {_MAX_TOPK_B})")
        need, limit = counts_topk_smem(plane, B, K)
        if need > limit:
            raise ValueError(f"B={B} at bw={plane.shape[1]}, K={K}: the fused kernel asks "
                             f"{need} bytes of shared memory, over the {limit} bytes a "
                             f"block may take on {dev}; run rowgather_sum_counts + "
                             f"finish_topk_counts")


def _sum_counts_topk(fn, plane, rows, m_f32, amb_read, amb_dS, amb_hit, *, B, K, k,
                     log_eps):
    R, W = rows.shape
    if plane.device.type == "cpu":
        return rowgather_sum_counts_topk_plain(plane, rows, m_f32, amb_read, amb_dS, amb_hit,
                                               B=B, K=K, k=k, log_eps=log_eps)
    _no_kernel(fn.__name__, plane.device)
    out = torch.empty((R, 4 * K + 2), dtype=torch.float32, device=plane.device)
    if R == 0:
        return out
    amb, _held = _amb_args(amb_read, amb_dS, R, plane.device)
    perm = locality_order(rows)
    G = _group_layout(plane, B, K, True)[0]
    lib = library()
    with torch.cuda.device(plane.device):
        err = lib.epik_rowgather_sum_counts_topk(
            plane.data_ptr(), _CELL[plane.dtype], rows.data_ptr(), perm.data_ptr(),
            m_f32.data_ptr(), *amb, amb_hit.data_ptr() if amb[0] is not None else None,
            out.data_ptr(), R, W, plane.shape[1], B, K, k, float(log_eps), G,
            _stream(plane.device))
    check(err, fn.__name__)
    _count(fn)
    return out


def rowgather_sum_counts_topk(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                              amb_read, amb_dS, amb_hit, *, B: int, K: int, k: int,
                              log_eps: float) -> torch.Tensor:
    """The classic f32 plane (n_rows, bw), rows int32 (R, W), m_f32 f32 (R,)
    window counts; ``amb_read`` (A,) the reads with an ambiguous first hit,
    ``amb_dS`` f32 (A, B) their contributions (0 where no hit) and ``amb_hit``
    bool (A, B) where a hit lands (all three None when there are none) -> f32
    (R, 4K+2), the full pack's body ``[scores K | wr K | idx K | counts K | n |
    zero_sum]``.

    Every index must lie in [0, n_rows), misses pointing at an all-zero row;
    ``amb_read`` holds distinct reads. On the card, B must be within
    :func:`counts_topk_fits`'s limit (a wider tree raises ValueError). The
    kernel takes the reads in :func:`locality_order`, G of them a block
    (:func:`counts_group`); each read's row of the pack is its own."""
    _check_counts_topk_args(plane, rows, m_f32, amb_read, amb_dS, amb_hit, B, K,
                            torch.float32)
    return _sum_counts_topk(rowgather_sum_counts_topk, plane, rows, m_f32, amb_read, amb_dS,
                            amb_hit, B=B, K=K, k=k, log_eps=log_eps)


def rowgather_sum_counts_topk_bf16(plane: torch.Tensor, rows: torch.Tensor,
                                   m_f32: torch.Tensor, amb_read, amb_dS, amb_hit, *, B: int,
                                   K: int, k: int, log_eps: float) -> torch.Tensor:
    """:func:`rowgather_sum_counts_topk` over a bf16 plane (each cell widened
    to f32 exactly before its add)."""
    _check_counts_topk_args(plane, rows, m_f32, amb_read, amb_dS, amb_hit, B, K,
                            torch.bfloat16)
    return _sum_counts_topk(rowgather_sum_counts_topk_bf16, plane, rows, m_f32, amb_read,
                            amb_dS, amb_hit, B=B, K=K, k=k, log_eps=log_eps)


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_counts_topk.launches = 0
rowgather_sum_counts_topk_bf16.launches = 0


# ---- one column shard: the gather, the ambiguous adds and the column finish ----


def rowgather_sum_cols_plain(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                             amb_read, amb_delta, *, K: int, k: int, log_eps: float,
                             col0: int) -> torch.Tensor:
    """Plain version: ``finish_cols_partial_plain(rowgather_sum_plain(plane,
    rows) + delta)``, ``delta`` holding ``amb_delta`` at the rows
    ``amb_read`` and zeros elsewhere."""
    Sp = _with_deltas(rowgather_sum_plain(plane, rows), amb_read, amb_delta)
    return finish_cols_partial_plain(Sp, m_f32, K=K, k=k, log_eps=log_eps, col0=col0)


def rowgather_sum_counts_cols_plain(plane: torch.Tensor, rows: torch.Tensor,
                                    m_f32: torch.Tensor, amb_read, amb_dS, amb_hit, *, K: int,
                                    k: int, log_eps: float, col0: int):
    """Plain version: ``rowgather_sum_counts_plain(plane, rows)``, the first
    hits added (:func:`add_first_hits`), then
    ``finish_cols_partial_counts_plain``: (pack, candidate counts)."""
    S, C = rowgather_sum_counts_plain(plane, rows)
    S, C = add_first_hits(S, C, amb_read, amb_dS, amb_hit)
    return finish_cols_partial_counts_plain(S, C, m_f32, K=K, k=k, log_eps=log_eps, col0=col0)


def cols_smem(plane: torch.Tensor, K: int, counts: bool) -> tuple[int, int]:
    """(bytes of shared memory a :func:`rowgather_sum_cols` launch
    (``counts``: :func:`rowgather_sum_counts_cols`) at the plane's width asks,
    bytes a block of it may take on the plane's card), from the CUDA source's
    own formula (the group layout's shifted or counts form at its G, at B =
    bwl) and the card's opt-in limit less the kernel's static shared memory.
    CUDA planes only."""
    bw = plane.shape[1]
    return _group_layout(plane, bw, min(K, bw), counts)[1:]


def _cols_fit(plane: torch.Tensor, K: int, counts: bool) -> bool:
    if plane.device.type != "cuda":
        return True
    if plane.shape[1] > _MAX_TOPK_B:
        return False
    need, limit = cols_smem(plane, K, counts)
    return need <= limit


def cols_fits(plane: torch.Tensor, K: int) -> bool:
    """Whether :func:`rowgather_sum_cols` takes a shard of the plane's width:
    bwl <= 2**16 (16-bit ids) and a group-layout block of one read at B =
    bwl (bwl sums, the row ids, ceil(bwl / 32) mask words, bwl ids) within
    the card's shared memory (about bwl = 36,400). The plain version on the
    CPU has no limit."""
    return _cols_fit(plane, K, False)


def counts_cols_fits(plane: torch.Tensor, K: int) -> bool:
    """Whether :func:`rowgather_sum_counts_cols` takes a shard of the plane's
    width: bwl <= 2**16 and a group-layout block of one read at B = bwl
    within the card's shared memory (about bwl = 22,000)."""
    return _cols_fit(plane, K, True)


def _check_cols_args(fn, plane, rows, m_f32, K: int, col0: int, amb: dict, amb_read) -> None:
    _check_args(plane, rows, (torch.float32,))
    R, bw = rows.shape[0], plane.shape[1]
    dev = plane.device
    if (m_f32.dtype != torch.float32 or m_f32.shape != (R,) or not m_f32.is_contiguous()
            or m_f32.device != dev):
        raise ValueError(f"m_f32 must be contiguous float32 ({R},) on {dev}, got "
                         f"{m_f32.dtype} {tuple(m_f32.shape)} on {m_f32.device}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K={K} must lie in [1, {MAX_K}]")
    if col0 < 0:
        raise ValueError(f"col0={col0} must be >= 0")
    _check_amb(amb_read, amb, bw, dev)
    if dev.type == "cuda":
        counts = fn is rowgather_sum_counts_cols
        if bw > _MAX_TOPK_B:
            raise ValueError(f"bwl={bw}: {fn.__name__}'s ids are 16 bits (bwl <= {_MAX_TOPK_B})")
        need, limit = cols_smem(plane, K, counts)
        if need > limit:
            raise ValueError(f"bwl={bw}, K={K}: {fn.__name__} asks {need} bytes of shared "
                             f"memory, over the {limit} bytes a block may take on {dev}; run "
                             f"the gather and finish_cols_partial{'_counts' if counts else ''}")


def _sum_cols(fn, plane, rows, m_f32, amb_read, delta, hit, *, K, k, log_eps, col0,
              pair_rows=False):
    R, W = rows.shape
    bw = plane.shape[1]
    Kl = min(K, bw)
    counts = fn is rowgather_sum_counts_cols
    _no_kernel(fn.__name__, plane.device)
    out = torch.empty((R, 2 * Kl + 3), dtype=torch.float32, device=plane.device)
    cnt = torch.empty((R, Kl), dtype=torch.int32, device=plane.device) if counts else None
    if R == 0:
        return out, cnt
    amb, _held = _amb_args(amb_read, delta, R, plane.device)
    perm = None if pair_rows else locality_order(rows)
    G = _group_layout(plane, bw, Kl, counts)[0]
    lib = library()
    head = (plane.data_ptr(), rows.data_ptr(), perm.data_ptr() if perm is not None else None,
            m_f32.data_ptr(), *amb)
    with torch.cuda.device(plane.device):
        if counts:
            err = lib.epik_rowgather_sum_counts_cols(
                *head, hit.data_ptr() if amb[0] is not None else None, out.data_ptr(),
                cnt.data_ptr(), R, W, bw, Kl, col0, k, float(log_eps), G, _stream(plane.device))
        else:
            err = lib.epik_rowgather_sum_cols(*head, out.data_ptr(), R, W, bw, Kl, col0, k,
                                              float(log_eps), G, _stream(plane.device))
    check(err, fn.__name__)
    _count(fn)
    return out, cnt


def rowgather_sum_cols(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                       amb_read, amb_delta, *, K: int, k: int, log_eps: float, col0: int,
                       pair_rows: bool = False) -> torch.Tensor:
    """One shard's shifted f32 plane (n_rows, bwl), rows int32 (R, W), m_f32
    f32 (R,) window counts; ``amb_read`` (A,) the reads with an ambiguous
    first-hit delta row and ``amb_delta`` f32 (A, bwl) those rows (both None
    when there are none); ``col0`` the shard's first global column -> f32
    (R, 2 Kl + 3), the shard's partial pack ``[values Kl | global ids Kl |
    n_s | max_s | e_s]`` with Kl = min(K, bwl).

    Every index must lie in [0, n_rows), misses pointing at an all-zero row;
    ``amb_read`` holds distinct reads. On the card, bwl must be within
    :func:`cols_fits`'s limit (a wider shard raises ValueError). The kernel
    takes the reads in :func:`locality_order`, or in read order where
    ``pair_rows``, G of them a block (:func:`shifted_group` at B = bwl); each
    read's row of the pack is its own."""
    _check_cols_args(rowgather_sum_cols, plane, rows, m_f32, K, col0,
                     {"amb_delta": (amb_delta, torch.float32)}, amb_read)
    kw = dict(K=K, k=k, log_eps=log_eps, col0=col0)
    if plane.device.type == "cpu":
        return rowgather_sum_cols_plain(plane, rows, m_f32, amb_read, amb_delta, **kw)
    return _sum_cols(rowgather_sum_cols, plane, rows, m_f32, amb_read, amb_delta, None,
                     pair_rows=pair_rows, **kw)[0]


def rowgather_sum_counts_cols(plane: torch.Tensor, rows: torch.Tensor, m_f32: torch.Tensor,
                              amb_read, amb_dS, amb_hit, *, K: int, k: int, log_eps: float,
                              col0: int):
    """One shard's classic f32 plane (n_rows, bwl), rows int32 (R, W), m_f32
    f32 (R,) window counts; ``amb_read`` (A,) the reads with an ambiguous
    first hit, ``amb_dS`` f32 (A, bwl) their contributions and ``amb_hit``
    bool (A, bwl) where a hit lands (all three None when there are none);
    ``col0`` the shard's first global column -> (f32 (R, 2 Kl + 3) partial
    pack, int32 (R, Kl) the candidates' exact counts).

    On the card, bwl must be within :func:`counts_cols_fits`'s limit (a wider
    shard raises ValueError). The kernel takes the reads in
    :func:`locality_order`, G of them a block (:func:`counts_group` at B =
    bwl); each read's rows of the outputs are its own."""
    _check_cols_args(rowgather_sum_counts_cols, plane, rows, m_f32, K, col0,
                     {"amb_dS": (amb_dS, torch.float32), "amb_hit": (amb_hit, torch.bool)},
                     amb_read)
    kw = dict(K=K, k=k, log_eps=log_eps, col0=col0)
    if plane.device.type == "cpu":
        return rowgather_sum_counts_cols_plain(plane, rows, m_f32, amb_read, amb_dS, amb_hit,
                                               **kw)
    return _sum_cols(rowgather_sum_counts_cols, plane, rows, m_f32, amb_read, amb_dS, amb_hit,
                     **kw)


#: kernel launches since the last reset (CUDA only; the plain path never counts)
rowgather_sum_cols.launches = 0
rowgather_sum_counts_cols.launches = 0
