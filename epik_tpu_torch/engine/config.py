"""Placer configuration: the fields of ``epik_tpu.engine.placer.PlacerConfig``.

The port runs three routes (``TorchPlacer``): the dense pair-plane step, the
big-tree posting-tile step and the CSR step. A value that would select a path
not ported yet raises ``NotImplementedError`` naming the ROADMAP.md queue item
that ports it. ``accumulate`` "auto" and "matmul" both mean the kernel-backed
engines on any device; as in the JAX package, only "auto" lets the dense
plane take over.

The memory budgets differ from the JAX package's: its defaults were sizes for
a 16 GiB TPU v5e. Here ``None`` (the default) means "what the device has
free", read at placer construction (:func:`device_budget`).
"""

from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["PlacerConfig", "device_budget", "check_supported"]

#: values each option accepts in the JAX package; the port runs the first
_CHOICES = {
    "accumulate": ("auto", "matmul", "scatter"),
    "dense_db": ("auto", "on", "off"),
    "precision": ("exact", "int16", "bf16"),
    "lookup_where": ("auto", "host", "device"),
    "tokenize_where": ("auto", "device", "host"),
    "plane_mode": ("shifted", "classic"),
    "pair_plane": ("auto", "on", "off"),
    "tile_payload": ("auto", "packed", "f32"),
}

#: option value -> the ROADMAP queue item that will port its path
_NOT_YET = {
    ("accumulate", "scatter"): "queue 1 item 7 (the XLA scatter-add CSR engine)",
    ("precision", "int16"): "queue 1 item 5 (int16 plane)",
    ("precision", "bf16"): "queue 1 item 5 (bf16 plane)",
    ("lookup_where", "device"): "queue 1 item 5 (device-lookup dense variant)",
    ("tokenize_where", "host"): "queue 1 item 5 (_place_batch_dense_rows)",
    ("plane_mode", "classic"): "queue 1 item 5 (classic plane)",
    ("pair_plane", "off"): "queue 1 item 5 (_place_batch_dense_bytes)",
}


@dataclasses.dataclass
class PlacerConfig:
    keep_at_most: int = 7  # reference default: main.cpp:219
    keep_factor: float = 0.01  # reference default: main.cpp:220
    #: CSR posting-budget headroom over the average posting length
    budget_headroom: float = 2.0
    #: CSR minimum padded key-stream size
    min_bucket: int = 16
    accumulate: str = "auto"
    dense_db: str = "auto"
    #: bytes the base plane -- or, when it is not taken, the posting tiles --
    #: may take; None = the device's free memory
    dense_db_budget: int | None = None
    #: host threads for the host tokenizer (ambiguous reads only)
    host_threads: int = 1
    precision: str = "exact"
    lookup_where: str = "auto"
    tokenize_where: str = "auto"
    plane_mode: str = "shifted"
    #: "auto" and "on" both build the pair plane; it must fit the budget
    pair_plane: str = "auto"
    #: bytes the combined (base + pair) plane may take; None = device free
    pair_plane_budget: int | None = None
    #: posting-tile cell layout: "packed" int32 (branch << 16) | q (needs
    #: branch ids < 2**15), "f32" [branch | score-bits] pairs, "auto" packed
    #: when the branch ids fit
    tile_payload: str = "auto"


def check_supported(cfg: PlacerConfig) -> None:
    """Raise ValueError for an unknown value, NotImplementedError for a
    known value whose path the port does not run yet."""
    for field, choices in _CHOICES.items():
        value = getattr(cfg, field)
        if value not in choices:
            raise ValueError(f"{field}={value!r}: expected one of {choices}")
        where = _NOT_YET.get((field, value))
        if where is not None:
            raise NotImplementedError(
                f"{field}={value!r} is not ported yet: ROADMAP.md {where}")


def device_budget(device: torch.device) -> int:
    """Bytes the placer's planes may take on ``device``.

    CUDA: the free device memory less a reserve for a batch's working set
    (the larger of 2 GiB and 1/16 of the card). CPU: half the available RAM.
    """
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return max(0, free - max(2 << 30, total // 16))
    avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    return avail // 2
