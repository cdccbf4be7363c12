"""The device mesh of the port's multi-device placement.

Ports ``epik_tpu/parallel/mesh.py::make_mesh``: a ``(data, model)`` grid of
devices. Axis ``"data"`` splits a batch's reads into contiguous groups, one
per mesh row; axis ``"model"`` splits the database by branch columns (the
dense planes, the posting tiles) or by key hash (the CSR tables), one shard
per mesh column.

One process drives every device of the mesh, as JAX's single controller
does; the collectives of the JAX package's ``shard_map`` steps become sums,
maxima and concatenations over the shards' tensors in shard order
(``sharding.py``). Multi-host placement (``init_distributed``,
``BatchWatchdog``) is not ported yet: ROADMAP.md queue 1 item 9b.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``(n_data, n_model)`` grid of ``torch.device``; ``devices[d][m]``
    runs model shard ``m`` of data group ``d``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}


def _indexed(device) -> torch.device:
    """``cuda`` names the current card, so that ``cuda`` and ``cuda:0`` are
    one device of the mesh; a CUDA device without CUDA raises."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a ``(data, model)`` mesh over ``devices`` in row-major order.

    Default devices: every CUDA device; without CUDA this raises, so nothing
    moves to the CPU unasked. ``n_data`` defaults to ``len(devices) //
    n_model``. A device may repeat, e.g. ``[torch.device("cpu")] * 8`` or
    ``[torch.device("cuda:0")] * 4``: the analog of JAX's virtual host
    devices (``--xla_force_host_platform_device_count``), for tests on the
    CPU and for a 1x4 mesh laid on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a "
                               "mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    n_dev = len(devices)
    if n_model < 1:
        raise ValueError(f"n_model={n_model} must be >= 1")
    if n_data is None:
        if n_dev % n_model:
            raise ValueError(f"{n_dev} devices not divisible by n_model={n_model}")
        n_data = n_dev // n_model
    if n_data < 1 or n_data * n_model > n_dev:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {n_dev}")
    return Mesh(tuple(tuple(devices[d * n_model:(d + 1) * n_model])
                      for d in range(n_data)))
