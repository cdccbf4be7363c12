"""The device mesh of the port's multi-device placement.

Ports ``epik_tpu/parallel/mesh.py``: :func:`make_mesh`, a ``(data, model)``
grid of devices; :func:`init_distributed`, the multi-process start; and
:class:`BatchWatchdog` with :data:`STALL_EXIT_CODE`. Axis ``"data"`` splits a
batch's reads into contiguous groups, one per mesh row; axis ``"model"``
splits the database by branch columns (the dense planes, the posting tiles)
or by key hash (the CSR tables), one shard per mesh column.

One process drives every device of its mesh cells; the collectives of the JAX
package's ``shard_map`` steps become sums, maxima and concatenations over the
shards' tensors in shard order (``sharding.py``). Across processes
(:func:`init_distributed` first): each process contributes its local devices,
in rank order, to one global grid, as JAX's ``make_mesh`` lays out the global
device list, and owns the cells its devices fill. A mesh row (a model group)
may span processes: each rank runs the kernels of the shards it holds, and
the row's ranks exchange the shards' partial results before the merge
(``exchange.py``, one gloo group a spanning row), so that each rank of the
row merges every shard in shard order. Each row's lowest rank (its lead)
contributes the merged pack, and the placer all-gathers the rows' host packs
so that every rank holds the whole batch
(``sharding.py::ShardedTorchPlacer._fetch``, JAX's ``process_allgather``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import threading
import time

import torch

__all__ = ["BatchWatchdog", "CollectiveError", "DATA_AXIS", "MODEL_AXIS", "Mesh", "STALL_EXIT_CODE",
           "collective_timeout", "init_distributed", "make_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: process exit code of a watchdog-detected collective stall -- distinct
#: from ordinary failures so a supervisor can restart the rank with
#: ``--resume`` (the per-batch jplace sidecar makes restart cheap)
STALL_EXIT_CODE = 42


class CollectiveError(RuntimeError):
    """A collective across processes failed: a peer process died or could
    not be reached. Like a stall, the job restarts with ``--resume``."""


class BatchWatchdog:
    """Fail-fast guard for multi-process collectives.

    A dead rank leaves the others blocked inside a collective, which Python
    cannot interrupt. ``arm()`` before each batch, ``disarm()`` after; a
    monitor thread that sees a batch exceed ``timeout_s`` prints a diagnosis
    and hard-exits the process with :data:`STALL_EXIT_CODE`, so that a
    supervisor can restart the job, which then resumes from the jplace
    sidecar (``io/jplace.py``; ``tests/test_torch_multihost.py::
    test_kill_restart_resume``)."""

    def __init__(self, timeout_s: float, rank: int | None = None, _exit=os._exit):
        self.timeout_s = float(timeout_s)
        self.rank = rank
        self._exit = _exit  # injectable for unit tests
        self._deadline: float | None = None
        self._tag = ""
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    def arm(self, tag: str = "") -> None:
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._tag = tag

    def disarm(self) -> None:
        with self._lock:
            self._deadline = None

    def stop(self) -> None:
        self._stop = True

    @contextlib.contextmanager
    def guard(self, tag: str = ""):
        """Armed around the body; a :class:`CollectiveError` inside it (a peer
        that died mid-collective, which gloo reports as a broken connection
        rather than a hang) exits with :data:`STALL_EXIT_CODE` as a stall
        does."""
        self.arm(tag)
        try:
            yield
        except CollectiveError as e:
            who = f"rank {self.rank}" if self.rank is not None else "rank"
            print(f"COLLECTIVE FAILURE: {who} step {tag!r}: {e} -- exiting "
                  f"{STALL_EXIT_CODE} for supervised restart (resume from the jplace "
                  f"sidecar)", file=sys.stderr, flush=True)
            self._exit(STALL_EXIT_CODE)
            raise
        finally:
            self.disarm()

    def _monitor(self) -> None:
        while not self._stop:
            time.sleep(min(1.0, self.timeout_s / 4))
            with self._lock:
                dl, tag = self._deadline, self._tag
            if dl is not None and time.monotonic() > dl:
                who = f"rank {self.rank}" if self.rank is not None else "rank"
                print(
                    f"COLLECTIVE STALL: {who} step {tag!r} exceeded "
                    f"{self.timeout_s:.0f}s -- a peer process is likely "
                    f"dead; exiting {STALL_EXIT_CODE} for supervised "
                    f"restart (resume from the jplace sidecar)",
                    file=sys.stderr,
                    flush=True,
                )
                self._exit(STALL_EXIT_CODE)
                return


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``(n_data, n_model)`` grid of ``torch.device``; ``devices[d][m]``
    runs model shard ``m`` of data group ``d``. ``owners[d][m]`` is the rank
    of the process that owns cell ``(d, m)`` (empty: one process owns every
    cell), and ``rank`` this process's; a cell another process owns names
    that process's device and is never touched here."""

    devices: tuple[tuple[torch.device, ...], ...]
    owners: tuple[tuple[int, ...], ...] = ()
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` gives them."""
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def owner(self, d: int, m: int) -> int:
        """The rank that runs shard ``m`` of data group ``d``."""
        return self.owners[d][m] if self.owners else self.rank

    def local_shards(self, d: int) -> tuple[int, ...]:
        """The model shards of data group ``d`` this process holds."""
        return tuple(m for m in range(len(self.devices[d])) if self.owner(d, m) == self.rank)

    def row_ranks(self, d: int) -> tuple[int, ...]:
        """The ranks that hold a shard of data group ``d``, ascending."""
        return tuple(sorted({self.owner(d, m) for m in range(len(self.devices[d]))}))

    def lead(self, d: int) -> int:
        """The rank that contributes data group ``d``'s pack: its lowest."""
        return self.row_ranks(d)[0]

    @property
    def local_rows(self) -> tuple[int, ...]:
        """The data groups this process holds a shard of, in group order."""
        return tuple(d for d in range(len(self.devices)) if self.local_shards(d))

    @property
    def multi_process(self) -> bool:
        return len({r for row in self.owners for r in row}) > 1


def _indexed(device) -> torch.device:
    """``cuda`` names the current card, so that ``cuda`` and ``cuda:0`` are
    one device of the mesh; a CUDA device without CUDA raises."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _world() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a ``(data, model)`` mesh over ``devices`` in row-major order.

    Default devices: every CUDA device; without CUDA this raises, so nothing
    moves to the CPU unasked. ``n_data`` defaults to ``len(devices) //
    n_model``. A device may repeat, e.g. ``[torch.device("cpu")] * 8`` or
    ``[torch.device("cuda:0")] * 4``: the analog of JAX's virtual host
    devices (``--xla_force_host_platform_device_count``), for tests on the
    CPU and for a 1x4 mesh laid on one card.

    After :func:`init_distributed`, ``devices`` are this process's own, and
    the mesh is laid over every process's devices in rank order (JAX's
    global device list); a mesh row may hold the devices of several
    processes. A process that holds no cell of the mesh raises ValueError:
    it would sit outside every collective."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= to build a "
                               "mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    rank, world = _world()
    owner = [rank] * len(devices)
    if world > 1:
        import torch.distributed as dist

        every = [None] * world
        dist.all_gather_object(every, [str(d) for d in devices])
        local, devices, owner = devices, [], []
        for r, names in enumerate(every):
            devices += local if r == rank else [torch.device(n) for n in names]
            owner += [r] * len(names)
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
    owners = tuple(tuple(owner[d * n_model:(d + 1) * n_model]) for d in range(n_data))
    held = {r for row in owners for r in row}
    if world > 1 and len(held) < world:
        raise ValueError(f"mesh {n_data}x{n_model} over {world} processes: ranks "
                         f"{sorted(set(range(world)) - held)} own no model group: they hold "
                         f"no shard of the mesh")
    return Mesh(tuple(tuple(devices[d * n_model:(d + 1) * n_model]) for d in range(n_data)),
                owners if world > 1 else (), rank)


#: the collective time limit :func:`init_distributed` was given (None: torch's default)
_timeout: datetime.timedelta | None = None


def collective_timeout() -> datetime.timedelta | None:
    """The time limit of the job's collectives, for the groups made after
    :func:`init_distributed` (``dist.new_group`` does not inherit it)."""
    return _timeout


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     initialization_timeout: float | None = None) -> None:
    """Join the multi-process job: ``torch.distributed`` over gloo, with the
    coordinator (rank 0 serves it) at ``host:port``.

    Gloo, not NCCL: the exchanges across processes are the all-gather of the
    placed batch's host packs (JAX's ``process_allgather`` on numpy arrays)
    and, on a row that spans processes, the model-axis exchange of the
    shards' partial results (``exchange.py``), both staged through host
    memory; gloo runs on the CPU, and lets two ranks share one card, which
    NCCL refuses. ``initialization_timeout`` (seconds) bounds the start and
    every collective, the row groups' too, so that a rank that never starts
    surfaces as an error. A failure to join raises."""
    import torch.distributed as dist

    global _timeout
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, the number of "
                         "processes and this process's id")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    _timeout = kw.get("timeout")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), **kw)
