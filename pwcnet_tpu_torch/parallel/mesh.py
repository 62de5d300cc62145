"""The port's process-group mesh (counterpart of
``pwcnet_tpu/parallel/mesh.py``).

JAX builds a device mesh and lets XLA insert the collectives. Here a device
is a process, and a mesh is this process's place in a (data, spatial,
model) grid of ``torch.distributed`` processes, in JAX's device order:
rank ``(d * S + s) * M + m`` holds data index d, spatial index s and model
index m (``devices.reshape(data, spatial, model)``). ``make_mesh`` returns
a :class:`GridMesh` for every shape. It holds three process groups:

- the **data group**: the ranks of this rank's spatial and model index.
  The grid along it (:attr:`GridMesh.data_mesh`) is what
  ``shard_batch``, ``local_batch_size``, the loaders and the eval step read:
  rank r of D takes rows ``[r*B/D, (r+1)*B/D)`` of every global batch.
- the **spatial group**: the ranks of this rank's data and model index.
  The grid along it (:attr:`GridMesh.spatial_mesh`) shards image H for
  ``parallel/spatial.py``.
- the **world group**, over which the train step runs
  ``DistributedDataParallel``. The train step replicates over ``spatial``
  and ``model``, as JAX's ``shard_map`` step does: every replica of a data
  row computes the same step on the same rows.

JAX's ``replicate`` is DDP's broadcast of rank 0's parameters at
construction, so no function stands for it. The ``model`` axis is JAX's
reserved tensor-parallel axis: nothing is sharded over it, its ranks are
replicas. A mesh of one process needs no process group.

The caller chooses the collective backend. Under ``"gloo"`` the
collectives stage CUDA tensors through host memory (several ranks may then
share one card); under ``"nccl"`` they stay on the device, one card per
rank: two ``nccl`` ranks on one card raise. The choice is never made
silently.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes per axis; ``data=-1`` means "all remaining processes"."""
    data: int = -1
    spatial: int = 1
    model: int = 1


@dataclass(frozen=True)
class GridMesh:
    """A group of processes as a (data, spatial, model) grid of ``shape``,
    and this rank's place in it. ``group`` (None: the default group),
    ``rank`` and ``size`` are the grid's own, ``ranks`` its members' ranks
    in the default group in grid order (None: the same as their indices),
    ``device`` where this rank computes and ``backend`` the collective
    backend (None when ``size == 1``). ``data_group`` and
    ``spatial_group`` are this rank's groups along those axes (None where
    the axis has size 1), with their members' default-group ranks in
    ``data_ranks`` and ``spatial_ranks``. A grid along one axis only
    (:meth:`line`) is what the ops on that axis take: the data axis's rank
    r of D holds rows ``[r*B/D, (r+1)*B/D)`` of every global batch, the
    spatial axis's rank r of S rows ``[r*H/S, (r+1)*H/S)`` of every
    image."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    ranks: Optional[Tuple[int, ...]] = None
    shape: Tuple[int, int, int] = (1, 1, 1)
    data_group: Optional[object] = None
    spatial_group: Optional[object] = None
    data_ranks: Tuple[int, ...] = (0,)
    spatial_ranks: Tuple[int, ...] = (0,)

    @classmethod
    def line(cls, axis: int, group, rank: int, size: int, device,
             backend: Optional[str], ranks: Optional[Tuple[int, ...]] = None
             ) -> "GridMesh":
        """The grid of ``size`` processes along ``axis`` alone (0 data, 1
        spatial): ``group`` and ``ranks`` are both the grid's and the
        axis's."""
        members = tuple(range(size)) if ranks is None else tuple(ranks)
        shape, groups = [1, 1, 1], [None, None]
        lines = [(members[rank],)] * 2
        shape[axis], groups[axis], lines[axis] = size, group, members
        return cls(group, rank, size, torch.device(device), backend, ranks,
                   tuple(shape), *groups, *lines)

    @property
    def stage_on_host(self) -> bool:
        """Whether CUDA tensors go through host memory for an exchange."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def global_rank(self, index: int) -> int:
        """The default group's rank of this grid's member ``index`` (the
        peer of a point-to-point operation)."""
        return index if self.ranks is None else self.ranks[index]

    @property
    def data_index(self) -> int:
        return self.rank // (self.shape[1] * self.shape[2])

    @property
    def spatial_index(self) -> int:
        return self.rank // self.shape[2] % self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[2]

    @property
    def data_mesh(self) -> "GridMesh":
        """The data axis through this rank."""
        return self._line(0, self.data_group, self.data_index,
                          self.data_ranks)

    @property
    def spatial_mesh(self) -> "GridMesh":
        """The spatial axis through this rank."""
        return self._line(1, self.spatial_group, self.spatial_index,
                          self.spatial_ranks)

    def _line(self, axis, group, index, ranks) -> "GridMesh":
        n = self.shape[axis]
        return GridMesh.line(axis, group, index, n, self.device,
                             self.backend if n > 1 else None, ranks)


def grid_ranks(shape: Tuple[int, int, int], axis: int, rank: int
               ) -> Tuple[int, ...]:
    """The world ranks along ``axis`` (0 data, 1 spatial, 2 model) through
    ``rank`` of a grid of ``shape``, in index order (JAX's device order:
    rank = (d * S + s) * M + m)."""
    idx = list(np.unravel_index(rank, shape))
    out = []
    for i in range(shape[axis]):
        idx[axis] = i
        out.append(int(np.ravel_multi_index(idx, shape)))
    return tuple(out)


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Join the process group. ``coordinator`` is ``host:port`` of rank 0,
    e.g. ``localhost:29500``, with ``num_processes`` and this process's
    ``process_id`` (JAX's arguments). Where they are unset and the
    environment names a world of more than one process (``WORLD_SIZE``,
    as ``torchrun`` sets it), the group joins through ``env://``. A group
    that is already initialised is used as it is; one process needs none."""
    if dist.is_initialized():
        return
    if num_processes is None and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        _check_backend_name(backend)
        dist.init_process_group(backend, init_method="env://")
    elif num_processes is not None and num_processes > 1:
        _check_backend_name(backend)
        if coordinator is None or process_id is None:
            raise ValueError(f"num_processes={num_processes} needs the "
                             "coordinator (host:port of rank 0) and this "
                             "process's process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)


def _check_backend_name(backend) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def rank_device(device=None) -> torch.device:
    """Where this rank computes: ``device`` as given, except that None or
    an unnumbered ``"cuda"`` means ``cuda:{local_rank % device_count}``,
    with ``local_rank`` from ``LOCAL_RANK`` where set, else this process's
    rank."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _one_card_per_rank(device: torch.device, size: int) -> None:
    """Raise where two ``nccl`` ranks would share a card: every rank sends
    (host, card) over a ``gloo`` group, before any NCCL communicator
    exists."""
    if device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device per rank, "
                         f"got {device}; use backend='gloo'")
    gloo = None if dist.get_backend() == "gloo" else dist.new_group(
        backend="gloo")
    places = [None] * size
    dist.all_gather_object(places, (socket.gethostname(), device.index),
                           group=gloo)
    if len(set(places)) < size:
        raise ValueError(f"{size} nccl ranks share {len(set(places))} "
                         "card(s), and NCCL needs one card per rank; use "
                         "backend='gloo' to run several ranks on one card")


def _axis_groups(shape: Tuple[int, int, int], axis: int, backend: str,
                 rank: int):
    """Every group along ``axis`` (created on every rank, in one order:
    ``dist.new_group`` is collective); returns this rank's."""
    mine = None
    if shape[axis] == 1:
        return None
    for r in range(int(np.prod(shape))):
        ranks = grid_ranks(shape, axis, r)
        if ranks[0] != r:
            continue  # each line of the grid once, from its first rank
        group = dist.new_group(list(ranks), backend=backend)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(cfg: MeshConfig = MeshConfig(), backend: Optional[str] = None,
              device=None) -> GridMesh:
    """This process's place in the (data, spatial, model) grid of ``cfg``.
    ``data=-1`` means ``world // (spatial * model)`` processes. More than
    one process needs the process group initialised with exactly ``data *
    spatial * model`` processes and an explicit ``backend`` ("gloo" or
    "nccl"). ``device`` is where this rank computes (``rank_device``); a
    mesh of several processes makes it the current CUDA device, where the
    kernels launch. Every rank creates every group, in the same order."""
    device = rank_device(device)
    world = process_count()
    if cfg.spatial < 1 or cfg.model < 1:
        raise ValueError(f"spatial and model must be >= 1, got {cfg}")
    data = cfg.data
    if data == -1:
        if world % (cfg.spatial * cfg.model):
            raise ValueError(f"{world} processes not divisible by "
                             f"spatial*model={cfg.spatial * cfg.model}")
        data = world // (cfg.spatial * cfg.model)
    shape = (data, cfg.spatial, cfg.model)
    size = data * cfg.spatial * cfg.model
    if size == 1:
        return GridMesh(None, 0, 1, device, None)
    if world != size:
        raise ValueError(f"data={data}, spatial={cfg.spatial}, model="
                         f"{cfg.model} needs {size} processes in the group, "
                         f"have {world}")
    if backend not in BACKENDS:
        raise ValueError(f"a mesh of {size} processes needs backend 'gloo' "
                         f"or 'nccl', got {backend!r}")
    if backend == "nccl":
        _one_card_per_rank(device, size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rank = dist.get_rank()
    world_group = None if dist.get_backend() == backend else dist.new_group(
        backend=backend)
    data_group = _axis_groups(shape, 0, backend, rank)
    spatial_group = _axis_groups(shape, 1, backend, rank)
    dist.barrier(world_group)  # every group exists before the first exchange
    return GridMesh(world_group, rank, size, device, backend, None, shape,
                    data_group, spatial_group, grid_ranks(shape, 0, rank),
                    grid_ranks(shape, 1, rank))


def local_batch_size(global_batch: int, mesh: Optional[GridMesh]) -> int:
    """The rows of a global batch that each rank of ``mesh`` takes: the
    batch over the mesh's data axis."""
    n = 1 if mesh is None else mesh.data_mesh.size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"{n} data-parallel processes")
    return global_batch // n


def shard_batch(mesh: Optional[GridMesh], batch: dict) -> dict:
    """This rank's rows ``[r*b/p, (r+1)*b/p)`` of every array of a global
    batch (a dict of numpy arrays or tensors, on the host or a device), r
    and p this rank's data index and the data axis's size; the batch itself
    where the data axis has one process."""
    if mesh is None or mesh.data_mesh.size == 1:
        return batch
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch arrays differ in rows: {sorted(n)}")
    b = local_batch_size(n.pop(), mesh)
    r = mesh.data_mesh.rank
    return {k: v[r * b:(r + 1) * b]
            for k, v in batch.items()}
