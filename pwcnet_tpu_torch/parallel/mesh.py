"""The port's process-group mesh (counterpart of
``pwcnet_tpu/parallel/mesh.py``).

JAX builds a device mesh and lets XLA insert the collectives. Here a mesh
is a ``torch.distributed`` process group and this process's place in it: in
the port a device is a process. Two axes are ported, one at a time:

- ``data`` (data parallelism): ``make_mesh`` returns a :class:`DataMesh`
  for ``data > 1``; the train step runs the model under
  ``DistributedDataParallel`` on its group, and ``shard_batch`` /
  ``local_batch_size`` give each rank its rows of a global batch. JAX's
  ``replicate`` is DDP's broadcast of rank 0's parameters at construction,
  so no function stands for it.
- ``spatial`` (image-H sharding, ``parallel/spatial.py``): a
  :class:`SpatialMesh`.

``data > 1`` together with ``spatial > 1`` (ROADMAP A7) and the reserved
``model`` axis above 1 raise. A mesh of one process needs no process group
(a ``SpatialMesh`` of size 1, which every path treats as one process).

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
from typing import Optional

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
class ProcessMesh:
    """A process group (ranks 0..size-1, in shard order), this rank's index
    in it, its size, the device the rank computes on, and the collective
    backend (None when ``size == 1``)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]

    @property
    def stage_on_host(self) -> bool:
        """Whether CUDA tensors go through host memory for an exchange."""
        return self.backend == "gloo" and self.device.type == "cuda"


class SpatialMesh(ProcessMesh):
    """The spatial axis: rank r holds rows [r*H/size, (r+1)*H/size) of
    every image."""


class DataMesh(ProcessMesh):
    """The data axis: rank r holds rows [r*B/size, (r+1)*B/size) of every
    global batch; parameters and optimizer state are replicated."""


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


def make_mesh(cfg: MeshConfig = MeshConfig(), backend: Optional[str] = None,
              device=None) -> ProcessMesh:
    """This process's mesh: a :class:`DataMesh` for ``data > 1``, else a
    :class:`SpatialMesh` (of size 1 for one process). ``data=-1`` means
    ``world // spatial`` processes. More than one process needs the process
    group initialised with exactly ``data * spatial`` processes and an
    explicit ``backend`` ("gloo" or "nccl"). ``device`` is where this rank
    computes (``rank_device``); a data mesh makes it the current CUDA
    device, where the kernels launch."""
    if cfg.model != 1:
        raise NotImplementedError("the model axis is reserved and must be 1")
    device = rank_device(device)
    world = process_count()
    data = cfg.data
    if data == -1:
        if world % cfg.spatial:
            raise ValueError(f"{world} processes not divisible by "
                             f"spatial={cfg.spatial}")
        data = world // cfg.spatial
    if data > 1 and cfg.spatial > 1:
        raise NotImplementedError("data and spatial sharding together are "
                                  "not ported yet (ROADMAP A7)")
    size = data * cfg.spatial
    if size == 1:
        return SpatialMesh(None, 0, 1, device, None)
    if world != size:
        raise ValueError(f"data={data}, spatial={cfg.spatial} needs {size} "
                         f"processes in the group, have {world}")
    if backend not in BACKENDS:
        raise ValueError(f"a mesh of {size} processes needs backend 'gloo' "
                         f"or 'nccl', got {backend!r}")
    if backend == "nccl":
        _one_card_per_rank(device, size)
    if data > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        group = None if dist.get_backend() == backend else dist.new_group(
            backend=backend)
        return DataMesh(group, dist.get_rank(), size, device, backend)
    group = dist.new_group(list(range(size)), backend=backend)
    dist.barrier(group)  # every rank joins before the first point-to-point
    return SpatialMesh(group, dist.get_rank(), size, device, backend)


def local_batch_size(global_batch: int, mesh: Optional[ProcessMesh]) -> int:
    """The rows of a global batch that each rank of ``mesh`` takes."""
    n = 1 if mesh is None else mesh.size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"{n} data-parallel processes")
    return global_batch // n


def shard_batch(mesh: Optional[ProcessMesh], batch: dict) -> dict:
    """This rank's rows ``[r*b/p, (r+1)*b/p)`` of every array of a global
    batch (a dict of numpy arrays or tensors, on the host or a device);
    the batch itself for one process."""
    if mesh is None or mesh.size == 1:
        return batch
    n = {len(v) for v in batch.values()}
    if len(n) != 1:
        raise ValueError(f"batch arrays differ in rows: {sorted(n)}")
    b = local_batch_size(n.pop(), mesh)
    return {k: v[mesh.rank * b:(mesh.rank + 1) * b]
            for k, v in batch.items()}
