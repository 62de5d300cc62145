"""The port's process-group mesh (counterpart of
``pwcnet_tpu/parallel/mesh.py``).

JAX builds a device mesh and lets XLA insert the collectives. Here a mesh
is a ``torch.distributed`` process group and this process's place in it.
Only the ``spatial`` axis (image-H sharding, ``parallel/spatial.py``) is
ported: ``data > 1`` is data parallelism (ROADMAP A6), and the reserved
``model`` axis stays at 1.

The caller chooses the collective backend. Under ``"gloo"`` the exchanges
stage CUDA tensors through host memory (several ranks may then share one
card); under ``"nccl"`` they stay on the device (one card per rank). A mesh
with one spatial shard needs no process group at all.
"""

from __future__ import annotations

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
class SpatialMesh:
    """The spatial process group (the processes of ranks 0..size-1, in
    shard order), this rank's index in it, its size, the device the rank
    computes on, and the collective backend (None when ``size == 1``)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]

    @property
    def stage_on_host(self) -> bool:
        """Whether CUDA tensors go through host memory for an exchange."""
        return self.backend == "gloo" and self.device.type == "cuda"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Join the process group (a no-op for one process). ``coordinator``
    is ``host:port`` of rank 0, e.g. ``localhost:29500``."""
    if num_processes is not None and num_processes > 1:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)


def make_mesh(cfg: MeshConfig = MeshConfig(), backend: Optional[str] = None,
              device=None) -> SpatialMesh:
    """The spatial mesh of this process. ``spatial > 1`` needs the process
    group initialised with exactly ``spatial`` processes and an explicit
    ``backend`` ("gloo" or "nccl") for the spatial group. ``device`` is
    where this rank computes: None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if cfg.model != 1:
        raise NotImplementedError("the model axis is reserved and must be 1")
    world = dist.get_world_size() if dist.is_initialized() else 1
    data = cfg.data
    if data == -1:
        if world % cfg.spatial:
            raise ValueError(f"{world} processes not divisible by "
                             f"spatial={cfg.spatial}")
        data = world // cfg.spatial
    if data != 1:
        raise NotImplementedError("data parallelism (data > 1) is not ported "
                                  "yet (ROADMAP A6)")
    if cfg.spatial == 1:
        return SpatialMesh(None, 0, 1, device, None)
    if world != cfg.spatial:
        raise ValueError(f"spatial={cfg.spatial} needs {cfg.spatial} "
                         f"processes in the group, have {world}")
    if backend not in BACKENDS:
        raise ValueError(f"a spatial mesh needs backend 'gloo' or 'nccl', "
                         f"got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    group = dist.new_group(list(range(cfg.spatial)), backend=backend)
    dist.barrier(group)  # every rank joins before the first point-to-point
    return SpatialMesh(group, dist.get_rank(), cfg.spatial, device, backend)
