"""Checkpoints of the whole train state (counterpart of
``pwcnet_tpu/train/checkpoint.py``, which uses Orbax).

One file per step, ``<dir>/step_<step>.pt``, written with ``torch.save`` to
a temporary file and moved into place with ``os.replace``, so a crash never
leaves a half-written checkpoint under a checkpoint's name. The newest
``max_to_keep`` are kept. Restoring loads the model, the optimizer's
moments, the scheduler, the generator and the step, so a resumed run
continues exactly. Under several processes only process 0 writes and
prunes, and every process waits at a barrier after a save, so that none
reads a partial directory; every process restores from the same file. The
state holds the model itself, never a ``DistributedDataParallel`` wrapper,
so a checkpoint of several ranks resumes in one process and the other way
round. The weight bridge's ``remap_stem_params`` lives in
``pwcnet_tpu_torch.compat.flax_weights``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch
import torch.distributed as dist

from pwcnet_tpu_torch.parallel.mesh import process_count, process_index
from pwcnet_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                     os.listdir(self._dir))
                      if m)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> str:
        path = self._path(state.step)
        if process_index() == 0:
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                torch.save(state.state_dict(), tmp)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            for old in self.steps()[:-self._keep] if self._keep > 0 else []:
                os.remove(self._path(old))
        if process_count() > 1:
            dist.barrier()
        return path

    def load(self, step: Optional[int] = None) -> dict:
        """The saved state dict of ``step`` (default: the latest), with its
        tensors on the CPU."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load ``step`` (default: the latest) into ``state``, in place."""
        state.load_state_dict(self.load(step))
        return state

    def restore_latest_or(self, state: TrainState) -> TrainState:
        """Resume from the latest checkpoint if there is one, else return
        ``state`` as it is."""
        if self.latest_step is None:
            return state
        return self.restore(state)


def load_model_weights(model: torch.nn.Module, directory: str) -> None:
    """Fill ``model`` from the latest ``step_<n>.pt`` under ``directory``.
    A directory without one (an Orbax checkpoint of the JAX package, say)
    raises ``ValueError``."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"checkpoint directory not found: "
                                f"{directory}")
    mgr = CheckpointManager(directory)
    if mgr.latest_step is None:
        raise ValueError(
            f"{directory} holds no step_<n>.pt of the port's "
            "CheckpointManager; an Orbax checkpoint of the JAX package "
            "needs JAX (convert its params with pwcnet_tpu_torch.compat."
            "load_flax_params)")
    model.load_state_dict(mgr.load()["model"])
