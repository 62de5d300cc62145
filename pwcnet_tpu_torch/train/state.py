"""Train state: what a step advances and a checkpoint saves (counterpart of
``pwcnet_tpu/train/state.py``).

The JAX state is a pytree of (step, params, opt_state, rng). Here it holds
the step, the model, the optimizer with its moments, the LR scheduler and a
``torch.Generator`` in place of the PRNG key (for the augmentation, which
the device-generated synthetic batches do not use).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from pwcnet_tpu_torch.train.schedule import load_optimizer_state


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer, scheduler,
               seed: int) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer,
                   scheduler=scheduler,
                   generator=torch.Generator().manual_seed(seed))

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        load_optimizer_state(self.optimizer, sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        self.generator.set_state(sd["generator"])
