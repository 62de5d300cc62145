"""Learning-rate schedules and the optimizer (counterpart of
``pwcnet_tpu/train/schedule.py``).

The paper's step schedules: S_long (lr 1e-4, halved at 400k/600k/800k/1M of
1.2M steps) and S_fine (lr 1e-5, halved at 200k/300k/400k/500k of 600k).
The rate follows optax's ``piecewise_constant_schedule``: it is scaled by
``gamma`` for each milestone m with ``count >= m``, and the first update
uses count 0. A linear warmup joins as ``optax.join_schedules`` joins it
(the step schedule's count starts again at 0 after the warmup).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

import torch


@dataclass(frozen=True)
class ScheduleConfig:
    base_lr: float = 1e-4
    milestones: Tuple[int, ...] = (400_000, 600_000, 800_000, 1_000_000)
    gamma: float = 0.5
    total_steps: int = 1_200_000
    warmup_steps: int = 0


S_LONG = ScheduleConfig()
S_FINE = ScheduleConfig(base_lr=1e-5,
                        milestones=(200_000, 300_000, 400_000, 500_000),
                        total_steps=600_000)


def lr_at(cfg: ScheduleConfig, count: int) -> float:
    """The rate of the update with optax count ``count`` (0 for the first)."""
    if cfg.warmup_steps:
        if count < cfg.warmup_steps:
            return cfg.base_lr * count / cfg.warmup_steps
        count -= cfg.warmup_steps
    lr = cfg.base_lr
    for m in sorted(cfg.milestones):
        if count >= m:
            lr *= cfg.gamma
    return lr


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: ScheduleConfig,
                   weight_decay: float = 4e-4, coupled_l2: bool = False):
    """Adam with weight decay and the milestone schedule; returns
    ``(optimizer, scheduler)``. Step the scheduler once after each
    ``optimizer.step()``.

    Decoupled (default) is ``optax.adamw``: ``torch.optim.AdamW``.
    ``coupled_l2`` is optax's ``add_decayed_weights`` + ``adam``, i.e.
    ``torch.optim.Adam(weight_decay=...)``, the reference's optimizer.
    Gradient clipping (``grad_clip``) is applied by the train step.
    """
    cls = torch.optim.Adam if coupled_l2 else torch.optim.AdamW
    opt = cls(params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr_at(cfg, count) / cfg.base_lr)
    return opt, sched


def optimizer_from_config(params: Iterable[torch.nn.Parameter], train_cfg):
    """``make_optimizer`` from a ``TrainConfig``."""
    return make_optimizer(params, train_cfg.schedule, train_cfg.weight_decay,
                          train_cfg.coupled_l2)
