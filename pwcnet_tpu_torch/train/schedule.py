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
    A captured train step turns the optimizer ``capturable`` when it is
    made (``make_capturable``).
    """
    cls = torch.optim.Adam if coupled_l2 else torch.optim.AdamW
    opt = cls(params, lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr_at(cfg, count) / cfg.base_lr)
    return opt, sched


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """The form of ``optimizer`` that a captured step (``capture.py``)
    needs, in place, for its groups of CUDA parameters: ``capturable``,
    ``lr`` a 0-d f32 tensor on their device that the scheduler ``fill_``s
    from the host between replays (its base rate stays a float), and each
    ``step`` on the device. It changes Adam's rounding (the bias
    corrections become f32 device arithmetic), so only a captured step
    takes it; ``capturable`` is CUDA-only, so CPU groups stay as they
    are."""
    for group in optimizer.param_groups:
        dev = group["params"][0].device
        if dev.type != "cuda":
            continue
        if not torch.is_tensor(group["lr"]):
            group["lr"] = torch.tensor(float(group["lr"]), device=dev)
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(p.device, torch.float32)


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """``optimizer.load_state_dict(sd)`` across devices: a checkpoint
    written on the card (``capturable``, a tensor ``lr``) loads on the CPU
    and the other way round. ``load_state_dict`` copies the saved options
    over the optimizer's own, so the optimizer's own ``capturable`` and
    ``lr`` type are put back, with ``step`` where that ``capturable`` keeps
    it. The moments, ``step`` and a tensor ``lr`` are copied into the
    optimizer's existing tensors where it has them, so that a captured
    step, which reads those tensors, continues from the loaded state."""
    own = [(g["lr"], g.get("capturable", False))
           for g in optimizer.param_groups]
    before = {p: dict(st) for p, st in optimizer.state.items()}
    optimizer.load_state_dict(sd)
    for group, (lr, capturable) in zip(optimizer.param_groups, own):
        saved_lr = float(group["lr"])
        if torch.is_tensor(lr):
            lr.fill_(saved_lr)
            group["lr"] = lr
        else:
            group["lr"] = saved_lr
        group["capturable"] = capturable
        if torch.is_tensor(group.get("initial_lr")):
            group["initial_lr"] = float(group["initial_lr"])
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")):
                st["step"] = st["step"].to(
                    p.device if capturable else "cpu", torch.float32)
            for k, v in st.items():
                old = before.get(p, {}).get(k)
                if (torch.is_tensor(v) and torch.is_tensor(old)
                        and old.shape == v.shape and old.device == v.device):
                    st[k] = old.copy_(v)


def optimizer_from_config(params: Iterable[torch.nn.Parameter], train_cfg):
    """``make_optimizer`` from a ``TrainConfig``."""
    return make_optimizer(params, train_cfg.schedule, train_cfg.weight_decay,
                          train_cfg.coupled_l2)
