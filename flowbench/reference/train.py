"""The reference's training steps: from the benchmark's weights, the same
batches (re-derived by the reference itself), the model's loss, autograd,
and ``torch.optim.AdamW`` at the preset's rate, in plain float32."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from flowbench.reference import pwcnet
from flowbench.reference.losses import multiscale_loss
from flowbench.reference.ops import Precision

Batch = Dict[str, torch.Tensor]


def run_steps(model_cfg: dict, opt: dict, params0: Dict[str, torch.Tensor],
              batch_of: Callable[[int], Batch], steps: int,
              prec: Precision, drop_half: bool = False) -> dict:
    """``steps`` AdamW steps of PWC-Net's multiscale loss from ``params0``
    on ``batch_of(step)``: each step's loss, the first step's gradients and
    the parameters after the last step. ``drop_half`` leaves the second
    half of every batch out (a fault the comparison must catch)."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in params0.items()}
    adam = torch.optim.AdamW(list(params.values()), lr=opt["lr"],
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=opt["weight_decay"])
    losses: List[float] = []
    grads = None
    for step in range(steps):
        b = batch_of(step)
        if drop_half:
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
        adam.zero_grad(set_to_none=True)
        flows = pwcnet.forward(params, model_cfg, b["im1"], b["im2"], prec)
        loss = multiscale_loss(flows, b["flow"], b["valid"],
                               model_cfg["level_weights"],
                               model_cfg["flow_scale"])
        loss.backward()
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in params.items()}
        adam.step()
        losses.append(float(loss.detach()))
        del flows, loss, b
    return {"losses": losses, "grads": grads,
            "params": {k: p.detach() for k, p in params.items()}}
