"""PWC-Net's multiscale training loss (the paper's section 4): per level
alpha_l times the per-pixel L2 norm of the error summed over the pixels
(mean over valid fraction x H x W where a validity mask is given),
averaged over the batch. The level's ground truth is the full-resolution
flow shrunk by the antialiased bilinear resize, mask-weighted, divided by
``flow_scale``."""

from __future__ import annotations

from typing import List, Sequence

import torch

from flowbench.reference.ops import downsample


def multiscale_loss(flows: List[torch.Tensor], gt: torch.Tensor,
                    valid: torch.Tensor, weights: Sequence[float],
                    flow_scale: float) -> torch.Tensor:
    total = gt.new_zeros(())
    for flow, wt in zip(flows, weights):
        hw = tuple(flow.shape[1:3])
        v = downsample(valid, hw)
        g = downsample(gt * valid[..., None], hw) / v.clamp_min(1e-6)[
            ..., None] / flow_scale
        diff = flow - g
        mag = torch.sqrt((diff * diff).sum(-1) + 1e-16)
        num = (mag * v).sum((1, 2))
        den = v.sum((1, 2)).clamp_min(1.0)
        total = total + wt * (num / den * hw[0] * hw[1]).mean()
    return total
