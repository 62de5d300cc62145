"""Multi-scale training losses and the EPE metric (counterpart of
``pwcnet_tpu/losses.py``).

- ``multiscale_loss``: sum_l alpha_l * ||flow_l - gt_l||_2 with the PWC-Net
  paper's level weights (coarsest first ``0.32, 0.08, 0.02, 0.01, 0.005``);
  the L2 norm per pixel, summed over pixels, averaged over the batch.
- ``robust_loss``: the fine-tuning loss (|Delta|_1 + eps)^q, q = 0.4,
  eps = 0.01.
- ``sequence_loss``: RAFT's gamma-weighted L1 over its per-iteration
  flows.
- ``epe``: mean end-point error with an optional validity mask;
  ``fl_outliers``: the KITTI Fl outlier indicator.

Per-level ground truth is the full-resolution flow downsampled with the
antialiased bilinear resize of ``jax.image.resize``
(``ops.resize.downsample_bilinear``), divided by ``flow_scale``. Layouts are
NHWC; everything is computed in f32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from pwcnet_tpu_torch.ops.resize import downsample_bilinear

# Coarsest-first level weights (PWC-Net paper, section 4).
LEVEL_WEIGHTS: Tuple[float, ...] = (0.32, 0.08, 0.02, 0.01, 0.005)


def _weights_for(flows: List[torch.Tensor],
                 weights: Sequence[float]) -> Sequence[float]:
    """One weight per predicted level: extra fine levels reuse the finest
    weight (a level is never dropped silently)."""
    n = len(flows)
    if len(weights) >= n:
        return tuple(weights[:n])
    return tuple(weights) + (weights[-1],) * (n - len(weights))


def downsample_gt(gt: torch.Tensor, hw: Tuple[int, int],
                  flow_scale: float = 20.0,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-resolution GT flow (N, H, W, 2) -> ``hw`` in scaled units.

    With a validity mask (N, H, W) the GT is downsampled mask-weighted:
    each coarse pixel is the average of the valid fine pixels under its
    kernel, and the returned weight is the (continuous) valid fraction.
    """
    if valid is None:
        return downsample_bilinear(gt.float(), hw) / flow_scale, None
    v = valid.float()
    v_l = downsample_bilinear(v, hw)
    gt_w = downsample_bilinear(gt.float() * v[..., None], hw)
    gt_l = gt_w / torch.clamp(v_l, min=1e-6)[..., None]
    return gt_l / flow_scale, v_l


def _masked_pixel_sum(per_pixel: torch.Tensor,
                      valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-level term: sum over (H, W), mean over the batch; with a
    (fractional) validity weight, ``mean over valid * H * W``."""
    if valid is None:
        return per_pixel.sum((1, 2)).mean()
    hw = per_pixel.shape[1] * per_pixel.shape[2]
    num = (per_pixel * valid).sum((1, 2))
    den = torch.clamp(valid.sum((1, 2)), min=1.0)
    return (num / den * hw).mean()


def multiscale_loss(flows: List[torch.Tensor], gt: torch.Tensor,
                    valid: Optional[torch.Tensor] = None,
                    weights: Sequence[float] = LEVEL_WEIGHTS,
                    flow_scale: float = 20.0) -> torch.Tensor:
    """The paper's training loss over the coarsest-first flow list."""
    total = gt.new_zeros((), dtype=torch.float32)
    for flow_l, w in zip(flows, _weights_for(flows, weights)):
        gt_l, v_l = downsample_gt(gt, tuple(flow_l.shape[1:3]), flow_scale,
                                  valid)
        diff = flow_l.float() - gt_l
        mag = torch.sqrt((diff * diff).sum(-1) + 1e-16)
        total = total + w * _masked_pixel_sum(mag, v_l)
    return total


def robust_loss(flows: List[torch.Tensor], gt: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                weights: Sequence[float] = LEVEL_WEIGHTS,
                flow_scale: float = 20.0, eps: float = 0.01,
                q: float = 0.4) -> torch.Tensor:
    """Fine-tuning loss: (|Delta|_1 + eps)^q per pixel."""
    total = gt.new_zeros((), dtype=torch.float32)
    for flow_l, w in zip(flows, _weights_for(flows, weights)):
        gt_l, v_l = downsample_gt(gt, tuple(flow_l.shape[1:3]), flow_scale,
                                  valid)
        diff = (flow_l.float() - gt_l).abs().sum(-1)
        total = total + w * _masked_pixel_sum((diff + eps) ** q, v_l)
    return total


def epe(pred: torch.Tensor, gt: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean end-point error of (N, H, W, 2) pixel flows; with ``valid``
    (N, H, W) the mean runs over valid pixels only."""
    diff = pred.float() - gt.float()
    dist = torch.sqrt((diff * diff).sum(-1) + 1e-16)
    if valid is None:
        return dist.mean()
    v = valid.float()
    return (dist * v).sum() / torch.clamp(v.sum(), min=1.0)


def fl_outliers(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """KITTI Fl outlier indicator per pixel: EPE > 3 px and EPE > 5% of
    the GT magnitude. (..., 2) pixel flows -> (...) f32 in {0, 1}."""
    diff = pred.float() - gt.float()
    dist = torch.sqrt((diff * diff).sum(-1) + 1e-16)
    gt_mag = torch.sqrt((gt.float() ** 2).sum(-1) + 1e-16)
    return ((dist > 3.0) & (dist > 0.05 * gt_mag)).float()


def sequence_loss(flows: List[torch.Tensor], gt: torch.Tensor,
                  valid: Optional[torch.Tensor] = None, gamma: float = 0.8,
                  max_flow: float = 400.0) -> torch.Tensor:
    """RAFT's sequence loss: each iteration's pixel flow, resized to the GT's
    size as ``jax.image.resize(..., "bilinear")`` does and scaled by the H
    ratio, against the GT in L1, averaged over the pixels with |gt| <
    ``max_flow`` (and ``valid``), weighted ``gamma ** (n - 1 - i)``."""
    n_iters = len(flows)
    hw = tuple(gt.shape[1:3])
    gt32 = gt.float()
    v = (torch.sqrt((gt32 ** 2).sum(-1)) < max_flow).float()
    if valid is not None:
        v = v * valid.float()
    den = torch.clamp(v.sum(), min=1.0)
    total = gt.new_zeros((), dtype=torch.float32)
    for i, flow in enumerate(flows):
        # downsample_bilinear is jax.image.resize either way: its kernel
        # widens only along an axis that shrinks.
        up = downsample_bilinear(flow.float(), hw) * (hw[0] / flow.shape[1])
        l1 = torch.abs(up - gt32).sum(-1)
        total = total + gamma ** (n_iters - 1 - i) * (l1 * v).sum() / den
    return total
