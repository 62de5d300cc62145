"""The train and eval steps (counterpart of ``pwcnet_tpu/train/step.py``,
single device), for PWC-Net and RAFT.

A train step is forward, loss, ``backward()`` (through the kernels' autograd
Functions on the GPU), optional clipping, the optimizer update and one
scheduler step, after the augmentation of the batch when the step has one
(``data/augment.py``, drawn on the ``TrainState``'s generator). Its
metrics are the JAX step's: ``loss``, ``train_epe``
(the finest flow, in full-resolution pixels, against the mask-weighted
downsampled ground truth: PWC-Net's scaled units times ``flow_scale``,
RAFT's pixels at their resolution times the image's H over theirs) and
``grad_norm`` (the global norm of the raw gradients, before clipping).
They stay on the device as 0-d tensors; the caller reads them when it
needs them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from pwcnet_tpu_torch.config import AugmentConfig
from pwcnet_tpu_torch.data.augment import augment_batch
from pwcnet_tpu_torch.losses import (LEVEL_WEIGHTS, downsample_gt, epe,
                                     fl_outliers, multiscale_loss,
                                     robust_loss, sequence_loss)
from pwcnet_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _make_loss(loss_kind: str, model,
               level_weights: Optional[Sequence[float]]) -> Optional[Callable]:
    """``loss(flows, gt, valid)`` of a loss kind; None for
    ``"sequence_inscan"``, which the model computes itself (``gt=``)."""
    weights = tuple(level_weights) if level_weights else LEVEL_WEIGHTS
    if loss_kind == "multiscale":
        return lambda flows, gt, v: multiscale_loss(
            flows, gt, v, weights=weights, flow_scale=model.flow_scale)
    if loss_kind == "robust":
        return lambda flows, gt, v: robust_loss(
            flows, gt, v, weights=weights, flow_scale=model.flow_scale)
    if loss_kind == "sequence":
        return sequence_loss
    if loss_kind == "sequence_inscan":
        return None
    raise ValueError(f"unknown loss kind {loss_kind!r}")


def make_train_step(model, optimizer, scheduler,
                    loss_kind: str = "multiscale",
                    level_weights: Optional[Sequence[float]] = None,
                    grad_clip: float = 0.0,
                    aug: Optional[AugmentConfig] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds f32 im1,
    im2 (N, H, W, 3), flow (N, H, W, 2) and valid (N, H, W) on the model's
    device. With ``aug``, the step first augments the batch: the scalars
    drawn on ``state.generator`` (CPU), the noise on the model's device from
    a generator seeded by a draw of the same, so a restored state replays
    the augmentation. ``state`` is advanced in place and returned."""
    loss_fn = _make_loss(loss_kind, model, level_weights)
    params = [p for p in model.parameters() if p.requires_grad]
    noise_gen = torch.Generator(device=model.device) if aug else None

    def step(state: TrainState, batch: Batch):
        if aug is not None:
            batch = augment_batch(batch, state.generator, aug, noise_gen)
        optimizer.zero_grad(set_to_none=True)
        if loss_fn is None:  # the sequence loss inside RAFT's loop
            flows, loss = model(batch["im1"], batch["im2"], gt=batch["flow"],
                                valid=batch["valid"])
        else:
            flows = model(batch["im1"], batch["im2"])
            loss = loss_fn(flows, batch["flow"], batch["valid"])
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if grad_clip > 0:
            # optax clip_by_global_norm scales by clip / norm where the norm
            # exceeds it; torch divides by norm + 1e-6.
            torch.nn.utils.clip_grad_norm_(params, grad_clip)
        optimizer.step()
        scheduler.step()
        state.step += 1
        with torch.no_grad():
            finest = flows[-1].detach()
            to_px = getattr(model, "flow_scale",
                            batch["im1"].shape[1] / finest.shape[1])
            gt_small, v_small = downsample_gt(
                batch["flow"], tuple(finest.shape[1:3]), flow_scale=1.0,
                valid=batch["valid"])
            train_epe = epe(finest * to_px, gt_small, v_small)
        return state, {"loss": loss.detach(), "train_epe": train_epe,
                       "grad_norm": grad_norm.detach()}

    return step


# GT-magnitude bin edges of the eval EPE breakdown (px).
EPE_MAG_BINS = (10.0, 40.0)


def make_eval_step(model) -> Callable[[Batch], Tuple[torch.Tensor, ...]]:
    """``eval(batch) -> (sum_epe, sum_outliers, num_valid, bins,
    per_sample)`` on a batch already padded to the model's divisor, as the
    JAX eval step: full-resolution EPE and KITTI Fl outliers (EPE > 3 px and
    > 5% of |GT|); ``bins`` (2, 3) holds the EPE sums and valid counts over
    |GT| in [0, 10), [10, 40), [40, inf) px; ``per_sample`` (B, 8) the same
    per sample: [epe sum, valid count, 3 bin EPE sums, 3 bin counts]."""

    @torch.no_grad()
    def step(batch: Batch):
        flows = model(batch["im1"], batch["im2"], train=False)
        full = model.full_res_flow(flows, tuple(batch["im1"].shape[1:3]))
        gt, v = batch["flow"].float(), batch["valid"].float()
        diff = full - gt
        dist = torch.sqrt((diff * diff).sum(-1) + 1e-16)
        outlier = fl_outliers(full, gt)
        mag = torch.sqrt((gt ** 2).sum(-1) + 1e-16)
        lo, hi = EPE_MAG_BINS
        masks = ((mag < lo).float() * v, ((mag >= lo) & (mag < hi)).float() * v,
                 (mag >= hi).float() * v)
        bins = torch.stack([torch.stack([(dist * m).sum() for m in masks]),
                            torch.stack([m.sum() for m in masks])])
        axes = tuple(range(1, dist.dim()))
        per_sample = torch.cat([
            (dist * v).sum(axes)[:, None], v.sum(axes)[:, None],
            torch.stack([(dist * m).sum(axes) for m in masks], 1),
            torch.stack([m.sum(axes) for m in masks], 1)], 1)
        return ((dist * v).sum(), (outlier * v).sum(), v.sum(), bins,
                per_sample)

    return step
