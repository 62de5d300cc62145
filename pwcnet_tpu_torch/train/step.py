"""The train and eval steps (counterpart of ``pwcnet_tpu/train/step.py``),
for PWC-Net and RAFT, on one process or over a (data, spatial, model) grid
of processes (``parallel/mesh.py:GridMesh``).

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

On a grid of more than one process each rank steps on its data row's rows
of the global batch, as JAX's ``shard_map`` step does with ``in_specs=(P(),
P(DATA_AXIS))``: the ranks of one data row (its spatial and model
replicas) compute the same step on the same rows, with the model
unsharded. The model runs under ``DistributedDataParallel`` over the whole
world, which averages the gradients before the clipping and the update:
with identical replicas the world mean is JAX's ``pmean`` over ``data``.
``grad_norm`` is the norm of the averaged gradients, and ``loss`` and
``train_epe`` are the world's means (the data rows' means). The
augmentation draws from ``fold_in(state.generator, data index)``. The eval
step sums over the data axis only and gathers ``per_sample`` in data
order, so no sample is counted twice.

On a CUDA model outside such a grid both steps are captured
(``capture.py``), as JAX jits them: the train step once per batch
signature after one eager step (which builds the kernels and the
optimizer's state), the eval step per padded batch shape, with the
model's graphs. The graph holds the augmentation's transform, the
forward, the loss, ``backward()``, the norm, the clipping, the update and
the metrics; the host keeps the augmentation's draws, the scheduler and
the step count. The eager step runs the same body on the same draws.
``capture=False`` keeps the eager path; a grid of several processes is
always eager (its collectives are not captured).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.nn.parallel import DistributedDataParallel

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.capture import (Captured, capture_enabled,
                                      model_captured, signature)
from pwcnet_tpu_torch.config import AugmentConfig
from pwcnet_tpu_torch.data.augment import (augment_device, draw_augment,
                                           fold_in, params_to)
from pwcnet_tpu_torch.losses import (LEVEL_WEIGHTS, downsample_gt, epe,
                                     fl_outliers, multiscale_loss,
                                     robust_loss, sequence_loss)
from pwcnet_tpu_torch.parallel.mesh import GridMesh
from pwcnet_tpu_torch.parallel.spatial_ops import (all_gather_rows,
                                                   all_reduce_sum)
from pwcnet_tpu_torch.train.schedule import make_capturable
from pwcnet_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _distributed(mesh: Optional[GridMesh]) -> bool:
    return mesh is not None and mesh.size > 1


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
                    aug: Optional[AugmentConfig] = None,
                    mesh: Optional[GridMesh] = None,
                    capture: Optional[bool] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds f32 im1,
    im2 (N, H, W, 3), flow (N, H, W, 2) and valid (N, H, W) on the model's
    device: this rank's data row's rows under a ``mesh``. With ``aug``,
    the step first augments the batch: the scalars drawn on
    ``state.generator`` (CPU; under a mesh on ``fold_in`` of it and the
    rank's data index, so a data row's replicas draw alike), the noise on
    the model's device from a generator seeded by a draw of the same, so a
    restored state replays the augmentation. ``state`` is advanced in place
    and returned. Under a mesh, ``DistributedDataParallel`` broadcasts
    rank 0's parameters when the step is made.

    ``capture`` (None: on a CUDA model outside a grid of several processes;
    ``True`` on the CPU raises) runs the first step of each batch signature
    eagerly and captures the next, then replays it (module docstring). The
    metrics are fresh tensors at every call. The parameters' gradients are
    the graph's between replays: nothing else may reset them. A captured
    step makes the optimizer ``capturable`` here (``make_capturable``); an
    eager one leaves it as it is. Spans ``train_step`` and its ``.draw``
    and ``.schedule`` (``trace.py``)."""
    loss_fn = _make_loss(loss_kind, model, level_weights)
    params = [p for p in model.parameters() if p.requires_grad]
    noise_gen = torch.Generator(device=model.device) if aug else None
    distributed = _distributed(mesh)
    capture = capture_enabled(capture, model.device, distributed)
    if capture:
        make_capturable(optimizer)
    # DDP over the world, not the data group: the replicas of a data row
    # are meant to be identical, so the world mean is the data mean, and
    # every rank then applies the same averaged gradients. That keeps all
    # replicas' parameters identical even where cuDNN's non-deterministic
    # weight gradients make one replica's backward differ from another's
    # in its last bits. No model holds a buffer that changes, so none is
    # broadcast per step.
    net = DistributedDataParallel(
        model, process_group=mesh.group, broadcast_buffers=False
    ) if distributed else model

    def update(batch: Batch) -> Dict[str, torch.Tensor]:
        """Forward, loss, backward, clipping, update, metrics: device work
        only, so that a graph can hold it."""
        optimizer.zero_grad(set_to_none=True)
        if loss_fn is None:  # the sequence loss inside RAFT's loop
            flows, loss = net(batch["im1"], batch["im2"], gt=batch["flow"],
                              valid=batch["valid"])
        else:
            flows = net(batch["im1"], batch["im2"])
            loss = loss_fn(flows, batch["flow"], batch["valid"])
        loss.backward()  # under DDP: the gradients averaged over the world
        grads = [p.grad for p in params if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if grad_clip > 0:
            # optax clip_by_global_norm scales by clip / norm where the norm
            # exceeds it; torch divides by norm + 1e-6.
            torch.nn.utils.clip_grad_norm_(params, grad_clip)
        optimizer.step()
        with torch.no_grad():
            finest = flows[-1].detach()
            to_px = getattr(model, "flow_scale",
                            batch["im1"].shape[1] / finest.shape[1])
            gt_small, v_small = downsample_gt(
                batch["flow"], tuple(finest.shape[1:3]), flow_scale=1.0,
                valid=batch["valid"])
            train_epe = epe(finest * to_px, gt_small, v_small)
            loss = loss.detach()
            if distributed:  # the world's mean; gloo has no AVG: SUM, divide
                loss, train_epe = all_reduce_sum(
                    torch.stack([loss.float(), train_epe.float()]),
                    mesh) / mesh.size
        return {"loss": loss, "train_epe": train_epe,
                "grad_norm": grad_norm.detach()}

    def augment_update(batch: Batch, drawn=None, z=None):
        if aug is not None:
            batch = augment_device(batch, drawn, z, aug)
        return update(batch)

    graphs = Captured(augment_update, warmup=0, name="train step") \
        if capture else None
    warmed = set()
    # Per signature, the gradient tensors its graph writes: kept alive, so
    # that a later capture into the shared pool never takes their memory.
    graph_grads = {}

    def step(state: TrainState, batch: Batch):
        with trace.span("train_step"):
            args = (batch,)
            if aug is not None:  # the draws, on the host
                with trace.span("train_step.draw"):
                    gen = (fold_in(state.generator, mesh.data_mesh.rank)
                           if distributed else state.generator)
                    n, h, w = batch["im1"].shape[:3]
                    drawn, z = draw_augment(gen, n, (h, w), aug, noise_gen)
                    args = (batch, params_to(drawn, model.device), z)
            if graphs is None:
                metrics = augment_update(*args)
            else:
                key = signature(*args)
                if key in graphs or key in warmed:
                    metrics = graphs(*args)
                    if key not in graph_grads:
                        graph_grads[key] = [p.grad for p in params]
                else:  # a real step: builds the kernels and Adam's state
                    metrics = graphs.warm(*args)
                    warmed.add(key)
            # On the host, between replays: a tensor lr is fill_ed in place.
            with trace.span("train_step.schedule"):
                scheduler.step()
            state.step += 1
        return state, metrics

    return step


# GT-magnitude bin edges of the eval EPE breakdown (px).
EPE_MAG_BINS = (10.0, 40.0)


def _eval_sums(model, batch: Batch) -> Tuple[torch.Tensor, ...]:
    """The eval step's sums and per-sample rows of one batch (no mesh)."""
    flows = model(batch["im1"], batch["im2"], train=False)
    full = model.full_res_flow(flows, tuple(batch["im1"].shape[1:3]))
    gt, v = batch["flow"].float(), batch["valid"].float()
    diff = full - gt
    dist_px = torch.sqrt((diff * diff).sum(-1) + 1e-16)
    outlier = fl_outliers(full, gt)
    mag = torch.sqrt((gt ** 2).sum(-1) + 1e-16)
    lo, hi = EPE_MAG_BINS
    masks = ((mag < lo).float() * v, ((mag >= lo) & (mag < hi)).float() * v,
             (mag >= hi).float() * v)
    bins = torch.stack([torch.stack([(dist_px * m).sum() for m in masks]),
                        torch.stack([m.sum() for m in masks])])
    axes = tuple(range(1, dist_px.dim()))
    per_sample = torch.cat([
        (dist_px * v).sum(axes)[:, None], v.sum(axes)[:, None],
        torch.stack([(dist_px * m).sum(axes) for m in masks], 1),
        torch.stack([m.sum(axes) for m in masks], 1)], 1)
    return ((dist_px * v).sum(), (outlier * v).sum(), v.sum(), bins,
            per_sample)


def make_eval_step(model, mesh: Optional[GridMesh] = None,
                   capture: Optional[bool] = None
                   ) -> Callable[[Batch], Tuple[torch.Tensor, ...]]:
    """``eval(batch) -> (sum_epe, sum_outliers, num_valid, bins,
    per_sample)`` on a batch already padded to the model's divisor, as the
    JAX eval step: full-resolution EPE and KITTI Fl outliers (EPE > 3 px and
    > 5% of |GT|); ``bins`` (2, 3) holds the EPE sums and valid counts over
    |GT| in [0, 10), [10, 40), [40, inf) px; ``per_sample`` (B, 8) the same
    per sample: [epe sum, valid count, 3 bin EPE sums, 3 bin counts]. Under
    a ``mesh`` the batch is this rank's data row's rows, and the model runs
    unsharded on them; the sums are summed over the data axis only (one
    collective; a spatial or model replica holds the same rows, and summing
    over the world would count each sample S * M times) and ``per_sample``
    gathered in data order, so every rank returns the global batch's
    values.

    ``capture`` (None: on a CUDA model outside a grid of several
    processes) replays the model's graph of each padded batch shape, kept
    with the model (``capture.model_captured``)."""
    data = None if mesh is None else mesh.data_mesh
    distributed = _distributed(data)
    if capture_enabled(capture, model.device, distributed):
        graphs = model_captured(model, "eval step", _eval_sums)
        return torch.no_grad()(lambda batch: graphs(model, batch))

    @torch.no_grad()
    def step(batch: Batch):
        *sums, per_sample = _eval_sums(model, batch)
        if not distributed:
            return (*sums, per_sample)
        flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in sums]),
                              data)
        return (flat[0], flat[1], flat[2], flat[3:].view(2, 3),
                all_gather_rows(per_sample[None], data)[0])

    return step
