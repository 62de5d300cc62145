"""The trainer (counterpart of ``pwcnet_tpu/train/loop.py``) for the
ported path: PWC-Net on device-generated synthetic batches, one device.

``train(cfg, max_steps, device=None)`` builds the model and optimizer,
resumes from the latest checkpoint under ``<log_dir>/ckpt``, runs the steps,
writes metrics every ``summary_interval`` steps (and at the last), and
checkpoints every ``checkpoint_interval`` steps and at the end. It runs on
the GPU unless ``device="cpu"``. What the config asks for and the port does
not have yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from pwcnet_tpu_torch.config import Config
from pwcnet_tpu_torch.data.synthetic import make_device_batcher
from pwcnet_tpu_torch.models.pwcnet import PWCNet, _resolve_device
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.metrics import MetricsWriter
from pwcnet_tpu_torch.train.schedule import lr_at, optimizer_from_config
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step


def build_model(cfg: Config, device=None) -> PWCNet:
    """The config's PWC-Net, with weights drawn from ``cfg.train.seed``."""
    m = cfg.model
    if m.family != "pwcnet":
        raise NotImplementedError(f"model family {m.family!r} is not ported "
                                  "yet (RAFT: ROADMAP A5)")
    return PWCNet(
        num_levels=m.num_levels, output_level=m.output_level,
        search_range=m.search_range, residual=m.residual,
        use_norm=m.use_norm, input_norm=m.input_norm,
        input_center=m.input_center, corr_backend=m.corr_backend,
        stem_backend=m.stem_backend, flow_scale=m.flow_scale,
        resize_mode=m.resize_mode,
        dtype=torch.bfloat16 if m.dtype == "bfloat16" else torch.float32,
        device=device,
        generator=torch.Generator().manual_seed(cfg.train.seed))


def _check_ported(cfg: Config, dev: torch.device) -> None:
    """Raise for what the config needs and the port does not have."""
    if not (cfg.data.device_gen and cfg.data.name == "synthetic"):
        raise NotImplementedError(
            f"dataset {cfg.data.name!r} without device_gen needs the file "
            "datasets, the Loader and augment_batch (ROADMAP A1)")
    p = cfg.parallel
    n_dev = (torch.cuda.device_count() if dev.type == "cuda" else 1) \
        if p.data == -1 else p.data
    if n_dev * p.spatial * p.model > 1 or (p.num_processes or 1) > 1:
        raise NotImplementedError("a mesh larger than one device needs DDP "
                                  "(ROADMAP A6) or the spatial path (A7)")
    if cfg.train.debug_nans:
        raise NotImplementedError("train.debug_nans is not ported yet "
                                  "(ROADMAP A2)")
    if cfg.train.profile_dir:
        raise NotImplementedError("train.profile_dir is not ported yet "
                                  "(ROADMAP A2)")
    if cfg.train.loss in ("sequence", "sequence_inscan"):
        raise NotImplementedError(f"loss {cfg.train.loss!r} comes with RAFT "
                                  "(ROADMAP A5)")


def _check_eval(cfg: Config, start: int, total: int) -> None:
    every = cfg.train.eval_interval
    if every > 0 and total // every > start // every:
        raise NotImplementedError(
            f"steps {start + 1}..{total} include a periodic eval (every "
            f"{every}); the eval loop and evaluate_dataset are not ported "
            "yet (ROADMAP A2)")


def train(cfg: Config, max_steps: Optional[int] = None,
          device=None) -> dict:
    """Train per ``cfg``; returns the last summary's metrics and ``step``."""
    dev = _resolve_device(device)
    _check_ported(cfg, dev)
    model = build_model(cfg, dev)
    optimizer, scheduler = optimizer_from_config(model.parameters(),
                                                 cfg.train)
    state = TrainState.create(model, optimizer, scheduler,
                              seed=cfg.train.seed + 1)
    ckpt = CheckpointManager(cfg.train.log_dir + "/ckpt",
                             max_to_keep=cfg.train.max_to_keep)
    if cfg.train.init_from:
        model.load_state_dict(
            CheckpointManager(cfg.train.init_from).load()["model"])
    if cfg.train.resume:
        ckpt.restore_latest_or(state)
    start = state.step
    total = cfg.train.schedule.total_steps
    if max_steps is not None:
        total = min(total, start + max_steps)
    _check_eval(cfg, start, total)

    step_fn = make_train_step(model, optimizer, scheduler,
                              loss_kind=cfg.train.loss,
                              level_weights=cfg.train.level_weights,
                              grad_clip=cfg.train.grad_clip)
    batcher = make_device_batcher(cfg.train.global_batch,
                                  cfg.data.augment.crop_hw,
                                  seed=cfg.train.seed,
                                  regime=cfg.data.synthetic_regime,
                                  device=dev)
    writer = MetricsWriter(cfg.train.log_dir)
    final: dict = {}
    t_last, pairs_since = time.perf_counter(), 0
    try:
        while state.step < total:
            state, metrics = step_fn(state, batcher(state.step))
            pairs_since += cfg.train.global_batch
            step = state.step
            if step % cfg.train.summary_interval == 0 or step == total:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                metrics.update(lr=lr_at(cfg.train.schedule, step),
                               pairs_per_sec=pairs_since / dt,
                               pairs_per_sec_per_chip=pairs_since / dt)
                writer.scalars(step, metrics)
                final = metrics
                t_last, pairs_since = time.perf_counter(), 0
            if step % cfg.train.checkpoint_interval == 0 or step == total:
                ckpt.save(state)
    finally:
        writer.close()
    final["step"] = state.step
    return final
