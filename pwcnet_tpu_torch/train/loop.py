"""The trainer (counterpart of ``pwcnet_tpu/train/loop.py``) for PWC-Net
on one device.

``train(cfg, max_steps, device=None)`` builds the model and optimizer,
resumes from the latest checkpoint under ``<log_dir>/ckpt``, and runs the
steps on batches of the config's dataset: for the file datasets (and
``synthetic`` without ``device_gen``) from the host ``Loader``, copied to
the device from pinned memory and augmented inside the step; for
``synthetic`` with ``device_gen``, rendered on the device, unaugmented. It
writes metrics every ``summary_interval`` steps (and at the last),
evaluates on the dataset's val split every ``eval_interval`` steps where
the dataset has one (``val_epe``, ``val_fl_all``, ``val_epe_s*``, and flow
images of one val sample), and checkpoints every ``checkpoint_interval``
steps and at the end. ``train.debug_nans`` raises ``FloatingPointError``
where a NaN appears (``nan_checks``); ``train.profile_dir`` traces the run
with ``torch.profiler``. It runs on the GPU unless ``device="cpu"``. What
the config asks for and the port does not have yet raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from pwcnet_tpu_torch.config import Config
from pwcnet_tpu_torch.data.base import get_dataset
from pwcnet_tpu_torch.data.pipeline import Loader
from pwcnet_tpu_torch.data.synthetic import make_device_batcher
from pwcnet_tpu_torch.models.pwcnet import PWCNet, _resolve_device
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.evaluate import evaluate_dataset, predict_flow
from pwcnet_tpu_torch.train.metrics import MetricsWriter
from pwcnet_tpu_torch.train.schedule import lr_at, optimizer_from_config
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step

_log = logging.getLogger(__name__)


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
    p = cfg.parallel
    n_dev = (torch.cuda.device_count() if dev.type == "cuda" else 1) \
        if p.data == -1 else p.data
    if n_dev * p.spatial * p.model > 1 or (p.num_processes or 1) > 1:
        raise NotImplementedError("a mesh larger than one device needs DDP "
                                  "(ROADMAP A6); the spatial path runs "
                                  "inference only (training across shards: "
                                  "ROADMAP A7)")
    if cfg.train.loss in ("sequence", "sequence_inscan"):
        raise NotImplementedError(f"loss {cfg.train.loss!r} comes with RAFT "
                                  "(ROADMAP A5)")


@contextlib.contextmanager
def nan_checks(model: torch.nn.Module):
    """While open, a NaN raises ``FloatingPointError`` where it appears:
    in the output of a module of ``model`` (a forward hook on each, naming
    the module), or in the output of a backward function (autograd's
    anomaly mode with ``check_nan``, naming the function; this covers the
    kernels' own ``autograd.Function``s). The counterpart of
    ``jax_debug_nans``, for debugging only: every check reads a device
    value on the host, so each module and each backward node syncs. The
    hooks are removed and the anomaly mode restored on exit."""
    names = {m: name or type(m).__name__ for name, m in model.named_modules()}

    def check(module, _inputs, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        for t in outs:
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of module {names[module]!r} "
                    f"({type(module).__name__})")

    handles = [m.register_forward_hook(check) for m in names]
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    except RuntimeError as e:
        if "returned nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        for h in handles:
            h.remove()
        torch.autograd.set_detect_anomaly(*before)


def to_device(batch: Dict[str, np.ndarray], dev: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch on ``dev``: to a GPU through pinned memory, without
    waiting for the copy (the step that reads it is queued after it)."""
    if dev.type != "cuda":
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(dev, non_blocking=True)
            for k, v in batch.items()}


def _evaluate(cfg: Config, model: PWCNet, val_ds, writer: MetricsWriter,
              step: int, final: dict, failures: list) -> None:
    """The periodic eval: val metrics into the log and ``final``, then flow
    images of val sample 0 (a failure there is logged once per run, counted
    in ``failures``, and training goes on, as in the JAX trainer)."""
    ev = evaluate_dataset(model, val_ds, batch=cfg.data.eval_batch,
                          limit=cfg.train.eval_limit)
    writer.scalars(step, {"val_epe": ev["epe"], "val_fl_all": ev["fl_all"],
                          **{f"val_{k}": v for k, v in ev.items()
                             if k.startswith("epe_s")}})
    final["val_epe"], final["val_fl_all"] = ev["epe"], ev["fl_all"]
    try:
        s0 = val_ds[0]
        pred = predict_flow(model, s0["im1"], s0["im2"])
        mm = float(np.abs(s0["flow"]).max()) or None
        writer.flow_image(step, "val/flow_pred", pred, max_mag=mm)
        writer.flow_image(step, "val/flow_gt", s0["flow"], max_mag=mm)
        writer.image(step, "val/im1", (s0["im1"] * 255).astype(np.uint8))
    except Exception:
        if not failures:
            _log.exception("eval image summary failed (logged once; further "
                           "failures are suppressed)")
        failures.append(step)


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

    # Device-generated synthetic batches are fresh draws already: they are
    # not augmented, and need no host loader.
    use_devgen = cfg.data.device_gen and cfg.data.name == "synthetic"
    # Only the synthetic dataset takes its size from the config; the file
    # datasets read theirs from the files.
    ds_kw = ({"hw": cfg.data.sample_hw, "regime": cfg.data.synthetic_regime,
              "val_length": cfg.data.synthetic_val_length}
             if cfg.data.name == "synthetic" else {})
    try:
        val_ds = get_dataset(cfg.data.name, cfg.data.root, split="val",
                             **ds_kw)
    except (FileNotFoundError, ValueError):
        val_ds = None  # no val split: no periodic eval
    step_fn = make_train_step(model, optimizer, scheduler,
                              loss_kind=cfg.train.loss,
                              level_weights=cfg.train.level_weights,
                              grad_clip=cfg.train.grad_clip,
                              aug=None if use_devgen else cfg.data.augment)
    train_ds = None if use_devgen else get_dataset(
        cfg.data.name, cfg.data.root, split="train", **ds_kw)
    writer = MetricsWriter(cfg.train.log_dir)
    final: dict = {}
    summary_failures: list = []
    debug = nan_checks(model) if cfg.train.debug_nans \
        else contextlib.nullcontext()
    loader = prof = None
    try:
        if use_devgen:
            batcher = make_device_batcher(cfg.train.global_batch,
                                          cfg.data.augment.crop_hw,
                                          seed=cfg.train.seed,
                                          regime=cfg.data.synthetic_regime,
                                          device=dev)
        else:
            loader = Loader(train_ds, cfg.train.global_batch,
                            sample_hw=cfg.data.sample_hw,
                            seed=cfg.train.seed,
                            num_threads=cfg.data.num_threads,
                            start_step=start)
        if cfg.train.profile_dir:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            prof = profile(
                activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else []),
                on_trace_ready=tensorboard_trace_handler(
                    cfg.train.profile_dir))
            prof.start()
        t_last, pairs_since = time.perf_counter(), 0
        with debug:
            while state.step < total:
                batch = (batcher(state.step) if loader is None
                         else to_device(next(loader), dev))
                state, metrics = step_fn(state, batch)
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
                every = cfg.train.eval_interval
                if val_ds is not None and every > 0 and step % every == 0:
                    _evaluate(cfg, model, val_ds, writer, step, final,
                              summary_failures)
                if step % cfg.train.checkpoint_interval == 0 or \
                        step == total:
                    ckpt.save(state)
    finally:
        if loader is not None:
            loader.close()
        if prof is not None:
            prof.stop()  # writes the trace into profile_dir
        writer.close()
    final["step"] = state.step
    return final
