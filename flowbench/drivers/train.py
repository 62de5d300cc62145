"""Training: the step that the port's ``make_train_step`` returns, fed as
its trainer feeds procedural pairs, one batch after another in a closed
loop: ``make_device_batcher`` renders the preset's pairs on the card, with
no augmentation.

Set-up makes the weights from the seed, builds the model, the optimizer,
the train state and the step, and drives that one step object through its
first steps (the eager step, the capture, a replay) on the window's own
feed, keeping each step's loss, the first gradient (from Adam's first
moment after one step) and the parameters after the last. The window then
continues with the same objects. Once it has closed and the program is
freed, the reference repeats those first steps in float32 from the same
weights on batches it renders itself.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, Optional

import torch

from flowbench import costs, harness
from flowbench.reference import synthetic
from flowbench.reference.ops import F32, Precision, bf16_emulations
from flowbench.reference.train import run_steps

BETA1 = 0.9


def port_cfg(cfg: dict, tr: dict, seed: int):
    """The port's ``Config`` of the cell: the traffic's preset with the
    configuration's model, the traffic's batch and crop, and the seed."""
    pc = harness.port_config(cfg, tr["preset"], train={
        "global_batch": tr["global_batch"], "seed": seed})
    pc = dataclasses.replace(pc, data=dataclasses.replace(
        pc.data, augment=dataclasses.replace(pc.data.augment,
                                             crop_hw=tuple(tr["crop_hw"]))))
    # What the reference implements: PWC-Net's multiscale loss, no
    # clipping, the smooth synthetic regime.
    if (cfg["family"] != "pwcnet" or pc.train.loss != "multiscale"
            or pc.train.grad_clip or pc.data.synthetic_regime != "smooth"):
        raise ValueError(f"no reference for {cfg['family']} with "
                         f"{pc.train.loss} loss, clip {pc.train.grad_clip}, "
                         f"regime {pc.data.synthetic_regime}")
    return pc


def _opt(pc) -> dict:
    return {"lr": pc.train.schedule.base_lr,
            "weight_decay": pc.train.weight_decay}


def reference_batches(cell: harness.Cell, seed: int,
                      device) -> Callable[[int], dict]:
    """The reference's own batch of each checked step."""
    tr = cell.traffic
    n, hw = tr["global_batch"], tuple(tr["crop_hw"])
    return lambda s: synthetic.batch(seed, s, n, hw, device)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, plant: Optional[Callable] = None
        ) -> harness.Outcome:
    """One run of a train cell. ``plant`` wraps the step function (a planted
    fault in the tests)."""
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step

    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    pc = port_cfg(cfg, tr, seed)
    weights = harness.seeded_weights(cfg, seed, dev)
    model = harness.port_model(cfg, weights, dev, tr["preset"])
    optimizer, scheduler = optimizer_from_config(model.parameters(),
                                                 pc.train)
    state = TrainState.create(model, optimizer, scheduler, seed=seed + 1)
    step_fn = make_train_step(
        model, optimizer, scheduler, loss_kind=pc.train.loss,
        level_weights=pc.train.level_weights, grad_clip=pc.train.grad_clip)
    if plant is not None:
        step_fn = plant(step_fn)
    batcher = make_device_batcher(pc.train.global_batch,
                                  pc.data.augment.crop_hw, seed=seed,
                                  regime=pc.data.synthetic_regime,
                                  device=dev)

    def feed():
        return batcher(state.step)

    names = [k for k, _ in model.named_parameters()]
    losses, grads, marks = [], None, [time.perf_counter() - t_start]
    for s in range(tr["checked_steps"]):
        state, m = step_fn(state, feed())
        losses.append(float(m["loss"]))
        marks.append(time.perf_counter() - t_start)
        if s == 0:
            grads = {k: optimizer.state[p]["exp_avg"].detach() / (1 - BETA1)
                     for k, p in zip(names, model.parameters())}
    after = {k: p.detach().clone()
             for k, p in zip(names, model.parameters())}
    sync()
    setup_s = time.perf_counter() - t_start

    spans = harness.Spans()

    def one(i: int) -> None:
        nonlocal state
        with spans("feed"):
            batch = feed()
        with spans("step"):
            state, _ = step_fn(state, batch)

    win = harness.run_window(one, seconds, sync, spans,
                             tr["trace_seconds"] if trace else None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    notes = [f"steps {win.items}, window {win.seconds:.3f} s; set-up "
             f"{setup_s:.3f} s, checked steps ending at "
             + ", ".join(f"{t:.3f}" for t in marks) + " s"]
    n = tr["global_batch"]
    view = None
    if trace:
        hw = tuple(pc.data.augment.crop_hw)
        stretch, kern, cop, sp = harness.from_profiler(win.prof,
                                                       "flowbench.stretch")
        corr = costs.corr_shapes(cfg, n, hw)
        view = harness.TraceView(
            kind="train", stretch=stretch, items=win.stretch_items,
            pairs_per_item=n, kernels=kern, copies=cop, spans=sp,
            calls={"corr": corr, "corr_bwd": corr + corr,
                   "stem": costs.stem_shapes(cfg, n, hw),
                   "stem_bwd": costs.stem_shapes(cfg, n, hw)},
            config=cfg, hw=hw, window_items=win.items, window_s=win.seconds,
            window_feed_s=win.spans.get("feed", 0.0))
    e2e = {"train_pairs_per_s": win.items * n / win.seconds,
           "setup_s": setup_s}
    del state, step_fn, model, optimizer, scheduler, feed, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(cell, seed, dev, weights, losses, grads, after)
    notes.append("loss gap by step " + ", ".join(
        f"{x:.6g}" for x in readings.pop("each_step"))
        + f"; leaves left out of the change {readings.pop('left_out')}"
        + f"; reference {time.perf_counter() - t_ref:.3f} s")
    return harness.Outcome(
        attempted=win.items, failed=0, end_to_end=e2e,
        checks=harness.checks(readings, cell.limits), readings=readings,
        memory_peak_bytes=peak, view=view, notes=notes)


def compare(cell: harness.Cell, seed: int, device,
            weights: Dict[str, torch.Tensor], losses, grads, after,
            prec: Precision = F32, drop_half: bool = False) -> list:
    """Readings of the checked steps against the reference's: each step's
    loss gap (relative), their worst and the first's; each leaf's gap of
    first-gradient norms and of the norms of the change over the checked
    steps (``harness.leaf_gaps``; leaves whose reference gradient is under
    a thousandth of the median leaf's left out of the change), their
    worst and their median; and the median leaf's gradient gap over the
    root mean square of those of the reference's own bfloat16 emulations
    of the first step (how many times bfloat16 rounding alone the
    gradients are off: steady where the seed's conditioning moves both)."""
    harness.reference_precision()
    tr = cell.traffic
    pc = port_cfg(cell.config, tr, seed)
    ref = run_steps(cell.config, _opt(pc), weights,
                    reference_batches(cell, seed, device),
                    tr["checked_steps"], prec, drop_half)
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in
             ref["grads"].items()}
    med = harness.median(list(norms.values()))
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    steps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    grad = harness.leaf_gaps(grads, ref["grads"])
    change = {k: after[k] - weights[k] for k in weights}
    ref_change = {k: ref["params"][k] - weights[k] for k in weights}
    upd = harness.leaf_gaps(change, ref_change, keep)
    emulations = bf16_emulations(seed, device)
    floor = (sum(harness.median(harness.leaf_gaps(
        run_steps(cell.config, _opt(pc), weights,
                  reference_batches(cell, seed, device), 1, p)["grads"],
        ref["grads"])) ** 2 for p in emulations) / len(emulations)) ** 0.5
    return {"loss_gap": max(steps), "loss_gap_step1": steps[0],
            "grad_gap": max(grad), "grad_gap_median": harness.median(grad),
            "grad_gap_bf16": floor,
            "grad_vs_bf16": harness.median(grad) / max(floor, 1e-300),
            "update_gap": max(upd), "update_gap_median": harness.median(upd),
            "each_step": steps, "left_out": len(norms) - len(keep)}


def control(cell: harness.Cell, seed: int, device, variant: str) -> dict:
    """The compared numbers with the reference in the program's place:
    computed in fp8 (``"fp8"``), or with half of each batch left out and
    the mean taken over the rest (``"half_batch"``). (A state left
    unchanged reads 1 as ``update_gap`` by its definition.)"""
    dev = torch.device(device)
    harness.reference_precision()
    tr = cell.traffic
    pc = port_cfg(cell.config, tr, seed)
    weights = harness.seeded_weights(cell.config, seed, dev)
    batches = reference_batches(cell, seed, dev)
    if variant not in ("fp8", "half_batch"):
        raise ValueError(f"unknown control {variant!r}")
    got = run_steps(cell.config, _opt(pc), weights, batches,
                    tr["checked_steps"],
                    Precision("fp8") if variant == "fp8" else F32,
                    drop_half=variant == "half_batch")
    return compare(cell, seed, dev, weights, got["losses"],
                   got["grads"], got["params"])
