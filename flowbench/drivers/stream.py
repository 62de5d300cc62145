"""Streaming inference: one client calls ``predict_flow(model, im1, im2)``
on consecutive frames (t, t + 1) of one seeded sequence, batch 1, in a
closed loop, as offline video flow does.

Set-up: the weights drawn from the seed on the device, the port's model
built by its trainer's ``build_model`` and loaded with them, the frames
made on the host, then one call (the model's eager call and its graph
capture). The window: calls back to back; each pair's latency runs from
the call to the numpy flow in hand. A reservoir keeps a seeded sample of
the answers (the window's, and in a traced run those of the stretch that
follows it); once the window has closed and the program is freed, the reference computes those pairs again in float32 and each
answer's relative L2 error is compared with the cell's limit.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from flowbench import costs, frames, harness
from flowbench.reference import pwcnet, raft
from flowbench.reference.ops import F32, Precision, bf16_emulations, pad_to


def reference_flow(cfg: dict, params: dict, im1: np.ndarray, im2: np.ndarray,
                   device, prec: Precision = F32) -> np.ndarray:
    """The reference's cropped full-resolution flow of one pair."""
    mod = pwcnet if cfg["family"] == "pwcnet" else raft
    a = pad_to(torch.as_tensor(im1, device=device)[None], cfg["pad_divisor"])
    b = pad_to(torch.as_tensor(im2, device=device)[None], cfg["pad_divisor"])
    with torch.no_grad():
        flows = mod.forward(params, cfg, a, b, prec)
        full = mod.full_res(cfg, flows, tuple(a.shape[1:3]))
    h, w = im1.shape[:2]
    return full[0, :h, :w].cpu().numpy()


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, predict: Optional[Callable] = None
        ) -> harness.Outcome:
    """One run of a stream cell. ``predict`` stands in for the port's
    ``predict_flow`` (a planted fault in the tests)."""
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    predict = predict_flow if predict is None else predict
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    weights = harness.seeded_weights(cfg, seed, dev)
    model = harness.port_model(cfg, weights, dev)
    ring = frames.make(tr, seed, dev)
    pairs = len(ring) - 1
    t_ready = time.perf_counter() - t_start
    predict(model, ring[0], ring[1])
    sync()
    setup_s = time.perf_counter() - t_start

    k_sample = tr["sample_answers"]
    rng = np.random.default_rng((seed, 7))
    sample = []          # (pair index, flow) of a seeded reservoir
    lat = []
    spans = harness.Spans()

    def one(i: int) -> None:
        j = i % pairs
        t0 = time.perf_counter()
        with spans("entry"):
            flow = predict(model, ring[j], ring[j + 1])
        lat.append(time.perf_counter() - t0)
        if len(sample) < k_sample:
            sample.append((j, flow))
        else:
            r = int(rng.integers(0, i + 1))
            if r < k_sample:
                sample[r] = (j, flow)

    win = harness.run_window(one, seconds, sync, spans,
                             tr["trace_seconds"] if trace else None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    view = None
    if trace:
        hw = costs.padded_hw(cfg, tuple(tr["frame_hw"]))
        stretch, kern, cop, sp = harness.from_profiler(win.prof,
                                                       "flowbench.stretch")
        view = harness.TraceView(
            kind="stream", stretch=stretch, items=win.stretch_items,
            pairs_per_item=1, kernels=kern, copies=cop, spans=sp,
            calls={"corr": costs.corr_shapes(cfg, 1, hw),
                   "stem": costs.stem_shapes(cfg, 1, hw)},
            config=cfg, hw=hw, window_items=win.items, window_s=win.seconds)
    lat_ms = sorted(x * 1e3 for x in lat[:win.items])
    p95 = (statistics.quantiles(lat_ms, n=20)[-1] if len(lat_ms) > 1
           else lat_ms[0])
    notes = [f"pairs {win.items}, median latency "
             f"{statistics.median(lat_ms):.4f} ms, p95 {p95:.4f} ms, "
             f"window {win.seconds:.3f} s; set-up {setup_s:.3f} s, "
             f"model and frames ready at {t_ready:.3f} s"]
    e2e = {"stream_pairs_per_s": win.items / win.seconds,
           "stream_p95_ms": p95,
           "setup_s": setup_s}

    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    harness.reference_precision()
    t_ref = time.perf_counter()
    readings = compare(
        [(flow, reference_flow(cfg, weights, ring[j], ring[j + 1], dev))
         for j, flow in sample],
        [[reference_flow(cfg, weights, ring[j], ring[j + 1], dev, p)
          for j, _ in sample] for p in bf16_emulations(seed, dev)])
    notes.append("answers (pair, relative L2 error): " + ", ".join(
        f"{j} {e:.6g}" for (j, _), e in zip(sample, readings.pop("each")))
        + f"; reference {time.perf_counter() - t_ref:.3f} s")
    return harness.Outcome(
        attempted=win.items, failed=0, end_to_end=e2e,
        checks=harness.checks(readings, cell.limits), readings=readings,
        memory_peak_bytes=peak, view=view, notes=notes)


def _pooled(pairs) -> float:
    num = sum(float(np.sum((got - ref).astype(np.float64) ** 2))
              for got, ref in pairs)
    den = sum(float(np.sum(ref.astype(np.float64) ** 2)) for _, ref in pairs)
    return (num / max(den, 1e-300)) ** 0.5


def compare(pairs, emulated) -> dict:
    """Readings of (answer, float32 reference) pairs: each answer's
    relative L2 error and their worst; the error pooled over them all;
    and that pooled error over the root mean square of the pooled errors
    of the reference's own bfloat16 emulations (``emulated``: per
    emulation, its flows of the same pairs): how many times bfloat16
    rounding alone the answers are off, a number that the random
    weights' conditioning, which moves both errors alike from seed to
    seed, leaves steady."""
    each = [harness.rel_l2(got, ref) for got, ref in pairs]
    pooled = _pooled(pairs)
    floor = (sum(
        _pooled([(e, ref) for e, (_, ref) in zip(em, pairs)]) ** 2
        for em in emulated) / len(emulated)) ** 0.5
    return {"flow_rel_err": max(each), "flow_rel_err_pooled": pooled,
            "flow_rel_err_bf16": floor,
            "flow_err_vs_bf16": pooled / max(floor, 1e-300), "each": each}


def control(cell: harness.Cell, seed: int, device, variant: str) -> dict:
    """The compared number with the reference in the program's place: in
    fp8 (``variant="fp8"``), or with each answer replaced by the next
    pair's (``"stale"``), over as many seeded pairs as a run samples."""
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    harness.reference_precision()
    weights = harness.seeded_weights(cfg, seed, dev)
    ring = frames.make(tr, seed, dev)
    pairs = len(ring) - 1
    rng = np.random.default_rng((seed, 8))
    if variant not in ("fp8", "stale"):
        raise ValueError(f"unknown control {variant!r}")
    out, picks = [], rng.choice(pairs - 1, tr["sample_answers"],
                                replace=False)
    for j in picks:
        ref = reference_flow(cfg, weights, ring[j], ring[j + 1], dev)
        if variant == "fp8":
            got = reference_flow(cfg, weights, ring[j], ring[j + 1], dev,
                                 Precision("fp8"))
        else:
            got = reference_flow(cfg, weights, ring[j + 1], ring[j + 2], dev)
        out.append((got, ref))
    return compare(out, [[reference_flow(cfg, weights, ring[j], ring[j + 1],
                                         dev, p) for j in picks]
                         for p in bf16_emulations(seed, dev)])
