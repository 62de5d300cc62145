"""Streaming inference through GMFlow with refinement (``gmflow``): one
client calls ``predict_flow(model, im1, im2)`` on consecutive frames
(t, t + 1) of one seeded sequence, batch 1, in a closed loop, as
``drivers/stream.py`` and ``drivers/stream_allpairs.py`` do, with this
family's weights, reference and kernel shapes.

Set-up: the weights drawn from the seed on the device, the port's model
built by its trainer's ``build_model`` and loaded with them, the frames
made on the host, then one call (the eager call and the graph capture).
The window: calls back to back; each pair's latency runs from the call to
the numpy flow in hand. A seeded reservoir of the answers is compared
afterwards with ``flowbench/reference/gmflow.py`` in float32 by
``stream.compare``. A traced run's view carries K12's 26 calls a pair.
The controls put the reference in the answer's place: in fp8 (``fp8``),
the next pair's (``stale``), or with every transformer block on unshifted
windows (``no_shift``).
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from flowbench import costs, frames, harness
from flowbench.drivers import stream
from flowbench.reference import gmflow
from flowbench.reference.ops import F32, Precision, bf16_emulations, pad_to

# LayerNorm weights: LN_WEIGHT[0] + a draw of std LN_WEIGHT[1]. Near the
# released init of 1 the seeded model is ill-conditioned (the
# configuration's ``assumed``): bf16 alone moves its flow by a fifth.
LN_WEIGHT = (0.3, 0.03)


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """GMFlow's parameters from ``seed``, drawn on ``device`` in one call:
    conv and linear weights of std sqrt(1 / fan_in), clamped at two;
    LayerNorm weights by ``LN_WEIGHT``; biases of std 0.01."""
    shapes = gmflow.param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, chunk in zip(names, flat.split(sizes)):
        shape = shapes[k]
        if k.endswith(".weight") and len(shape) > 1:
            std = math.sqrt(1.0 / math.prod(shape[1:]))
            out[k] = (chunk.clamp(-2.0, 2.0) * std).view(shape)
        elif k.endswith(".weight"):
            out[k] = (LN_WEIGHT[0] + LN_WEIGHT[1] * chunk).view(shape)
        else:
            out[k] = (chunk * 0.01).view(shape)
    return out


def reference_flow(cfg: dict, params: dict, im1: np.ndarray, im2: np.ndarray,
                   device, prec: Precision = F32,
                   shift: bool = True) -> np.ndarray:
    """The reference's cropped full-resolution flow of one pair."""
    a = pad_to(torch.as_tensor(im1, device=device)[None], cfg["pad_divisor"])
    b = pad_to(torch.as_tensor(im2, device=device)[None], cfg["pad_divisor"])
    with torch.no_grad():
        flows = gmflow.forward(params, cfg, a, b, prec, shift)
        full = gmflow.full_res(cfg, flows, tuple(a.shape[1:3]))
    h, w = im1.shape[:2]
    return full[0, :h, :w].cpu().numpy()


def kernel_calls(cfg: dict, n: int, hw) -> dict:
    """The calls of one forward of n pairs at the padded hw. K12's, each
    (images, h, w, splits, shifted, value width): per scale (1/8, then
    1/4) and block, the self- and the cross-attention of both frames over
    the split's windows (the odd blocks shifted); then the global matching
    and the global propagation at 1/8 (n images, width 2). K1's, each
    (n, h, w, C): the local matching at 1/4 (radius 4, 81 candidates)."""
    calls = []
    for scale, splits in zip((8, 4), cfg["attn_splits_list"]):
        h, w = hw[0] // scale, hw[1] // scale
        for i in range(cfg["num_transformer_layers"]):
            calls += [(2 * n, h, w, splits, i % 2 == 1, 128)] * 2
    calls += [(n, hw[0] // 8, hw[1] // 8, 1, False, 2)] * 2
    if cfg["corr_radius_list"] != [-1, 4]:
        raise ValueError("K1's cost counts radius 4 at 1/4 only")
    return {"window_attention": calls,
            "corr": [(n, hw[0] // 4, hw[1] // 4, cfg["feature_channels"])]}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, predict: Optional[Callable] = None
        ) -> harness.Outcome:
    """One run of the cell. ``predict`` stands in for the port's
    ``predict_flow`` (a planted fault in the tests)."""
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    predict = predict_flow if predict is None else predict
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    weights = seeded_weights(cfg, seed, dev)
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
            calls=kernel_calls(cfg, 1, hw), config=cfg, hw=hw,
            window_items=win.items, window_s=win.seconds)
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
    readings = stream.compare(
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


def control(cell: harness.Cell, seed: int, device, variant: str) -> dict:
    """The compared number with the reference in the program's place: in
    fp8 (``"fp8"``), the next pair's (``"stale"``), or with every block on
    unshifted windows (``"no_shift"``), over as many seeded pairs as a run
    samples."""
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    if variant not in ("fp8", "stale", "no_shift"):
        raise ValueError(f"unknown control {variant!r}")
    harness.reference_precision()
    weights = seeded_weights(cfg, seed, dev)
    ring = frames.make(tr, seed, dev)
    rng = np.random.default_rng((seed, 8))
    picks = rng.choice(len(ring) - 2, tr["sample_answers"], replace=False)

    def ref(j, prec=F32, shift=True):
        return reference_flow(cfg, weights, ring[j], ring[j + 1], dev, prec,
                              shift)

    got = {"fp8": lambda j: ref(j, Precision("fp8")),
           "stale": lambda j: ref(j + 1),
           "no_shift": lambda j: ref(j, shift=False)}[variant]
    return stream.compare([(got(j), ref(j)) for j in picks],
                          [[ref(j, p) for j in picks]
                           for p in bf16_emulations(seed, dev)])
