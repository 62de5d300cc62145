#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pwcnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from ``pwcnet_tpu_torch/csrc`` into ``build/``,
holds each against its plain PyTorch version on the card (forward kernels
K1, K4, K6 on their outputs; backward kernels K2, K3, K5 and K6's autograd
Function on the gradients), drives the PWC-Net inference forward (bf16,
448x1024, random seeded weights) with ``corr_backend="pallas"`` and
``"fused"``, the trainer (``train(synthetic-proof)``, bf16, 8 x 384x448) and
the fused train step through the kernels, checks flows, losses, launch
counts, a checkpoint round trip, an overfit run and f32 steps against the
CPU, measures K6 against warp + K1 per level (the crossover behind
``FUSED_MIN_PIXELS``), runs the JAX model's backend names on the card
(``corr_backend="lax"`` and ``stem_backend="lax"``: the plain ops, no kernel
launch), runs the command line (``predict``, ``eval``, a
``train`` that crosses ``eval_interval``) in subprocesses, holds the
spatial path's halo-row kernels K1p and K6p and the small-channel conv K7
against their plain versions, drives ``parallel.spatial_forward`` at
512x1024 on 1 rank in this process and on 2 and 4 ranks (``gloo``
processes sharing the card) against the unsharded forward, and times the
kernels (K1 per level, with the tile its bf16 launch takes), the forwards
and the train steps with CUDA events. Each phase
prints one JSON line; any failure raises and the script exits non-zero.
Without a CUDA device it exits 1 at once. The last line is ``{"ok": true,
"device": {...}}``; every phase's result, the predicted flows and the
trainer's logs go to ``DIR`` (default ``build/chip_smoke``).

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
              torch.float32: 67e12}    # f32 outside the tensor cores
# K1 at the finest-to-coarsest levels of a 448x1024 frame, batch 1.
K1_MAIN = [(1, 7, 16, 196), (1, 14, 32, 128), (1, 28, 64, 96),
           (1, 56, 128, 64), (1, 112, 256, 32)]
K1_RAGGED = [(2, 7, 13, 5), (1, 9, 33, 196), (3, 20, 70, 32)]
# More K1 shapes, (shape, d): W = 17 at C = 196 (one m16 tile and a ragged
# one), and d < 4 at real widths (every tile of the bf16 kernel: 2 x 32,
# 1 x 32, 1 x 16 with the dy values split).
K1_MORE = [((1, 5, 17, 196), 4), ((1, 56, 128, 64), 2),
           ((8, 12, 14, 128), 1), ((1, 28, 64, 96), 3), ((1, 7, 16, 196), 1)]
K4_MAIN = (2, 448, 1024, 3)  # both frames of one 448x1024 pair
K4_MORE = [(1, 64, 192, 3), (4, 384, 448, 3)]
# The train step (batch 8, 384x448): correlation levels 6..2 and the stem
# on both frames of the 8 pairs.
CORR_TRAIN = [(8, 6, 7, 196), (8, 12, 14, 128), (8, 24, 28, 96),
              (8, 48, 56, 64), (8, 96, 112, 32)]
STEM_TRAIN = (16, 384, 448, 3)
# The last at N = 16 with H/4, W/4 no multiple of the bf16 K5's tiles (64
# columns, 4 or 8 rows).
STEM_RAGGED = [(2, 40, 72, 3), (1, 36, 100, 3), (2, 64, 192, 3),
               (16, 44, 76, 3)]
# More weight-gradient tiles than blocks in every layer of the bf16 K5
# (1872, 1872, 944, 944 tiles over 924, 528, 264, 264 blocks), as at
# STEM_TRAIN; checked after the others, so that their draws stay as they are.
STEM_LOOPED = [(16, 932, 12, 3)]
# K6 at the warped levels (5..2) of a 448x1024 pair and of the train step,
# ragged shapes, and a width the Pallas entry cannot tile.
K6_MAIN = K1_MAIN[1:]
K6_TRAIN = CORR_TRAIN[1:]
K6_RAGGED = [(2, 7, 13, 5), (1, 9, 33, 196), (3, 20, 70, 32),
             (1, 16, 8192, 8)]
# Flows in pixels at a level: N(0, 1) times 1, 4 and 16, and exact
# integers in [-3, 3] with a quarter of the pixels +-1000 px outside.
K6_FLOWS = ("normal1", "normal4", "normal16", "integer_and_far")
K6_GRAD_SHAPES = [(1, 16, 24, 8), (8, 48, 56, 64), (2, 20, 70, 32)]
FUSED_FWD_LAUNCHES = {"warp_corr_fwd": 4, "corr_fwd": 1, "stem_fwd": 1}
FUSED_TRAIN_LAUNCHES = {"warp_corr_fwd": 4, "corr_fwd": 1, "corr_bwd_f1": 5,
                        "corr_bwd_f2": 5, "stem_fwd": 1, "stem_bwd": 1}
FUSED_TRAIN_STEPS = 3
# The spatial path: a 512x1024 pair (436x1024 Sintel padded for 2 and 4
# shards). K1p at the shard-local shapes of each level (6..2) under S = 2 and
# S = 4, with d = 4 real halo rows; K6p at the warped levels (5..2); ragged
# shapes with (row0, h_global) placing the shard.
SPATIAL_HW = (512, 1024)
K1P = {s: [(1, 512 // 2 ** lv // s, 1024 // 2 ** lv, c)
           for lv, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))]
       for s in (2, 4)}
K1P_RAGGED = [(2, 5, 13, 5), (1, 3, 33, 196), (3, 9, 70, 32)]
K6P = {s: shapes[1:] for s, shapes in K1P.items()}
K6P_RAGGED = [((2, 5, 13, 5), 5, 15), ((1, 3, 33, 196), 3, 12),
              ((3, 9, 70, 32), 0, 18)]  # (shape, row0, h_global)
# Flows for K6p: K6_FLOWS' kinds and "beyond": a quarter of the pixels move
# +-(halo + 3) rows, past the exchanged rows (the halo-bound clamp).
K6P_FLOWS = ("normal1", "normal4", "beyond", "integer_and_far")
# K7 at the stem chain of a 448x1024 pair (both frames): (input shape, Co,
# stride), through conv2d_folded as a chain of folded layouts.
K7_CHAIN = [((2, 448, 1024, 3), 16, 2), ((2, 224, 512, 16), 16, 1),
            ((2, 224, 512, 16), 32, 2), ((2, 112, 256, 32), 32, 1)]
# K7 at sizes that are no multiple of its tiles (64 columns, 8 rows at
# stride 1 and 4 at stride 2), N = 1 and 16, Ci = 3, 16, 32 (and a Ci, Co
# that fill no k16 step or n8 tile, Co over two channel groups, the 64
# channels the bf16 tile stages at most, and 96, above them).
K7_RAGGED = [((1, 37, 70, 3), 16, 2), ((16, 9, 67, 16), 16, 1),
             ((1, 13, 100, 16), 32, 2), ((16, 11, 75, 32), 32, 1),
             ((2, 6, 20, 5), 7, 1), ((1, 9, 21, 8), 40, 2),
             ((1, 9, 70, 64), 16, 2), ((2, 9, 21, 96), 8, 1)]
# K7 with 9 Ci Co above 12288 weights (the CUDA-core loop stages them per
# chunk of input channels): Ci = Co = 64 on the tile, Ci = 96 on the cores.
K7_WIDE = [((1, 9, 70, 64), 64, 1), ((2, 9, 21, 96), 64, 2)]
# K1_MORE, K7_WIDE and the K4 shapes beyond K4_MAIN and K4_MORE draw from
# their own generator, so that the draws of the other checks stay as they
# were.
MORE_SEED = 6
SPATIAL_REPS = 10  # timed spatial forwards
TRAIN_STEPS = 10   # steps of the train_steps phase
OVERFIT_STEPS = 30
TRAIN_LAUNCHES = {"corr_fwd": 5, "corr_bwd_f1": 5, "corr_bwd_f2": 5,
                  "stem_fwd": 1, "stem_bwd": 1}
# Tolerances on max|kernel - plain| / max|plain|. f32: only the order of
# f32 sums differs (TF32 off). bf16, correlation: the same f32 sums, then
# one rounding to bf16, so at most one bf16 step (2**-8) apart. bf16, stem:
# four layers each rounded to bf16 at slightly different points.
# Backward kernels against the plain version's autograd gradients: the
# correlation's as the forward's (f32 sums, one rounding). The stem's f32
# as its forward's; where it is further (two right f32 sums may put a
# LeakyReLU input within f32 rounding of 0 on either side of it), within the
# same tolerance of the float64 gradients with the slope swapped at one such
# input: a float64 pre-activation z with |z| <= K F32_UNIT sum|terms|, the
# a priori bound on an f32 sum of its K = 9 Ci + 1 terms. The stem's bf16:
# its error against an f32 oracle (f32
# copies of the same bf16 inputs) within STEM_BWD_BF16 = (factor, floor):
# factor x the plain bf16 autograd's error against that oracle, or floor;
# and against stem_bwd_bf16_ref, its own arithmetic, within
# stem_kernel.BF16_MODEL_TOL.
TOL = {("corr", torch.float32): 1e-5, ("corr", torch.bfloat16): 8e-3,
       ("stem", torch.float32): 1e-4, ("stem", torch.bfloat16): 3e-2,
       ("corr_bwd", torch.float32): 1e-5, ("corr_bwd", torch.bfloat16): 8e-3,
       ("stem_bwd", torch.float32): 1e-4}
STEM_BWD_BF16 = (3.0, 5e-3)
STEM_FLIPS_TRIED = 8  # per layer, the nearest to 0 first
F32_UNIT = 2.0 ** -24  # f32 unit roundoff
FWD_TOL = 1e-4  # f32 forward, card kernels vs CPU plain ops, per level
# One f32 train step (TF32 off), card vs CPU: loss, train_epe and
# grad_norm within TRAIN_TOL (relative). Every parameter's gradient, card vs
# CPU and card kernels vs the plain versions on the card, within
# max|a - b| <= tol * max|b| with tol = max(TRAIN_TOL, FLOOR_FACTOR x floor):
# floor is the CPU's own change of the same gradients when the input is
# scaled by 1 + 1e-6 * N(0, 1) (three draws). The gradient of LeakyReLU (and
# of the warp's coverage mask) jumps at its threshold, so a pre-activation
# within rounding of 0 moves a gradient by up to a few 1e-3 of its max when
# the forward changes in its last bits, as the card's convolutions do; the
# kernels' own gradients are held to 1e-5 by k2/k3/k5_check.
TRAIN_TOL = 1e-4
FLOOR_FACTOR = 3.0
# K7 against conv_ref: f32 as the correlation (sum order only); bf16: the
# plain version rounds the conv and then the bias-add to bf16, the kernel
# rounds once, so two bf16 steps (2 x 2**-8) apart at most.
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}

RESULTS: list = []


def emit(obj: dict) -> None:
    RESULTS.append(obj)
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


class Timer:
    """Device time per call from CUDA events. Before each timed window the
    stream sleeps long enough for the host to enqueue the whole window, so
    launch latency on the host does not count as device time."""

    def __init__(self):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def __call__(self, fn, reps: int = 20, inner: int = 5) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int(self.cycles_per_ms * (2 * inner * host_ms + 0.2))
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            s.record()
            for _ in range(inner):
                fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / inner)
        return statistics.median(times)


def wall_ms(fn, reps: int = 20) -> float:
    """Median host time of ``fn`` + synchronize, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def profile_kernels(fn, n: int = 3):
    """Device kernels of ``fn`` over n calls, from the profiler: (busy ms
    per call, launches per call, the 15 largest by time). Kernel entries
    only: an operator's entry repeats its kernels' time, and a user
    annotation (such as the optimizer's step) overlaps them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = sorted(((ev.key, ev.self_device_time_total / 1e3 / n,
                       ev.count // n) for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and ev.self_device_time_total > 0
                      and not getattr(ev, "is_user_annotation", False)),
                     key=lambda t: -t[1])
    return (sum(t[1] for t in by_name), sum(t[2] for t in by_name),
            [{"name": k[:80], "ms": ms, "calls": c}
             for k, ms, c in by_name[:15]])


def bound_ms(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def corr_cost(shape, dtype):
    n, h, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    return (2 * n * h * w * c + n * h * w * 81) * s, 2.0 * n * h * w * 81 * c


def warp_corr_cost(shape, dtype):
    """K6: read f1, f2 and the f32 flow, write the correlation; the blend
    (4 products a channel) and the 81 taps."""
    n, h, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    return ((2 * n * h * w * c + n * h * w * 81) * s + n * h * w * 2 * 4,
            2.0 * n * h * w * c * (81 + 4))


def stem_cost(shape, dtype):
    n, h, w, _ = shape
    s = torch.empty((), dtype=dtype).element_size()
    l1, l2 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    macs = n * (l1 * 16 * 27 + l1 * 16 * 144 + l2 * 32 * 144 + l2 * 32 * 288)
    n_w = 27 * 16 + 144 * 16 + 144 * 32 + 288 * 32 + 16 + 16 + 32 + 32
    return (n * h * w * 3 + n * l2 * 32) * s + n_w * 4, 2.0 * macs


def stem_layer_bytes(shape, dtype):
    """The bytes the bf16 K4 moves layer by layer: the image read, level 1
    (y1, y2) and conv3's output each written and read once, the output
    written; stem_cost's bytes are those of a kernel that keeps level 1 on
    chip."""
    n, h, w, _ = shape
    s = torch.empty((), dtype=dtype).element_size()
    l1, l2 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    return n * (h * w * 3 + 2 * 2 * l1 * 16 + 2 * l2 * 32 + l2 * 32) * s


def corr_pre_cost(shape, dtype):
    """K1p: read f1 and the d-row-extended f2, write the correlation."""
    n, t, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    return ((n * t * w * c + n * (t + 8) * w * c + n * t * w * 81) * s,
            2.0 * n * t * w * 81 * c)


def k6p_halo(t: int) -> int:
    """The halo rows of f2 at a level of t rows (spatial_halo 16, d 4)."""
    return max(min(16, t), 4)


def warp_corr_pre_cost(shape, dtype):
    """K6p: read f1, the halo-extended f2 and the f32 flow with d halo rows,
    write the correlation; the blend of the t + 2d warped rows and the 81
    taps of the t output rows."""
    n, t, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    te = t + 2 * k6p_halo(t)
    return ((n * t * w * c + n * te * w * c + n * t * w * 81) * s
            + n * (t + 8) * w * 2 * 4,
            2.0 * n * w * c * (81 * t + 4 * (t + 8)))


def conv_cost(shape, co, stride, dtype):
    """K7: read x and the weights, write the output; 9 * Ci products per
    output value."""
    n, h, w, ci = shape
    s = torch.empty((), dtype=dtype).element_size()
    ho, wo = -(-h // stride), -(-w // stride)
    return ((n * h * w * ci + n * ho * wo * co) * s + (9 * ci + 1) * co * 4,
            2.0 * n * ho * wo * co * 9 * ci)


def corr_bwd_cost(shape, dtype):
    """One of K2/K3: read g and one feature map, write one gradient."""
    n, h, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    return (n * h * w * 81 + 2 * n * h * w * c) * s, 2.0 * n * h * w * 81 * c


def stem_bwd_cost(shape, dtype, with_im: bool):
    """K5: read the image and the output gradient (and write d_im); work =
    the forward (the activations are not inputs), one product per layer for
    dW, and one per layer for the input gradient (conv1's only with d_im)."""
    n, h, w, _ = shape
    s = torch.empty((), dtype=dtype).element_size()
    fwd_bytes, fwd_flops = stem_cost(shape, dtype)
    conv1 = 2.0 * n * (h // 2) * (w // 2) * 16 * 27
    flops = 3 * fwd_flops - (0 if with_im else conv1)
    return fwd_bytes + (n * h * w * 3 * s if with_im else 0), flops


def reset_launches(*modules) -> None:
    for m in modules:
        for k in m.LAUNCHES:
            m.LAUNCHES[k] = 0


def check_corr_bwd(timer, dev, gen) -> dict:
    """k2_check / k3_check: the backward kernels against autograd through
    cost_volume_ref, same inputs and dtype; times at the train shapes."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    main = {"k2_check": {}, "k3_check": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in CORR_TRAIN + K1_RAGGED:
            f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            g = torch.randn(shape[:3] + (81,), device=dev,
                            generator=gen).to(dtype)
            got = ck.cost_volume_bwd_cuda(g, f1, f2)
            a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            want = torch.autograd.grad(cost_volume_ref(a1, a2), (a1, a2), g)
            torch.cuda.synchronize()
            tol = TOL[("corr_bwd", dtype)]
            for i, phase in enumerate(("k2_check", "k3_check")):
                err, rel = rel_err(got[i], want[i])
                row = {"phase": phase, "shape": shape, "dtype": str(dtype),
                       "max_abs_err": err, "rel_err": rel, "tol": tol}
                if shape in CORR_TRAIN and dtype == torch.bfloat16:
                    need = (i == 0, i == 1)
                    a = (f1.clone().requires_grad_(need[0]),
                         f2.clone().requires_grad_(need[1]))
                    out = cost_volume_ref(*a)
                    nbytes, flops = corr_bwd_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        ms=timer(lambda: ck.cost_volume_bwd_cuda(
                            g, f1, f2, need_f1=need[0], need_f2=need[1])),
                        plain_ms=timer(lambda: torch.autograd.grad(
                            out, a[i], g, retain_graph=True),
                            reps=20, inner=2),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    del out
                    main[phase][shape] = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"{phase} disagrees at {shape} "
                                         f"{dtype}: {rel} > {tol}")
    return main


def stem_params(dev, seed: int):
    """The model's stem init, with non-zero biases (a wrong SAME-padding
    mask shows only then)."""
    from pwcnet_tpu_torch.models.init import init_params
    from pwcnet_tpu_torch.models.layers import StemConvs
    cpu_gen = torch.Generator().manual_seed(seed)
    stem_mod = StemConvs(16, 32)
    init_params(stem_mod, cpu_gen)
    with torch.no_grad():
        for conv in (stem_mod.conv1, stem_mod.conv2, stem_mod.conv3,
                     stem_mod.conv4):
            conv.bias.copy_(0.1 * torch.randn(conv.bias.shape,
                                              generator=cpu_gen))
    return stem_mod.to(dev).params()


def check_stem_bwd(timer, dev, gen) -> dict:
    """k5_check: the stem backward kernel against autograd through
    stem_ref. f32: directly; at the small shapes both are also read against
    float64, and a kernel further than TOL from the plain version must
    match float64 with one LeakyReLU slope swapped where the pre-activation
    is within f32 rounding of 0 (see TOL). bf16: by
    its error against an f32 oracle beside the plain bf16 autograd's error,
    its distance from stem_bwd_bf16_ref, and a second call that must be
    bit-identical. Times at the train shape."""
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    params = stem_params(dev, seed=2)
    main = None

    def plain_grads(im, ps, g):
        a = im.clone().requires_grad_()
        p = [(w.detach().clone().requires_grad_(),
              b.detach().clone().requires_grad_()) for w, b in ps]
        flat = [t for pair in p for t in pair]
        return torch.autograd.grad(sk.stem_ref(a, p), [a, *flat], g)

    def cast(ps, dtype):
        return [(w.to(dtype), b.to(dtype)) for w, b in ps]

    def near_zero_f64(im):
        """Per layer, the float64 pre-activations within the bound on an
        f32 sum of their terms, as (|z| / sum|terms|, flat index), the
        nearest to 0 first."""
        from pwcnet_tpu_torch.ops.conv import conv_same, leaky_relu
        x, out = im.double().permute(0, 3, 1, 2), []
        for (w, b), stride in zip(cast(params, torch.float64), (2, 1, 2, 1)):
            z = conv_same(x, w, b, stride=stride).flatten()
            mag = conv_same(x.abs(), w.abs(), b.abs(), stride=stride)
            ratio = z.abs() / mag.flatten()
            near = torch.nonzero(ratio <= (9 * w.shape[1] + 1) * F32_UNIT)
            out.append(sorted((ratio[i].item(), i.item())
                              for i in near.flatten()))
            x = leaky_relu(z.view_as(mag))
        return out

    def grads_f64_swapped(im, g, layer, index):
        """Float64 gradients with the LeakyReLU's slope (1 or 0.1) swapped
        at flat pre-activation ``index`` of conv ``layer``."""
        from pwcnet_tpu_torch.ops.conv import conv_same
        a = im.double().requires_grad_()
        ps = [t.clone().requires_grad_() for pair in
              cast(params, torch.float64) for t in pair]
        x = a.permute(0, 3, 1, 2)
        for lay, stride in enumerate((2, 1, 2, 1)):
            z = conv_same(x, ps[2 * lay], ps[2 * lay + 1], stride=stride)
            slope = torch.where(z > 0, 1.0, 0.1).double().contiguous()
            if lay == layer:
                slope.view(-1)[index] = 1.1 - slope.view(-1)[index]
            x = z * slope
        return torch.autograd.grad(x.permute(0, 2, 3, 1), [a, *ps],
                                   g.double())

    cases = ([(dt, sh) for dt in (torch.bfloat16, torch.float32)
              for sh in [STEM_TRAIN] + STEM_RAGGED]
             + [(dt, sh) for dt in (torch.bfloat16, torch.float32)
                for sh in STEM_LOOPED])
    for dtype, shape in cases:
        im = torch.rand(shape, device=dev, generator=gen).to(dtype)
        g = torch.randn((shape[0], shape[1] // 4, shape[2] // 4, 32),
                        device=dev, generator=gen).to(dtype)
        d_im, dp = sk.stem_bwd_cuda(im, params, g)
        got = [d_im] + [t for pair in dp for t in pair]
        plain = plain_grads(im, params, g)
        row = {"phase": "k5_check", "shape": shape, "dtype": str(dtype),
               "grads": "d_im, dW1, db1, ..., dW4, db4"}
        model_rel, model_tols = [], []
        if dtype == torch.float32:
            errs = decide = [rel_err(a, b) for a, b in zip(got, plain)]
            tols = [TOL[("stem_bwd", dtype)]] * len(errs)
            if shape != STEM_TRAIN:
                exact = plain_grads(im.double(), cast(params, torch.float64),
                                    g.double())
                near = near_zero_f64(im)
                row.update(
                    kernel_rel_err_vs_f64=[rel_err(a, b)[1]
                                           for a, b in zip(got, exact)],
                    plain_rel_err_vs_f64=[rel_err(a, b)[1]
                                          for a, b in zip(plain, exact)],
                    near_zero_f64=[len(n) for n in near])
                if max(e[1] for e in errs) > tols[0]:
                    # Which single swapped slope, if any, the kernel took.
                    tried = []
                    for layer, cands in enumerate(near):
                        for ratio, index in cands[:STEM_FLIPS_TRIED]:
                            alt = grads_f64_swapped(im, g, layer, index)
                            tried.append(([rel_err(a, b) for a, b in
                                           zip(got, alt)], layer, index,
                                          ratio))
                    if tried:
                        decide, layer, index, ratio = min(
                            tried, key=lambda t: max(e[1] for e in t[0]))
                        row["swapped_slope"] = {
                            "conv": layer + 1, "flat_index": index,
                            "z_over_sum_abs_terms": ratio,
                            "rel_err_vs_swapped_f64": [e[1] for e in decide]}
        else:
            oracle = plain_grads(
                im.float(), [(w.to(dtype).float(), b.to(dtype).float())
                             for w, b in params], g.float())
            errs = decide = [rel_err(a, b) for a, b in zip(got, oracle)]
            plain_rel = [rel_err(a, b)[1] for a, b in zip(plain, oracle)]
            tols = [max(STEM_BWD_BF16[0] * e, STEM_BWD_BF16[1])
                    for e in plain_rel]
            # The same inputs again: bit-identical (fixed-order sums).
            d_im2, dp2 = sk.stem_bwd_cuda(im, params, g)
            repeat = all(torch.equal(a, b) for a, b in zip(
                got, [d_im2] + [t for pair in dp2 for t in pair]))
            # The kernel's own arithmetic in plain torch.
            m_im, mp = sk.stem_bwd_bf16_ref(im, params, g)
            model_rel = [rel_err(a, b)[1] for a, b in zip(
                got, [m_im] + [t for pair in mp for t in pair])]
            model_tols = [sk.BF16_MODEL_TOL[0]] + [sk.BF16_MODEL_TOL[1]] * 8
            row.update(plain_bf16_rel=plain_rel, bit_identical_repeat=repeat,
                       rel_err_vs_bf16_model=model_rel,
                       model_tol=sk.BF16_MODEL_TOL)
        torch.cuda.synchronize()
        rels = [e[1] for e in errs]
        # Against the plain version in the same dtype (bf16: beside the
        # oracle comparison that decides).
        row.update(max_abs_err=max(rel_err(a, b)[0]
                                   for a, b in zip(got, plain)),
                   max_abs_err_vs_oracle=max(e[0] for e in errs),
                   rel_err=rels, tol=tols)
        if shape == STEM_TRAIN and dtype == torch.bfloat16:
            # The train step's form: no d_im (images need no gradient).
            a = im.clone()
            p = [(w.detach().clone().requires_grad_(),
                  b.detach().clone().requires_grad_()) for w, b in params]
            flat = [t for pair in p for t in pair]
            out = sk.stem_ref(a, p)
            nbytes, flops = stem_bwd_cost(shape, dtype, with_im=False)
            b, tb, to = bound_ms(nbytes, flops, dtype)
            row.update(
                ms=timer(lambda: sk.stem_bwd_cuda(im, params, g,
                                                  need_im=False)),
                ms_with_d_im=timer(lambda: sk.stem_bwd_cuda(im, params, g)),
                plain_ms=timer(lambda: torch.autograd.grad(
                    out, flat, g, retain_graph=True)),
                bound_ms=b, bytes_ms=tb, ops_ms=to)
            del out
            # The CUDA kernels of one call (the wrapper's included).
            busy, n_launch, top = profile_kernels(
                lambda: sk.stem_bwd_cuda(im, params, g, need_im=False))
            row.update(profile_busy_ms=busy,
                       profile_kernels_per_call=n_launch, profile_top=top)
            main = row
        emit(row)
        bad = [(r, t) for r, t in zip([e[1] for e in decide] + model_rel,
                                      tols + model_tols) if not r <= t]
        if bad:
            raise AssertionError(f"K5 disagrees at {shape} {dtype}: {bad}")
        if row.get("bit_identical_repeat") is False:
            raise AssertionError(f"K5 at {shape} {dtype}: two calls on the "
                                 "same inputs differ")
    return main


def time_train_shapes(timer, dev, gen) -> dict:
    """K1 and K4 at the train step's shapes (bf16), for the kernels line;
    K1 held to TOL there too."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    dtype = torch.bfloat16
    rows = {"corr_fwd": [], "stem_fwd": []}
    with torch.inference_mode():
        for shape in CORR_TRAIN:
            f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            err, rel = rel_err(ck.cost_volume_cuda(f1, f2),
                               cost_volume_ref(f1, f2))
            if not rel <= TOL[("corr", dtype)]:
                raise AssertionError(f"K1 disagrees at {shape} {dtype}: "
                                     f"{rel}")
            nbytes, flops = corr_cost(shape, dtype)
            b, tb, to = bound_ms(nbytes, flops, dtype)
            rows["corr_fwd"].append(dict(
                shape=shape, plan=ck.band_plan(*shape[:3]), max_abs_err=err,
                rel_err=rel,
                ms=timer(lambda: ck.cost_volume_cuda(f1, f2)),
                plain_ms=timer(lambda: cost_volume_ref(f1, f2), inner=2),
                bound_ms=b, bytes_ms=tb, ops_ms=to))
        params = stem_params(dev, seed=3)
        im = torch.rand(STEM_TRAIN, device=dev, generator=gen).to(dtype)
        err = rel_err(sk.stem_cuda(im, params), sk.stem_ref(im, params))[0]
        nbytes, flops = stem_cost(STEM_TRAIN, dtype)
        b, tb, to = bound_ms(nbytes, flops, dtype)
        row = dict(shape=STEM_TRAIN, max_abs_err=err,
                   ms=timer(lambda: sk.stem_cuda(im, params)),
                   plain_ms=timer(lambda: sk.stem_ref(im, params)),
                   bound_ms=b, bytes_ms=tb, ops_ms=to)
        row["over_plain"] = row["ms"] / row["plain_ms"]  # target <= 0.5
        row["layer_bytes_ms"] = (stem_layer_bytes(STEM_TRAIN, dtype)
                                 / HBM_BYTES_PER_S * 1e3)
        rows["stem_fwd"].append(row)
    for name, rs in rows.items():
        emit({"phase": "train_shape_times", "kernel": name, "rows": rs})
    return rows


# The trainer's log directories (checkpoints of ~100 MB each); removed at
# the end, after its metrics are copied to the output directory.
RUN_DIR = os.path.join("build", "chip_smoke_runs")


def train_config(name: str, **train_kw):
    import dataclasses
    from pwcnet_tpu_torch.config import PRESETS
    cfg = PRESETS["synthetic-proof"]
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_dir=os.path.join(RUN_DIR, name), **train_kw))


def train_phases(out_dir: str, dev, smi: str, timer) -> dict:
    """train_steps, overfit, train_f32_card_vs_cpu, train_times."""
    import shutil
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model, train
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step

    # -- train_steps: the trainer's entry point on the card ----------------
    cfg = train_config("train", summary_interval=1)
    shutil.rmtree(cfg.train.log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches(ck, sk)
    t0 = time.perf_counter()
    final = train(cfg, max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {**ck.LAUNCHES, **sk.LAUNCHES}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    with open(os.path.join(cfg.train.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [{k: r[k] for k in ("step", "loss", "train_epe", "grad_norm",
                                "lr")} for r in recs]
    finite = all(np.isfinite([r["loss"], r["train_epe"], r["grad_norm"]]
                             ).all() for r in steps)
    ckpt = CheckpointManager(os.path.join(cfg.train.log_dir, "ckpt"))
    ckpt_step = ckpt.latest_step
    model = build_model(cfg)
    fresh = TrainState.create(model, *optimizer_from_config(
        model.parameters(), cfg.train), seed=cfg.train.seed + 1)
    ckpt.restore(fresh)
    saved = ckpt.load()["model"]
    restored = (fresh.step == TRAIN_STEPS and all(
        torch.equal(v.cpu(), saved[k]) for k, v in
        fresh.model.state_dict().items())
        and fresh.scheduler.last_epoch == TRAIN_STEPS)
    resumed = train(cfg, max_steps=2)["step"]  # continues from the checkpoint
    shutil.copy(os.path.join(cfg.train.log_dir, "metrics.jsonl"),
                os.path.join(out_dir, "train_metrics.jsonl"))
    shutil.rmtree(RUN_DIR)
    emit({"phase": "train_steps", "config": "synthetic-proof, bf16, "
          f"batch {cfg.train.global_batch}, {cfg.data.augment.crop_hw}",
          "steps": steps, "final": final, "wall_s": wall_s,
          "launches_per_step": per_step, "finite": finite,
          "checkpoint_step": ckpt_step, "restored": restored,
          "resumed_to_step": resumed})
    if not finite or len(steps) != TRAIN_STEPS:
        raise AssertionError(f"train steps not finite: {steps}")
    if per_step != TRAIN_LAUNCHES:
        raise AssertionError(f"expected {TRAIN_LAUNCHES} kernel launches per "
                             f"train step, got {per_step}")
    if not restored or resumed != TRAIN_STEPS + 2:
        raise AssertionError(f"checkpoint round trip failed: restored="
                             f"{restored}, resumed to {resumed}")

    # -- overfit: one fixed batch, the preset's optimizer ------------------
    cfg = train_config("overfit")
    model = build_model(cfg)
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    state = TrainState.create(model, opt, sched, seed=1)
    step_fn = make_train_step(model, opt, sched)
    batcher = make_device_batcher(cfg.train.global_batch,
                                  cfg.data.augment.crop_hw, seed=5,
                                  device=dev)
    batch = batcher(0)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    emit({"phase": "overfit", "steps": OVERFIT_STEPS, "losses": losses})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"overfit loss did not fall: {losses}")

    # -- train_f32_card_vs_cpu: one f32 step, same weights and batch -------
    import dataclasses
    from unittest import mock

    import pwcnet_tpu_torch.models.layers as layers_mod
    import pwcnet_tpu_torch.models.pwcnet as pwcnet_mod
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    small = make_device_batcher(2, (128, 192), seed=6, device="cpu")(0)
    ref_state = build_model(cfg32, "cpu").state_dict()

    def f32_step(where, im_noise=0.0, seed=0, fused=False):
        model = PWCNet(corr_backend="fused", fused_min_pixels=0,
                       device=where) if fused else build_model(cfg32, where)
        model.load_state_dict(ref_state)
        opt, sched = optimizer_from_config(model.parameters(), cfg32.train)
        step_fn = make_train_step(model, opt, sched)
        batch = {k: v.clone() for k, v in small.items()}
        if im_noise:
            gen = torch.Generator().manual_seed(seed)
            batch["im1"] *= 1 + im_noise * torch.randn(batch["im1"].shape,
                                                       generator=gen)
        _, m = step_fn(TrainState.create(model, opt, sched, seed=1),
                       {k: v.to(where) for k, v in batch.items()})
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})

    def grad_rel(a, b):
        return {n: rel_err(a[n], b[n])[1] for n in b}

    m_cpu, g_cpu = f32_step("cpu")
    m_card, g_card = f32_step(dev)
    # The same step on the card with the plain versions in place of the
    # kernels: the kernels' own share of the card-vs-CPU difference.
    with mock.patch.object(pwcnet_mod, "cost_volume",
                           lambda a, b, max_displacement: cost_volume_ref(
                               a, b, max_displacement)), \
            mock.patch.object(layers_mod, "stem", layers_mod.stem_ref):
        _, g_plain = f32_step(dev)
    # LeakyReLU and the warp's coverage mask make the gradient jump where an
    # activation crosses its threshold, so any two f32 evaluations that
    # differ in their last bits differ there. The floor: CPU steps whose
    # frame-1 pixels are scaled by 1 + 1e-6 * N(0, 1), three draws.
    floor = max(max(grad_rel(f32_step("cpu", 1e-6, s)[1], g_cpu).values())
                for s in range(3))
    metric_rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                  for k in m_cpu}
    vs_cpu, vs_plain = grad_rel(g_card, g_cpu), grad_rel(g_card, g_plain)
    tol = max(TRAIN_TOL, FLOOR_FACTOR * floor)
    # The fused model (K6 at every warped level) on the card against the
    # same CPU step: on the CPU the fused op is the composed plain ops.
    m_fused, g_fused = f32_step(dev, fused=True)
    fused_metric_rel = {k: abs(m_fused[k] - m_cpu[k]) / abs(m_cpu[k])
                        for k in m_cpu}
    fused_vs_cpu = grad_rel(g_fused, g_cpu)
    emit({"phase": "train_f32_card_vs_cpu", "batch": [2, 128, 192],
          "metrics_cpu": m_cpu, "metrics_card": m_card,
          "metric_rel_err": metric_rel, "metric_tol": TRAIN_TOL,
          "grad_rel_err_vs_cpu_max": max(vs_cpu.values()),
          "grad_rel_err_vs_cpu_worst3": sorted(
              vs_cpu.items(), key=lambda t: -t[1])[:3],
          "cpu_floor_1e-6": floor, "grad_tol": tol,
          "grad_rel_err_vs_card_plain_max": max(vs_plain.values()),
          "grad_rel_err_vs_card_plain_worst3": sorted(
              vs_plain.items(), key=lambda t: -t[1])[:3],
          "fused_metric_rel_err": fused_metric_rel,
          "fused_grad_rel_err_vs_cpu_max": max(fused_vs_cpu.values()),
          "fused_grad_rel_err_vs_cpu_worst3": sorted(
              fused_vs_cpu.items(), key=lambda t: -t[1])[:3]})
    if not (max(metric_rel.values()) <= TRAIN_TOL
            and max(fused_metric_rel.values()) <= TRAIN_TOL
            and max(vs_cpu.values()) <= tol
            and max(fused_vs_cpu.values()) <= tol
            and max(vs_plain.values()) <= tol):
        raise AssertionError("f32 train step: card and CPU (or card plain) "
                             "disagree beyond the tolerances")

    # -- train_times: the bf16 step at batch 8 -----------------------------
    cfg = train_config("times")
    model = build_model(cfg)
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    state = TrainState.create(model, opt, sched, seed=1)
    step_fn = make_train_step(model, opt, sched)

    def one_step():
        step_fn(state, batch)

    step_wall = wall_ms(one_step, reps=10)
    step_dev = timer(one_step, reps=10, inner=1)
    batch_wall = wall_ms(lambda: batcher(1), reps=10)
    busy, n_launch, top = profile_kernels(one_step)
    emit({"phase": "train_times", "dtype": "bfloat16",
          "batch": [cfg.train.global_batch, *cfg.data.augment.crop_hw],
          "ms_per_step_wall": step_wall, "ms_per_step_device": step_dev,
          "pairs_per_s_wall": cfg.train.global_batch * 1e3 / step_wall,
          "batch_render_ms_wall": batch_wall,
          "device_busy_ms_per_step": busy,
          "idle_share_of_wall": 1 - busy / step_wall,
          "kernel_launches_per_step": n_launch, "top": top,
          "nvidia_smi": smi})
    return per_step


def k6_flow(shape, kind, dev, gen):
    n, h, w, _ = shape
    if kind.startswith("normal"):
        return float(kind[6:]) * torch.randn((n, h, w, 2), device=dev,
                                             generator=gen)
    flow = torch.randint(-3, 4, (n, h, w, 2), device=dev,
                         generator=gen).float()
    far = torch.rand((n, h, w), device=dev, generator=gen) < 0.25
    sign = torch.where(torch.rand((n, h, w, 2), device=dev, generator=gen)
                       < 0.5, -1.0, 1.0)
    return torch.where(far[..., None], 1000.0 * sign, flow)


def check_k6(timer, dev, gen) -> dict:
    """k6_check: K6 against warp_corr_ref (K1's tolerances) at the warped
    levels of a 448x1024 pair and of the train step, ragged shapes and
    W = 8192, for every flow kind; times in bf16 at the first two sets
    (normal4 flows); then WarpCorrFunction's gradients against autograd
    through the plain version."""
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.ops.warp_corr import warp_corr_ref
    timed = {"main": {}, "train": {}}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in K6_MAIN + K6_TRAIN + K6_RAGGED:
                f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                errs = {}
                for kind in K6_FLOWS:
                    flow = k6_flow(shape, kind, dev, gen)
                    got = wk.warp_corr_cuda(f1, f2, flow)
                    want = warp_corr_ref(f1, f2, flow)
                    torch.cuda.synchronize()
                    errs[kind] = rel_err(got, want)
                    if kind == "integer_and_far":
                        far = (flow.abs() == 1000).any(-1)
                        if not bool((got[..., 40][far] == 0).all()):
                            raise AssertionError(f"K6 at {shape}: far-out "
                                                 "pixels are not 0")
                tol = TOL[("corr", dtype)]
                row = {"phase": "k6_check", "shape": shape,
                       "dtype": str(dtype),
                       "max_abs_err": max(e[0] for e in errs.values()),
                       "rel_err": {k: e[1] for k, e in errs.items()},
                       "tol": tol}
                where = ("main" if shape in K6_MAIN else "train"
                         if shape in K6_TRAIN else None)
                if where and dtype == torch.bfloat16:
                    flow = k6_flow(shape, "normal4", dev, gen)
                    nbytes, flops = warp_corr_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        ms=timer(lambda: wk.warp_corr_cuda(f1, f2, flow)),
                        plain_ms=timer(lambda: warp_corr_ref(f1, f2, flow),
                                       inner=2),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    timed[where][shape] = row
                emit(row)
                bad = {k: e[1] for k, e in errs.items() if not e[1] <= tol}
                if bad:
                    raise AssertionError(f"K6 disagrees at {shape} {dtype}: "
                                         f"{bad} > {tol}")
    for dtype in (torch.float32, torch.bfloat16):
        for shape in K6_GRAD_SHAPES:
            kind = "integer_and_far" if shape[0] == 2 else "normal4"
            ins = [torch.randn(shape, device=dev, generator=gen).to(dtype),
                   torch.randn(shape, device=dev, generator=gen).to(dtype),
                   k6_flow(shape, kind, dev, gen)]
            g = torch.randn(shape[:3] + (81,), device=dev,
                            generator=gen).to(dtype)
            a = [t.clone().requires_grad_() for t in ins]
            got = torch.autograd.grad(wk.warp_corr_fn(*a), a, g)
            b = [t.clone().requires_grad_() for t in ins]
            want = torch.autograd.grad(warp_corr_ref(*b), b, g)
            torch.cuda.synchronize()
            rels = [rel_err(x, y)[1] for x, y in zip(got, want)]
            tol = TOL[("corr_bwd", dtype)]
            emit({"phase": "k6_grad_check", "shape": shape,
                  "dtype": str(dtype), "flow": kind,
                  "grads": "df1, df2, dflow", "rel_err": rels, "tol": tol})
            if not max(rels) <= tol:
                raise AssertionError(f"K6 gradients disagree at {shape} "
                                     f"{dtype}: {rels} > {tol}")
    return timed


def k6_crossover(timer, dev, gen) -> dict:
    """k6_crossover: per warped level, bf16, K6 against warp_bilinear + K1,
    forward and forward + backward (df1, df2, dflow), at the levels of a
    448x1024 pair and of the train step. A level fuses by default when K6's
    forward wins there and at every larger level of both sets; the
    smallest such level's pixel count is the measured FUSED_MIN_PIXELS.
    Forward + backward is reported beside it: the two backwards are the
    same ops (the warp's forward recomputed and its autograd, K2, K3), so
    there the paths differ by K6 - K1."""
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.ops.warp import warp_bilinear
    from pwcnet_tpu_torch.ops.warp_corr import FUSED_MIN_PIXELS
    dtype = torch.bfloat16
    rows = []
    for shape in K6_MAIN + K6_TRAIN:
        ins = [torch.randn(shape, device=dev, generator=gen).to(dtype),
               torch.randn(shape, device=dev, generator=gen).to(dtype),
               k6_flow(shape, "normal4", dev, gen)]
        g = torch.randn(shape[:3] + (81,), device=dev,
                        generator=gen).to(dtype)
        a = [t.clone().requires_grad_() for t in ins]
        with torch.inference_mode():
            fused_fwd = timer(lambda: wk.warp_corr_cuda(*ins))
            comp_fwd = timer(lambda: ck.cost_volume_cuda(
                ins[0], warp_bilinear(ins[1], ins[2])))
        fused_both = timer(lambda: torch.autograd.grad(
            wk.warp_corr_fn(*a), a, g), inner=2)
        comp_both = timer(lambda: torch.autograd.grad(ck.cost_volume_fn(
            a[0], warp_bilinear(a[1], a[2])), a, g), inner=2)
        row = {"shape": shape, "pixels": shape[1] * shape[2],
               "fused_fwd_ms": fused_fwd, "composed_fwd_ms": comp_fwd,
               "fused_fwd_bwd_ms": fused_both,
               "composed_fwd_bwd_ms": comp_both,
               "fused_wins": fused_fwd < comp_fwd,
               "fused_wins_fwd_bwd": fused_both < comp_both}
        rows.append(row)
    wins = {}
    for r in rows:
        wins[r["pixels"]] = wins.get(r["pixels"], True) and r["fused_wins"]
    measured = 1 << 30  # above every level: K6 wins nowhere
    for px in sorted(wins, reverse=True):
        if not wins[px]:
            break
        measured = px
    out = {"phase": "k6_crossover", "dtype": "bfloat16", "rows": rows,
           "fused_min_pixels_measured": measured,
           "fused_min_pixels_default": FUSED_MIN_PIXELS,
           "default_agrees": all(
               (px >= FUSED_MIN_PIXELS) == (px >= measured) for px in wins)}
    emit(out)
    return out


def fused_forward(dev, base, timer, smi) -> dict:
    """forward_fused_bf16: PWCNet(corr_backend="fused", fused_min_pixels=0)
    at 448x1024, batch 1: launches, finite flows, times; then the f32
    fused forward on the card against the CPU per level."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    im1 = torch.from_numpy(base)[None].to(dev)
    im2 = torch.from_numpy(np.roll(base, (2, 5), (0, 1)))[None].to(dev)
    model = PWCNet(dtype=torch.bfloat16, corr_backend="fused",
                   fused_min_pixels=0,
                   generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        model(im1, im2)  # warm-up
        torch.cuda.synchronize()
        reset_launches(ck, sk, wk)
        flows = model(im1, im2)
        torch.cuda.synchronize()
        launches = {k: v for m in (ck, sk, wk) for k, v in m.LAUNCHES.items()
                    if v}
        finite = all(bool(torch.isfinite(f).all()) for f in flows)
        shapes = [tuple(f.shape) for f in flows]
        wall = wall_ms(lambda: model(im1, im2))
        dev_ms = timer(lambda: model(im1, im2), reps=20, inner=1)
        busy, n_launch, top = profile_kernels(lambda: model(im1, im2))
    emit({"phase": "forward_fused_bf16", "hw": [448, 1024],
          "flow_shapes": shapes, "finite": finite, "launches": launches,
          "ms_per_frame_batch1_wall": wall,
          "ms_per_frame_batch1_device": dev_ms,
          "device_busy_ms_per_frame": busy,
          "idle_share_of_wall": 1 - busy / wall,
          "kernel_launches_per_frame": n_launch, "top": top,
          "nvidia_smi": smi})
    if not finite or shapes[-1] != (1, 112, 256, 2):
        raise AssertionError(f"bad fused flows: finite={finite} "
                             f"shapes={shapes}")
    if launches != FUSED_FWD_LAUNCHES:
        raise AssertionError(f"expected {FUSED_FWD_LAUNCHES} launches per "
                             f"fused forward, got {launches}")

    cpu_model = PWCNet(corr_backend="fused", fused_min_pixels=0,
                       device="cpu").eval()
    card_model = PWCNet(corr_backend="fused", fused_min_pixels=0,
                        device=dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    a = torch.from_numpy(base[:384, :448])[None]
    b = torch.from_numpy(np.roll(base, (2, 5), (0, 1))[:384, :448])[None]
    inter_cpu, inter_card = {}, {}
    with torch.inference_mode():
        f_cpu = cpu_model(a, b, intermediates=inter_cpu)
        f_card = card_model(a.to(dev), b.to(dev), intermediates=inter_card)
    torch.cuda.synchronize()
    per_level = {key: [rel_err(g.cpu(), w)[1] for g, w in zip(got, want)]
                 for key, got, want in (
                     ("pyramid", inter_card["pyramid"], inter_cpu["pyramid"]),
                     ("corr", inter_card["corr"], inter_cpu["corr"]),
                     ("flows", f_card, f_cpu))}
    worst = max(max(v) for v in per_level.values())
    emit({"phase": "forward_fused_f32_card_vs_cpu", "hw": [384, 448],
          "rel_err": per_level, "tol": FWD_TOL})
    if not worst <= FWD_TOL:
        raise AssertionError(f"fused card and CPU forwards disagree: {worst}")
    return launches


def fused_train(dev, timer, smi) -> dict:
    """train_fused_steps: make_train_step on synthetic-proof batches (bf16,
    8 x 384x448) with PWCNet(corr_backend="fused", fused_min_pixels=0):
    launches per step, finite losses, ms per step and pairs/s."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.config import PRESETS
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    cfg = PRESETS["synthetic-proof"]
    model = PWCNet(dtype=torch.bfloat16, corr_backend="fused",
                   fused_min_pixels=0, device=dev,
                   generator=torch.Generator().manual_seed(cfg.train.seed))
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    state = TrainState.create(model, opt, sched, seed=1)
    step_fn = make_train_step(model, opt, sched)
    batcher = make_device_batcher(cfg.train.global_batch,
                                  cfg.data.augment.crop_hw,
                                  seed=cfg.train.seed, device=dev)
    batches = [batcher(i) for i in range(FUSED_TRAIN_STEPS)]
    torch.cuda.synchronize()
    reset_launches(ck, sk, wk)
    losses = []
    for batch in batches:
        state, m = step_fn(state, batch)
        losses.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    per_step = {k: v / FUSED_TRAIN_STEPS for m in (ck, sk, wk)
                for k, v in m.LAUNCHES.items() if v}
    batch = batches[0]
    step_wall = wall_ms(lambda: step_fn(state, batch), reps=10)
    step_dev = timer(lambda: step_fn(state, batch), reps=10, inner=1)
    busy, n_launch, top = profile_kernels(lambda: step_fn(state, batch))
    finite = all(np.isfinite(list(m.values())).all() for m in losses)
    emit({"phase": "train_fused_steps", "dtype": "bfloat16",
          "batch": [cfg.train.global_batch, *cfg.data.augment.crop_hw],
          "steps": losses, "finite": finite, "launches_per_step": per_step,
          "ms_per_step_wall": step_wall, "ms_per_step_device": step_dev,
          "pairs_per_s_wall": cfg.train.global_batch * 1e3 / step_wall,
          "device_busy_ms_per_step": busy,
          "idle_share_of_wall": 1 - busy / step_wall,
          "kernel_launches_per_step": n_launch, "top": top,
          "nvidia_smi": smi})
    if not finite:
        raise AssertionError(f"fused train steps not finite: {losses}")
    if per_step != FUSED_TRAIN_LAUNCHES:
        raise AssertionError(f"expected {FUSED_TRAIN_LAUNCHES} launches per "
                             f"fused train step, got {per_step}")
    return per_step


def check_k1p(timer, dev, gen) -> dict:
    """k1p_check: K1p against cost_volume_prepadded_ref, bf16 and f32, at
    the shard-local levels of a 512x1024 pair under S = 2 and 4 and ragged
    shapes, f2 with d = 4 random real halo rows; timed (bf16) at S = 2."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_prepadded_ref
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    timed = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in K1P[2] + K1P[4] + K1P_RAGGED:
                n, t, w, c = shape
                f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                f2e = torch.randn((n, t + 8, w, c), device=dev,
                                  generator=gen).to(dtype)
                got = ck.cost_volume_prepadded_cuda(f1, f2e)
                want = cost_volume_prepadded_ref(f1, f2e)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                tol = TOL[("corr", dtype)]
                row = {"phase": "k1p_check", "shape": shape,
                       "dtype": str(dtype), "max_abs_err": err,
                       "rel_err": rel, "tol": tol}
                if shape in K1P[2] and dtype == torch.bfloat16:
                    nbytes, flops = corr_pre_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        plan=ck.band_plan(*shape[:3]),
                        ms=timer(lambda: ck.cost_volume_prepadded_cuda(
                            f1, f2e)),
                        plain_ms=timer(lambda: cost_volume_prepadded_ref(
                            f1, f2e), inner=2),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    timed[shape] = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"K1p disagrees at {shape} {dtype}: "
                                         f"{rel} > {tol}")
    return timed


def k6p_flow(shape, kind, halo, dev, gen):
    """Flows with d = 4 halo rows (t + 8 rows) of one of K6P_FLOWS."""
    n, t, w, _ = shape
    fshape = (n, t + 8, w, 2)
    if kind != "beyond":
        return k6_flow(fshape, kind, dev, gen)
    flow = torch.randn(fshape, device=dev, generator=gen)
    far = torch.rand((n, t + 8, w), device=dev, generator=gen) < 0.25
    sign = torch.where(torch.rand((n, t + 8, w), device=dev, generator=gen)
                       < 0.5, -1.0, 1.0)
    flow[..., 1] = torch.where(far, sign * (halo + 3) + flow[..., 1],
                               flow[..., 1])
    return flow


def check_k6p(timer, dev, gen) -> dict:
    """k6p_check: K6p against warp_corr_prepadded_ref, bf16 and f32, at the
    warped shard-local levels of a 512x1024 pair under S = 2 (the bottom
    shard) and S = 4 (an interior shard) and ragged shapes, random real
    halo rows, every flow of K6P_FLOWS (``beyond`` reaches past the halo:
    the clamp); timed (bf16, normal4 flows) at S = 2."""
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.ops.warp_corr import warp_corr_prepadded_ref
    cases = ([(sh, sh[1], 2 * sh[1]) for sh in K6P[2]]
             + [(sh, sh[1], 4 * sh[1]) for sh in K6P[4]] + K6P_RAGGED)
    timed = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape, row0, h in cases:
                n, t, w, c = shape
                halo = k6p_halo(t)
                f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                f2e = torch.randn((n, t + 2 * halo, w, c), device=dev,
                                  generator=gen).to(dtype)
                errs = {}
                for kind in K6P_FLOWS:
                    flow = k6p_flow(shape, kind, halo, dev, gen)
                    got = wk.warp_corr_prepadded_cuda(f1, f2e, flow, row0, h,
                                                      halo)
                    want = warp_corr_prepadded_ref(f1, f2e, flow, row0, h,
                                                   halo)
                    torch.cuda.synchronize()
                    errs[kind] = rel_err(got, want)
                tol = TOL[("corr", dtype)]
                row = {"phase": "k6p_check", "shape": shape, "row0": row0,
                       "h_global": h, "halo": halo, "dtype": str(dtype),
                       "max_abs_err": max(e[0] for e in errs.values()),
                       "rel_err": {k: e[1] for k, e in errs.items()},
                       "tol": tol}
                if shape in K6P[2] and dtype == torch.bfloat16:
                    flow = k6p_flow(shape, "normal4", halo, dev, gen)
                    nbytes, flops = warp_corr_pre_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        ms=timer(lambda: wk.warp_corr_prepadded_cuda(
                            f1, f2e, flow, row0, h, halo)),
                        plain_ms=timer(lambda: warp_corr_prepadded_ref(
                            f1, f2e, flow, row0, h, halo), inner=2),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    timed[shape] = row
                emit(row)
                bad = {k: e[1] for k, e in errs.items() if not e[1] <= tol}
                if bad:
                    raise AssertionError(f"K6p disagrees at {shape} {dtype}: "
                                         f"{bad} > {tol}")
    return timed


def check_k7(timer, dev, gen) -> dict:
    """k7_check: K7 against conv_ref at the stem chain of a 448x1024 pair
    and at K7_RAGGED, bf16 and f32, with LeakyReLU 0.1; the chain timed
    (bf16) beside F.conv2d + bias (the library row, which leaves out the
    LeakyReLU and pads a stride-2 conv symmetrically); then the chain
    through conv2d_folded, whose K7 launches are counted."""
    import torch.nn.functional as F
    from pwcnet_tpu_torch.ops.conv_folded import (conv2d_folded, conv_ref,
                                                  pick_g, unfold_w)
    from pwcnet_tpu_torch.ops.kernels import conv_folded_kernel as fk
    rows, params = [], []
    for shape, co, stride in K7_CHAIN + K7_RAGGED:
        ci = shape[-1]
        params.append((0.3 * torch.randn((3, 3, ci, co), device=dev,
                                         generator=gen),
                       0.1 * torch.randn((co,), device=dev, generator=gen)))
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for i, ((shape, co, stride), (w, b)) in enumerate(
                    zip(K7_CHAIN + K7_RAGGED, params)):
                x = torch.rand(shape, device=dev, generator=gen).to(dtype)
                got = fk.conv_folded_cuda(x, w, b, stride, 0.1)
                want = conv_ref(x, w, b, stride=stride, slope=0.1)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                tol = CONV_TOL[dtype]
                row = {"phase": "k7_check", "shape": shape, "co": co,
                       "stride": stride, "dtype": str(dtype),
                       "max_abs_err": err, "rel_err": rel, "tol": tol}
                if dtype == torch.bfloat16 and i < len(K7_CHAIN):
                    nbytes, flops = conv_cost(shape, co, stride, dtype)
                    bd, tb, to = bound_ms(nbytes, flops, dtype)
                    xc = x.permute(0, 3, 1, 2)  # channels-last NCHW view
                    wo, bo = w.permute(3, 2, 0, 1).to(dtype), b.to(dtype)
                    row.update(
                        ms=timer(lambda: fk.conv_folded_cuda(x, w, b, stride,
                                                             0.1)),
                        plain_ms=timer(lambda: conv_ref(x, w, b,
                                                        stride=stride,
                                                        slope=0.1)),
                        library_ms=timer(lambda: F.conv2d(
                            xc, wo, bo, stride=stride, padding=1)),
                        bound_ms=bd, bytes_ms=tb, ops_ms=to)
                    rows.append(row)
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"K7 disagrees at {shape} {dtype}: "
                                         f"{rel} > {tol}")
        # The entry point: the chain in folded layouts, counted.
        x = torch.rand(K7_CHAIN[0][0], device=dev, generator=gen).to(
            torch.bfloat16)
        torch.cuda.synchronize()
        reset_launches(fk)
        y, g = x, 1
        for (shape, co, stride), (w, b) in zip(K7_CHAIN, params):
            y = conv2d_folded(y, w, b, stride=stride, slope=0.1, in_g=g)
            g = pick_g(-(-shape[2] // stride), co)
        torch.cuda.synchronize()
        launches = fk.LAUNCHES["conv_folded"]
        ref = x
        for (shape, co, stride), (w, b) in zip(K7_CHAIN, params):
            ref = conv_ref(ref, w, b, stride=stride, slope=0.1)
        chain_rel = rel_err(unfold_w(y, g), ref)[1]
        more = torch.Generator(device=dev).manual_seed(MORE_SEED)
        for dtype in (torch.bfloat16, torch.float32):
            for shape, co, stride in K7_WIDE:
                ci = shape[-1]
                w = 0.3 * torch.randn((3, 3, ci, co), device=dev,
                                      generator=more)
                b = 0.1 * torch.randn((co,), device=dev, generator=more)
                x = torch.rand(shape, device=dev, generator=more).to(dtype)
                err, rel = rel_err(fk.conv_folded_cuda(x, w, b, stride, 0.1),
                                   conv_ref(x, w, b, stride=stride, slope=0.1))
                emit({"phase": "k7_check", "shape": shape, "co": co,
                      "stride": stride, "dtype": str(dtype),
                      "max_abs_err": err, "rel_err": rel,
                      "tol": CONV_TOL[dtype]})
                if not rel <= CONV_TOL[dtype]:
                    raise AssertionError(f"K7 disagrees at {shape}, Co={co} "
                                         f"{dtype}: {rel}")
    emit({"phase": "k7_chain", "launches": launches,
          "folded_shape": tuple(y.shape), "rel_err": chain_rel,
          "tol": 2 * CONV_TOL[torch.bfloat16]})
    if launches != len(K7_CHAIN) or not chain_rel <= 2 * CONV_TOL[
            torch.bfloat16]:
        raise AssertionError(f"K7 chain: {launches} launches, rel err "
                             f"{chain_rel}")
    return {"rows": rows, "launches": launches}


def backend_names(dev, base) -> None:
    """backends: the JAX model's backend names on the card. corr_backend=
    "lax" with stem_backend="lax" runs the plain ops (no kernel launch) and
    gives the kernels' flows per level (f32, FWD_TOL); stem_backend=
    "pallas" runs K4 and K1; build_model takes model.corr_backend=lax."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.config import apply_overrides
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.train.loop import build_model
    mods = (ck, sk, wk)
    a = torch.from_numpy(base[:384, :448])[None].to(dev)
    b = torch.from_numpy(np.roll(base, (2, 5), (0, 1))[:384, :448])[None].to(
        dev)

    def run(model):
        torch.cuda.synchronize()
        reset_launches(*mods)
        with torch.inference_mode():
            flows = model.eval()(a, b)
        torch.cuda.synchronize()
        return flows, {k: v for m in mods for k, v in m.LAUNCHES.items()
                       if v}

    kern = PWCNet(device=dev)
    want, _ = run(kern)
    lax = PWCNet(device=dev, corr_backend="lax", stem_backend="lax")
    pallas = PWCNet(device=dev, stem_backend="pallas")
    lax.load_state_dict(kern.state_dict())
    pallas.load_state_dict(kern.state_dict())
    got_lax, lax_launches = run(lax)
    got_pallas, pallas_launches = run(pallas)
    cfg = apply_overrides(train_config("backends"),
                          ["model.corr_backend=lax"])
    built = build_model(cfg, dev)
    got_built, built_launches = run(built)
    rel = [rel_err(g, w)[1] for g, w in zip(got_lax, want)]
    rel_pallas = [rel_err(g, w)[1] for g, w in zip(got_pallas, want)]
    built_ok = (built.corr_backend == "lax" and all(
        bool(torch.isfinite(f).all()) for f in got_built))
    emit({"phase": "backends", "lax_rel_err": rel,
          "pallas_rel_err": rel_pallas, "tol": FWD_TOL,
          "lax_launches": lax_launches, "pallas_launches": pallas_launches,
          "build_model_lax_launches": built_launches,
          "build_model_ok": built_ok})
    if (max(rel + rel_pallas) > FWD_TOL or lax_launches
            or pallas_launches != {"corr_fwd": 5, "stem_fwd": 1}
            or built_launches != {"stem_fwd": 1} or not built_ok):
        raise AssertionError("the backend names do not run as asked")


def spatial_expected(s: int, backend: str) -> dict:
    """Launches of one 512x1024 spatial forward on each of s ranks."""
    from pwcnet_tpu_torch.ops.warp_corr import fused_is_profitable
    k6p = 0
    if backend == "fused":
        k6p = sum(fused_is_profitable(512 // 2 ** lv // s, 1024 // 2 ** lv)
                  for lv in (5, 4, 3, 2))
    out = {"corr_fwd_prepadded": 5 - k6p, "stem_fwd": 1}
    if k6p:
        out["warp_corr_fwd_prepadded"] = k6p
    return out


def level_errs(flows, full, ref) -> list:
    return [rel_err(g.cpu(), w.cpu())[1]
            for g, w in zip([*flows, full], [*ref[0], ref[1]])]


def spatial_phases(dev, timer, smi) -> dict:
    """spatial_s1, spatial_s2, spatial_s4: parallel.spatial_forward at
    512x1024 against the unsharded port forward on the card (f32, TF32
    off, per level and the full-res flow, within FWD_TOL), with launch
    counts. S = 1 runs in this process; S = 2 and 4 in gloo rank processes
    on this card (halos staged through host memory), which load the kernels
    this process built. bf16 runs are timed (wall per forward)."""
    import shutil
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.parallel import (MeshConfig, make_mesh,
                                           spatial_forward)
    from pwcnet_tpu_torch.parallel.launch import run_ranks
    rng = np.random.default_rng(1)
    base = rng.random((*SPATIAL_HW, 3), np.float32)
    im1 = torch.from_numpy(base)[None]
    im2 = torch.from_numpy(np.roll(base, (2, 5), (0, 1)))[None]
    state = PWCNet(device="cpu", generator=torch.Generator().manual_seed(0)
                   ).state_dict()

    def model(backend, dtype):
        m = PWCNet(device=dev, corr_backend=backend, dtype=dtype).eval()
        m.load_state_dict(state)
        return m

    ref = {}
    with torch.inference_mode():
        for backend in ("pallas", "fused"):
            m = model(backend, torch.float32)
            flows = m(im1.to(dev), im2.to(dev))
            ref[backend] = (flows, m.full_res_flow(flows, SPATIAL_HW))
    results = {}

    # -- S = 1, this process ---------------------------------------------
    mesh = make_mesh(MeshConfig(spatial=1), device=dev)
    row = {"phase": "spatial_s1", "hw": list(SPATIAL_HW), "rel_err": {},
           "launches": {}, "tol": FWD_TOL, "nvidia_smi": smi}
    with torch.inference_mode():
        for backend in ("pallas", "fused"):
            flows, full = spatial_forward(model(backend, torch.float32),
                                          mesh, im1, im2)
            row["rel_err"][backend] = level_errs(flows, full, ref[backend])
            m = model(backend, torch.bfloat16)
            spatial_forward(m, mesh, im1, im2)  # warm-up
            torch.cuda.synchronize()
            reset_launches(ck, sk, wk)
            flows, full = spatial_forward(m, mesh, im1, im2)
            torch.cuda.synchronize()
            row["launches"][backend] = {k: v for mod in (ck, sk, wk)
                                        for k, v in mod.LAUNCHES.items() if v}
            row[f"finite_{backend}"] = all(
                bool(torch.isfinite(f).all()) for f in [*flows, full])
            row[f"ms_wall_bf16_{backend}"] = wall_ms(
                lambda: spatial_forward(m, mesh, im1, im2), reps=SPATIAL_REPS)
            row[f"ms_device_bf16_{backend}"] = timer(
                lambda: spatial_forward(m, mesh, im1, im2), reps=10, inner=1)
            busy, n_launch, _ = profile_kernels(
                lambda: spatial_forward(m, mesh, im1, im2))
            row[f"device_busy_ms_bf16_{backend}"] = busy
            row[f"kernel_launches_bf16_{backend}"] = n_launch
    emit(row)
    results[1] = row
    bad = [b for b in ("pallas", "fused")
           if row["launches"][b] != spatial_expected(1, b)
           or not row[f"finite_{b}"] or not max(row["rel_err"][b]) <= FWD_TOL]
    if bad:
        raise AssertionError(f"spatial_s1 failed for {bad}: {row}")

    # -- S = 2 and 4, one gloo process per rank on this card --------------
    for s in (2, 4):
        tasks = [dict(kind="forward", state_dict=state, im1=im1, im2=im2,
                      model=dict(corr_backend=b)) for b in ("pallas",
                                                            "fused")]
        if s == 2:
            tasks += [dict(kind="forward", state_dict=state, im1=im1,
                           im2=im2, reps=SPATIAL_REPS, profile=True,
                           model=dict(corr_backend=b, dtype=torch.bfloat16))
                      for b in ("pallas", "fused")]
        t0 = time.perf_counter()
        # The job files hold the weights (~40 MB): under build/, removed.
        job_dir = os.path.join(RUN_DIR, f"spatial_s{s}")
        runs = run_ranks(s, dict(backend="gloo", device=str(dev),
                                 allow_tf32=False, tasks=tasks), job_dir,
                         timeout=600)
        shutil.rmtree(job_dir)
        row = {"phase": f"spatial_s{s}", "hw": list(SPATIAL_HW),
               "seconds": time.perf_counter() - t0, "tol": FWD_TOL,
               "rel_err": {}, "launches": {}, "nvidia_smi": smi}
        ok = True
        for i, task in enumerate(tasks):
            backend = task["model"]["corr_backend"]
            key = backend + ("_bf16" if "dtype" in task["model"] else "")
            got = runs[0][i]
            launches = [r[i]["launches"] for r in runs]
            row["launches"][key] = launches[0]
            ok &= all(la == spatial_expected(s, backend) for la in launches)
            if "dtype" in task["model"]:
                row[f"finite_{key}"] = all(
                    bool(torch.isfinite(f).all())
                    for f in [*got["flows"], got["full"]])
                row[f"ms_wall_{key}"] = got["wall_ms"]
                row[f"profile_rank0_{key}"] = got["profile"]
                ok &= row[f"finite_{key}"]
            else:
                errs = level_errs(got["flows"], got["full"], ref[backend])
                row["rel_err"][key] = errs
                ok &= max(errs) <= FWD_TOL
        emit(row)
        results[s] = row
        if not ok:
            raise AssertionError(f"spatial_s{s} failed: {row}")
    return results


def cli_phase(out_dir: str) -> None:
    """cli: the command line in subprocesses, on the card: predict on the
    repo's parity pair (.flo and --vis PNG), eval of the fused config on 16
    synthetic val samples, and a train whose 10 steps cross eval_interval
    twice (val metrics and flow images written)."""
    import shutil
    from pwcnet_tpu_torch.io import read_flo, read_png
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PWCNET_PLATFORM", None)

    def run(*args):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pwcnet_tpu_torch.cli",
                               *args], cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):"
                                 f"\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        return (json.loads(proc.stdout.strip().splitlines()[-1]),
                time.perf_counter() - t0)

    fixtures = os.path.join(root, "tests", "fixtures", "parity")
    flo = os.path.join(out_dir, "cli_predict.flo")
    vis = os.path.join(out_dir, "cli_predict.png")
    pred, pred_s = run("predict", "--im1", os.path.join(fixtures, "im1.png"),
                       "--im2", os.path.join(fixtures, "im2.png"),
                       "--out", flo, "--vis", vis)
    flow, image = read_flo(flo), read_png(vis)
    pred_ok = (flow.shape == (128, 160, 2) and bool(np.isfinite(flow).all())
               and image.shape == (128, 160, 3))

    ev, ev_s = run("eval", "--preset", "synthetic-proof",
                   "model.corr_backend=fused", "train.eval_limit=16")
    ev_ok = ev["num_samples"] == 16 and bool(np.isfinite(ev["epe"]))

    log_dir = os.path.join(RUN_DIR, "cli_train")
    shutil.rmtree(log_dir, ignore_errors=True)
    final, train_s = run("train", "--preset", "synthetic-proof",
                         "--max-steps", "10", "train.eval_interval=5",
                         "train.eval_limit=16", "train.summary_interval=5",
                         f"train.log_dir={log_dir}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    val_steps = [r["step"] for r in recs if "val_epe" in r]
    images = sorted(os.listdir(os.path.join(log_dir, "images")))
    shutil.copy(os.path.join(log_dir, "metrics.jsonl"),
                os.path.join(out_dir, "cli_train_metrics.jsonl"))
    shutil.rmtree(log_dir)
    train_ok = (val_steps == [5, 10] and np.isfinite(final["val_epe"])
                and final["step"] == 10 and len(images) == 6)
    emit({"phase": "cli", "predict": pred, "predict_ok": pred_ok,
          "predict_s": pred_s, "eval": ev, "eval_ok": ev_ok, "eval_s": ev_s,
          "train_final": final, "train_val_steps": val_steps,
          "train_images": images, "train_ok": train_ok, "train_s": train_s})
    if not (pred_ok and ev_ok and train_ok):
        raise AssertionError("the command line's predict, eval or train "
                             "gave a wrong result")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                        help="directory for the results and the .flo file")
    out_dir = parser.parse_args().out
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from pwcnet_tpu_torch import PWCNet, predict_flow
    from pwcnet_tpu_torch.io import read_flo, write_flo
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import (build, conv_folded_kernel,
                                              cost_volume_kernel,
                                              stem_kernel, warp_corr_kernel)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(out_dir, exist_ok=True)

    # -- 1. Device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    build_s = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOGS.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})
    timer = Timer()

    # -- 2. K1 against cost_volume_ref ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_main = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in K1_MAIN + K1_RAGGED:
                f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
                got = cost_volume_kernel.cost_volume_cuda(f1, f2)
                want = cost_volume_ref(f1, f2)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                tol = TOL[("corr", dtype)]
                row = {"phase": "k1_check", "shape": shape,
                       "dtype": str(dtype), "max_abs_err": err,
                       "rel_err": rel, "tol": tol}
                if shape in K1_MAIN and dtype == torch.bfloat16:
                    nbytes, flops = corr_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        plan=cost_volume_kernel.band_plan(*shape[:3]),
                        ms=timer(lambda: cost_volume_kernel.cost_volume_cuda(
                            f1, f2)),
                        plain_ms=timer(lambda: cost_volume_ref(f1, f2),
                                       reps=20, inner=2),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    k1_main[shape] = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"K1 disagrees at {shape} {dtype}: "
                                         f"{rel} > {tol}")
        more = torch.Generator(device=dev).manual_seed(MORE_SEED)
        for dtype in (torch.bfloat16, torch.float32):
            for shape, d in K1_MORE:
                f1 = torch.randn(shape, device=dev, generator=more).to(dtype)
                f2 = torch.randn(shape, device=dev, generator=more).to(dtype)
                got = cost_volume_kernel.cost_volume_cuda(f1, f2, d)
                want = cost_volume_ref(f1, f2, d)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                tol = TOL[("corr", dtype)]
                emit({"phase": "k1_check", "shape": shape, "d": d,
                      "plan": cost_volume_kernel.band_plan(*shape[:3], d),
                      "dtype": str(dtype), "max_abs_err": err,
                      "rel_err": rel, "tol": tol})
                if not rel <= tol:
                    raise AssertionError(f"K1 disagrees at {shape}, d={d} "
                                         f"{dtype}: {rel} > {tol}")

    # -- 3. K4 against stem_ref --------------------------------------------
    params = stem_params(dev, seed=1)
    k4_main = None
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in [K4_MAIN] + K4_MORE + [STEM_TRAIN] + STEM_RAGGED:
                im = torch.rand(shape, device=dev, generator=(
                    gen if shape in [K4_MAIN] + K4_MORE else more)).to(dtype)
                got = stem_kernel.stem_cuda(im, params)
                want = stem_kernel.stem_ref(im, params)
                torch.cuda.synchronize()
                err, rel = rel_err(got, want)
                tol = TOL[("stem", dtype)]
                row = {"phase": "k4_check", "shape": shape,
                       "dtype": str(dtype), "max_abs_err": err,
                       "rel_err": rel, "tol": tol}
                if shape == K4_MAIN and dtype == torch.bfloat16:
                    nbytes, flops = stem_cost(shape, dtype)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(
                        ms=timer(lambda: stem_kernel.stem_cuda(im, params)),
                        plain_ms=timer(lambda: stem_kernel.stem_ref(
                            im, params)),
                        bound_ms=b, bytes_ms=tb, ops_ms=to)
                    k4_main = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"K4 disagrees at {shape} {dtype}: "
                                         f"{rel} > {tol}")

    # -- 3b. K2, K3 and K5 against autograd of the plain versions; K1 and
    # K4 timed at the train step's shapes --------------------------------
    corr_bwd_main = check_corr_bwd(timer, dev, gen)
    k5_main = check_stem_bwd(timer, dev, gen)
    train_shape = time_train_shapes(timer, dev, gen)

    # -- 3c. K6 against warp_corr_ref, its gradients, and the crossover
    # against warp + K1 per level ------------------------------------------
    k6_timed = check_k6(timer, dev, gen)
    k6_crossover(timer, dev, gen)

    # -- 3d. The spatial path's halo-row kernels K1p, K6p, and K7 -----------
    k1p_timed = check_k1p(timer, dev, gen)
    k6p_timed = check_k6p(timer, dev, gen)
    k7 = check_k7(timer, dev, gen)

    # -- 4. The whole forward ----------------------------------------------
    rng = np.random.default_rng(0)
    base = rng.random((448, 1024, 3), np.float32)
    im1 = torch.from_numpy(base)[None].to(dev)
    im2 = torch.from_numpy(np.roll(base, (2, 5), (0, 1)))[None].to(dev)
    model = PWCNet(dtype=torch.bfloat16,
                   generator=torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        model(im1, im2)  # warm-up
        torch.cuda.synchronize()
        reset_launches(cost_volume_kernel, stem_kernel, warp_corr_kernel)
        flows = model(im1, im2)
        torch.cuda.synchronize()
        launches = {k: v for m in (cost_volume_kernel, stem_kernel,
                                   warp_corr_kernel)
                    for k, v in m.LAUNCHES.items() if v}
    shapes = [tuple(f.shape) for f in flows]
    finite = all(bool(torch.isfinite(f).all()) for f in flows)
    emit({"phase": "forward_bf16", "flow_shapes": shapes, "finite": finite,
          "launches": launches,
          "max_abs_flow": max(f.abs().max().item() for f in flows)})
    if not finite or shapes[-1] != (1, 112, 256, 2):
        raise AssertionError(f"bad flows: finite={finite} shapes={shapes}")
    if launches != {"corr_fwd": 5, "stem_fwd": 1}:
        raise AssertionError(f"expected 5 + 1 kernel launches per forward, "
                             f"got {launches}")

    raw1 = rng.random((436, 1024, 3), np.float32)
    raw2 = np.roll(raw1, (1, 3), (0, 1))
    pred = predict_flow(model, raw1, raw2)
    path = os.path.join(out_dir, "predict.flo")
    write_flo(path, pred)
    back = read_flo(path)
    ok = (pred.shape == (436, 1024, 2) and bool(np.isfinite(pred).all())
          and np.array_equal(back, pred))
    emit({"phase": "predict_flow", "shape": pred.shape, "flo_round_trip": ok,
          "max_abs_flow": float(np.abs(pred).max())})
    if not ok:
        raise AssertionError("predict_flow or the .flo round trip failed")

    cpu_model = PWCNet(device="cpu").eval()
    card_model = PWCNet(device=dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    a = torch.from_numpy(base[:384, :448])[None]
    b = torch.from_numpy(np.roll(base, (2, 5), (0, 1))[:384, :448])[None]
    inter_cpu, inter_card = {}, {}
    with torch.inference_mode():
        f_cpu = cpu_model(a, b, intermediates=inter_cpu)
        f_card = card_model(a.to(dev), b.to(dev), intermediates=inter_card)
    torch.cuda.synchronize()
    per_level = {}
    for key, got, want in (("pyramid", inter_card["pyramid"],
                            inter_cpu["pyramid"]),
                           ("corr", inter_card["corr"], inter_cpu["corr"]),
                           ("flows", f_card, f_cpu)):
        per_level[key] = [rel_err(g.cpu(), w)[1] for g, w in zip(got, want)]
    worst = max(max(v) for v in per_level.values())
    emit({"phase": "forward_f32_card_vs_cpu", "hw": [384, 448],
          "rel_err": per_level, "tol": FWD_TOL})
    if not worst <= FWD_TOL:
        raise AssertionError(f"card and CPU forwards disagree: {worst}")

    backend_names(dev, base)

    # -- 4b. The fused forward (K6 at every warped level) --------------------
    fused_forward(dev, base, timer, smi)

    # -- 4c. The spatially sharded forward on 1, 2 and 4 ranks ---------------
    spatial = spatial_phases(dev, timer, smi)

    # -- 5. Times -------------------------------------------------------------
    with torch.inference_mode():
        b1_wall = wall_ms(lambda: model(im1, im2))
        b1_dev = timer(lambda: model(im1, im2), reps=20, inner=1)
        im1_4, im2_4 = im1.repeat(4, 1, 1, 1), im2.repeat(4, 1, 1, 1)
        b4_wall = wall_ms(lambda: model(im1_4, im2_4))
    emit({"phase": "forward_times", "dtype": "bfloat16", "hw": [448, 1024],
          "ms_per_frame_batch1_wall": b1_wall,
          "ms_per_frame_batch1_device": b1_dev,
          "frames_per_s_batch4_wall": 4e3 / b4_wall, "nvidia_smi": smi})

    # Where the device time of one bf16 448x1024 forward goes, by kernel.
    with torch.inference_mode():
        busy, n_launch, top = profile_kernels(lambda: model(im1, im2))
    emit({"phase": "forward_profile", "device_busy_ms_per_frame": busy,
          "idle_share_of_wall": 1 - busy / b1_wall,
          "kernel_launches_per_frame": n_launch, "top": top})

    # -- 5b. The trainer ------------------------------------------------
    train_launches = train_phases(out_dir, dev, smi, timer)
    fused_launches = fused_train(dev, timer, smi)

    # -- 5c. The command line -----------------------------------------------
    cli_phase(out_dir)

    # -- 6. Kernels: each at the train step's shapes (bf16), with its
    # launches per train step (K6: per fused train step) --------------------
    def entry(name, source, replaces, rows, launches=train_launches):
        nbytes = sum(r["bytes_ms"] for r in rows)
        ops = sum(r["ops_ms"] for r in rows)
        lib = [r.get("library_ms") for r in rows]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": int(launches[name]),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": "bytes" if nbytes >= ops else "operations",
                "library_ms": None if None in lib else sum(lib)}

    ck, sk = cost_volume_kernel, stem_kernel
    kernels = [
        entry("corr_fwd", ck.SOURCE, ck.REPLACES, train_shape["corr_fwd"]),
        entry("corr_bwd_f1", ck.BWD_SOURCE, ck.BWD_F1_REPLACES,
              list(corr_bwd_main["k2_check"].values())),
        entry("corr_bwd_f2", ck.BWD_SOURCE, ck.BWD_F2_REPLACES,
              list(corr_bwd_main["k3_check"].values())),
        entry("stem_fwd", sk.SOURCE, sk.REPLACES, train_shape["stem_fwd"]),
        entry("stem_bwd", sk.SOURCE, sk.BWD_REPLACES, [k5_main]),
        entry("warp_corr_fwd", warp_corr_kernel.SOURCE,
              warp_corr_kernel.REPLACES, list(k6_timed["train"].values()),
              fused_launches),
        # The spatial path: K1p and K6p at the S = 2 shard shapes, with
        # their launches per bf16 S = 2 spatial forward (rank 0; "pallas"
        # for K1p, "fused" for K6p); K7 at the 448x1024 stem chain, with
        # its launches per chain.
        entry("corr_fwd_prepadded", ck.SOURCE, ck.PRE_REPLACES,
              list(k1p_timed.values()), spatial[2]["launches"]["pallas_bf16"]),
        entry("warp_corr_fwd_prepadded", warp_corr_kernel.SOURCE,
              warp_corr_kernel.PRE_REPLACES, list(k6p_timed.values()),
              spatial[2]["launches"]["fused_bf16"]),
        entry("conv_folded", conv_folded_kernel.SOURCE,
              conv_folded_kernel.REPLACES, k7["rows"],
              {"conv_folded": k7["launches"]}),
    ]
    # K1 per level (bf16): the train step's, the 448x1024 pair's and K1p's
    # at the S = 2 shards, with the tile each launch takes.
    levels = {name: [{k: r[k] for k in ("shape", "plan", "ms", "bound_ms",
                                        "plain_ms")} for r in rs]
              for name, rs in (("train", train_shape["corr_fwd"]),
                               ("main_448x1024", list(k1_main.values())),
                               ("k1p_s2", list(k1p_timed.values())))}
    emit({"phase": "k1_levels", "levels": levels,
          "sum_ms": {k: sum(r["ms"] for r in v) for k, v in levels.items()},
          "sum_bound_ms": {k: sum(r["bound_ms"] for r in v)
                           for k, v in levels.items()}})
    emit({"phase": "inference_kernels", "corr_fwd_ms_448x1024": sum(
        r["ms"] for r in k1_main.values()), "stem_fwd_ms_448x1024":
        k4_main["ms"], "warp_corr_fwd_ms_448x1024": sum(
            r["ms"] for r in k6_timed["main"].values()),
        "launches_per_forward": launches})
    line = {"kernels": kernels}
    RESULTS.append(line)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
