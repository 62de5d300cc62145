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
kernels (K1, K6, K6p, K2 and K3 per level, with the plan of each bf16
launch: ``k1_levels``, ``k6_levels``, ``k2_levels``, ``k3_levels``), the
forwards and the train
steps with CUDA events. Then RAFT at full width: K1-K3 at its shapes
(``raft_kernels``, and K2 + K3 against the plain autograd backward), the
repo's trained checkpoint at 448x1024 (24 K1 per forward) with its val EPE
on synthetic-proof, its f32 forward against the CPU's, the trainer with the
sequence loss (24 of each of K1-K3 per step), and the command line's RAFT
``train``, ``predict`` and ``match``. Then the repo's trained PWC-Net
checkpoint (``pwc_trained``: bf16 launches, val EPE on synthetic-proof's 256
val pairs beside the TPU run's, f32 card vs CPU per level); the PWC-Net
with GroupNorm (``norm_forward``: bf16 448x1024, K1 5 and K4 0 launches, f32
card vs CPU per level; ``norm_train``: K1-K3 5/5/5 a step through
``train()``, the f32 step against the CPU); the parity harness on the
trained weights (``parity_trained``: the CLI's ``parity --sweep --ckpt DIR``
on the card against ``parity_report`` on the CPU) and the reference
``.pth`` import (``pth_import``: the same weights under the reference's key
names give bit-equal flows and the same report); and data-parallel
training on two ``gloo`` ranks sharing the card (``ddp_train``: PWC-Net bf16
with a checkpoint and a resume, f32 two ranks against one process, RAFT,
nccl's refusal of two ranks on one card). Each phase prints one JSON line;
any failure raises and the script exits non-zero. Without a CUDA device it
exits 1 at once. The last line is ``{"ok": true, "device": {...}}``; every
phase's result, the predicted flows and the trainer's logs go to ``DIR``
(default ``build/chip_smoke``).

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
# More K6 and K3 shapes, (shape, d): d < 4 at real widths (every tile of the
# bf16 kernels), and W = 17 at C = 196 (one m16 tile and a ragged one) for
# K3; drawn from their own generator after the other checks. K3_MORE also
# checks K2 on the same draws: the bf16 K2 runs on K3's band tile, so these
# cover its tiles, d < 4 and the ragged m16 tile too.
K6_MORE = [((1, 28, 64, 96), 1), ((8, 24, 28, 96), 2), ((1, 14, 32, 128), 3),
           ((2, 7, 13, 5), 2)]
K3_MORE = [((1, 5, 17, 196), 4), ((8, 12, 14, 128), 1), ((1, 28, 64, 96), 2),
           ((2, 9, 33, 32), 3)]
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
# K1_MORE, K7_WIDE, K6_MORE, K3_MORE and the K4 shapes beyond K4_MAIN and
# K4_MORE draw from their own generators, so that the draws of the other
# checks stay as they were.
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
    cost_volume_ref, same inputs and dtype, and a second call bit for bit
    the same; times at the train shapes (with the plan of each bf16
    launch); then K3_MORE from their own generator."""
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
            again = ck.cost_volume_bwd_cuda(g, f1, f2)
            a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            want = torch.autograd.grad(cost_volume_ref(a1, a2), (a1, a2), g)
            torch.cuda.synchronize()
            tol = TOL[("corr_bwd", dtype)]
            for i, phase in enumerate(("k2_check", "k3_check")):
                err, rel = rel_err(got[i], want[i])
                # No atomics: a second call gives the same bits.
                same = torch.equal(got[i], again[i])
                row = {"phase": phase, "shape": shape, "dtype": str(dtype),
                       "max_abs_err": err, "rel_err": rel, "tol": tol,
                       "repeat_identical": same}
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
                    row["plan"] = ck.bwd_band_plan(i + 1, *shape)
                    main[phase][shape] = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"{phase} disagrees at {shape} "
                                         f"{dtype}: {rel} > {tol}")
                if not same:
                    raise AssertionError(f"{phase} at {shape} {dtype}: two "
                                         "calls differ")
    more = torch.Generator(device=dev).manual_seed(MORE_SEED)
    for dtype in (torch.bfloat16, torch.float32):
        for shape, d in K3_MORE:
            f1 = torch.randn(shape, device=dev, generator=more).to(dtype)
            f2 = torch.randn(shape, device=dev, generator=more).to(dtype)
            g = torch.randn(shape[:3] + ((2 * d + 1) ** 2,), device=dev,
                            generator=more).to(dtype)
            got = ck.cost_volume_bwd_cuda(g, f1, f2, d)
            again = ck.cost_volume_bwd_cuda(g, f1, f2, d)
            a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            want = torch.autograd.grad(cost_volume_ref(a1, a2, d), (a1, a2),
                                       g)
            torch.cuda.synchronize()
            tol = TOL[("corr_bwd", dtype)]
            for i, phase in enumerate(("k2_check", "k3_check")):
                err, rel = rel_err(got[i], want[i])
                same = torch.equal(got[i], again[i])
                emit({"phase": phase, "shape": shape, "d": d,
                      "dtype": str(dtype), "max_abs_err": err,
                      "rel_err": rel, "tol": tol, "repeat_identical": same})
                if not rel <= tol:
                    raise AssertionError(f"{phase} disagrees at {shape}, "
                                         f"d={d} {dtype}: {rel} > {tol}")
                if not same:
                    raise AssertionError(f"{phase} at {shape}, d={d} "
                                         f"{dtype}: two calls differ")
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


def k5_plain_grads(im, ps, g):
    """Autograd of stem_ref: (d_im, dW1, db1, ..., dW4, db4)."""
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    a = im.clone().requires_grad_()
    p = [(w.detach().clone().requires_grad_(),
          b.detach().clone().requires_grad_()) for w, b in ps]
    flat = [t for pair in p for t in pair]
    return torch.autograd.grad(sk.stem_ref(a, p), [a, *flat], g)


def cast_params(ps, dtype):
    return [(w.to(dtype), b.to(dtype)) for w, b in ps]


def near_zero_f64(im, params):
    """Per layer, the float64 pre-activations within the bound on an f32
    sum of their terms, as (|z| / sum|terms|, flat index), the nearest to 0
    first."""
    from pwcnet_tpu_torch.ops.conv import conv_same, leaky_relu
    x, out = im.double().permute(0, 3, 1, 2), []
    for (w, b), stride in zip(cast_params(params, torch.float64),
                              (2, 1, 2, 1)):
        z = conv_same(x, w, b, stride=stride).flatten()
        mag = conv_same(x.abs(), w.abs(), b.abs(), stride=stride)
        ratio = z.abs() / mag.flatten()
        near = torch.nonzero(ratio <= (9 * w.shape[1] + 1) * F32_UNIT)
        out.append(sorted((ratio[i].item(), i.item())
                          for i in near.flatten()))
        x = leaky_relu(z.view_as(mag))
    return out


def grads_f64_swapped(im, params, g, layer, index):
    """Float64 gradients with the LeakyReLU's slope (1 or 0.1) swapped at
    flat pre-activation ``index`` of conv ``layer``."""
    from pwcnet_tpu_torch.ops.conv import conv_same
    a = im.double().requires_grad_()
    ps = [t.clone().requires_grad_() for pair in
          cast_params(params, torch.float64) for t in pair]
    x = a.permute(0, 3, 1, 2)
    for lay, stride in enumerate((2, 1, 2, 1)):
        z = conv_same(x, ps[2 * lay], ps[2 * lay + 1], stride=stride)
        slope = torch.where(z > 0, 1.0, 0.1).double().contiguous()
        if lay == layer:
            slope.view(-1)[index] = 1.1 - slope.view(-1)[index]
        x = z * slope
    return torch.autograd.grad(x.permute(0, 2, 3, 1), [a, *ps], g.double())


def k5_swapped_slope(got, im, params, g, first=0):
    """The float64 gradients with one slope swapped (of the STEM_FLIPS_TRIED
    nearest to 0 per layer) closest to the kernel's: (errs, layer, index,
    ratio), or None where no pre-activation is that near 0."""
    tried = []
    for layer, cands in enumerate(near_zero_f64(im, params)):
        for ratio, index in cands[:STEM_FLIPS_TRIED]:
            alt = grads_f64_swapped(im, params, g, layer, index)
            tried.append(([rel_err(a, b) for a, b in zip(got, alt[first:])],
                          layer, index, ratio))
    return min(tried, key=lambda t: max(e[1] for e in t[0])) \
        if tried else None


def k5_case(timer, dev, gen, params, dtype, shape, phase="k5_check",
            f64=False, floor_rule=False, time_it=False, profile=False,
            need_im=True) -> dict:
    """One k5_check row: the stem backward kernel against autograd through
    stem_ref. f32: directly; with ``f64``, both are also read against
    float64, and a kernel further than TOL from the plain version must
    match float64 with one LeakyReLU slope swapped where the
    pre-activation is within f32 rounding of 0 (see TOL); with
    ``floor_rule`` (large shapes, where many pre-activations lie that near
    0), each gradient within max(TOL, FLOOR_FACTOR x floor), floor the
    plain version's own change of that gradient when the image is scaled
    by 1 + 1e-6 N(0, 1) (three draws), the rule of the f32 train step.
    bf16: by its error against an f32 oracle beside the plain bf16
    autograd's error, its distance from stem_bwd_bf16_ref, and a second
    call that must be bit-identical. With
    ``time_it`` (bf16), the train step's form (no d_im) is timed. With
    ``need_im=False`` the kernel runs in that form and only dW, db are
    held."""
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    im = torch.rand(shape, device=dev, generator=gen).to(dtype)
    g = torch.randn((shape[0], shape[1] // 4, shape[2] // 4, 32),
                    device=dev, generator=gen).to(dtype)
    first = 0 if need_im else 1  # grads [first:] of (d_im, dW1, ..., db4)

    def kernel_grads():
        d_im, dp = sk.stem_bwd_cuda(im, params, g, need_im=need_im)
        return ([d_im] + [t for pair in dp for t in pair])[first:]

    got = kernel_grads()
    plain = k5_plain_grads(im, params, g)[first:]
    row = {"phase": phase, "shape": shape, "dtype": str(dtype),
           "grads": ("d_im, " if need_im else "") + "dW1, db1, ..., dW4, db4"}
    model_rel, model_tols = [], []
    if dtype == torch.float32:
        errs = decide = [rel_err(a, b) for a, b in zip(got, plain)]
        tols = [TOL[("stem_bwd", dtype)]] * len(errs)
        if f64:
            exact = k5_plain_grads(im.double(),
                                   cast_params(params, torch.float64),
                                   g.double())[first:]
            near = near_zero_f64(im, params)
            row.update(
                kernel_rel_err_vs_f64=[rel_err(a, b)[1]
                                       for a, b in zip(got, exact)],
                plain_rel_err_vs_f64=[rel_err(a, b)[1]
                                      for a, b in zip(plain, exact)],
                near_zero_f64=[len(n) for n in near])
        if floor_rule and max(e[1] for e in errs) > tols[0]:
            noise = torch.Generator(device=dev).manual_seed(5)
            floors = [0.0] * len(errs)
            for _ in range(3):
                moved = k5_plain_grads(im * (1 + 1e-6 * torch.randn(
                    im.shape, device=dev, generator=noise)), params,
                    g)[first:]
                floors = [max(f, rel_err(a, b)[1])
                          for f, a, b in zip(floors, moved, plain)]
            tols = [max(t, FLOOR_FACTOR * f) for t, f in zip(tols, floors)]
            row["floor_1e-6"] = floors
        if f64 and max(e[1] for e in errs) > tols[0]:
            # Which single swapped slope, if any, the kernel took.
            best = k5_swapped_slope(got, im, params, g, first)
            if best:
                decide, layer, index, ratio = best
                row["swapped_slope"] = {
                    "conv": layer + 1, "flat_index": index,
                    "z_over_sum_abs_terms": ratio,
                    "rel_err_vs_swapped_f64": [e[1] for e in decide]}
    else:
        oracle = k5_plain_grads(
            im.float(), [(w.to(dtype).float(), b.to(dtype).float())
                         for w, b in params], g.float())[first:]
        errs = decide = [rel_err(a, b) for a, b in zip(got, oracle)]
        plain_rel = [rel_err(a, b)[1] for a, b in zip(plain, oracle)]
        tols = [max(STEM_BWD_BF16[0] * e, STEM_BWD_BF16[1])
                for e in plain_rel]
        # The same inputs again: bit-identical (fixed-order sums).
        repeat = all(torch.equal(a, b) for a, b in zip(got,
                                                      kernel_grads()))
        # The kernel's own arithmetic in plain torch.
        m_im, mp = sk.stem_bwd_bf16_ref(im, params, g)
        model_rel = [rel_err(a, b)[1] for a, b in zip(
            got, ([m_im] + [t for pair in mp for t in pair])[first:])]
        model_tols = ([sk.BF16_MODEL_TOL[0]]
                      + [sk.BF16_MODEL_TOL[1]] * 8)[first:]
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
    if time_it and dtype == torch.bfloat16:
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
        if profile:
            # The CUDA kernels of one call (the wrapper's included).
            busy, n_launch, top = profile_kernels(
                lambda: sk.stem_bwd_cuda(im, params, g, need_im=False))
            row.update(profile_busy_ms=busy,
                       profile_kernels_per_call=n_launch, profile_top=top)
    emit(row)
    bad = [(r, t) for r, t in zip([e[1] for e in decide] + model_rel,
                                  tols + model_tols) if not r <= t]
    if bad:
        raise AssertionError(f"K5 disagrees at {shape} {dtype}: {bad}")
    if row.get("bit_identical_repeat") is False:
        raise AssertionError(f"K5 at {shape} {dtype}: two calls on the "
                             "same inputs differ")
    return row


def check_stem_bwd(timer, dev, gen) -> dict:
    """k5_check (``k5_case``) at the train shape (timed, f32 without the
    float64 report), the ragged shapes and STEM_LOOPED."""
    params = stem_params(dev, seed=2)
    main = None
    cases = ([(dt, sh) for dt in (torch.bfloat16, torch.float32)
              for sh in [STEM_TRAIN] + STEM_RAGGED]
             + [(dt, sh) for dt in (torch.bfloat16, torch.float32)
                for sh in STEM_LOOPED])
    for dtype, shape in cases:
        train_shape = shape == STEM_TRAIN
        row = k5_case(timer, dev, gen, params, dtype, shape,
                      f64=not train_shape, time_it=train_shape,
                      profile=train_shape)
        if train_shape and dtype == torch.bfloat16:
            main = row
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


def one_step_grads(model, train_cfg, batch, loss_kind="multiscale",
                   im_noise=0.0, seed=0):
    """One train step of ``model`` from a fresh state on a copy of ``batch``
    (CPU tensors, moved to the model's device): its metrics, and every
    parameter's gradient on the CPU. With ``im_noise``, frame 1 is first
    scaled by 1 + im_noise * N(0, 1) (CPU draw ``seed``)."""
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    opt, sched = optimizer_from_config(model.parameters(), train_cfg)
    step_fn = make_train_step(model, opt, sched, loss_kind=loss_kind)
    batch = {k: v.clone() for k, v in batch.items()}
    if im_noise:
        gen = torch.Generator().manual_seed(seed)
        batch["im1"] *= 1 + im_noise * torch.randn(batch["im1"].shape,
                                                   generator=gen)
    _, m = step_fn(TrainState.create(model, opt, sched, seed=1),
                   {k: v.to(model.device) for k, v in batch.items()})
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def grad_rel(a, b) -> dict:
    """Per parameter, max|a - b| / max|b|."""
    return {n: rel_err(a[n], b[n])[1] for n in b}


def train_phases(out_dir: str, dev, smi: str, timer) -> dict:
    """train_steps, overfit, train_f32_card_vs_cpu, train_times; returns
    the launches per train step and the f32 step's gradient tolerance (its
    measured CPU floor rule)."""
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
        return one_step_grads(model, cfg32.train, small, im_noise=im_noise,
                              seed=seed)

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
    return per_step, tol


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
    (normal4 flows, with the plan of the bf16 launch); K6_MORE (d < 4) from
    their own generator; then WarpCorrFunction's gradients against
    autograd through the plain version."""
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
                        plan=wk.band_plan(*shape[:3]),
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
        more = torch.Generator(device=dev).manual_seed(MORE_SEED)
        for dtype in (torch.bfloat16, torch.float32):
            for shape, d in K6_MORE:
                f1 = torch.randn(shape, device=dev, generator=more).to(dtype)
                f2 = torch.randn(shape, device=dev, generator=more).to(dtype)
                errs = {}
                for kind in K6_FLOWS:
                    flow = k6_flow(shape, kind, dev, more)
                    got = wk.warp_corr_cuda(f1, f2, flow, d)
                    errs[kind] = rel_err(got, warp_corr_ref(f1, f2, flow, d))
                torch.cuda.synchronize()
                tol = TOL[("corr", dtype)]
                emit({"phase": "k6_check", "shape": shape, "d": d,
                      "plan": wk.band_plan(*shape[:3], d),
                      "dtype": str(dtype),
                      "max_abs_err": max(e[0] for e in errs.values()),
                      "rel_err": {k: e[1] for k, e in errs.items()},
                      "tol": tol})
                bad = {k: e[1] for k, e in errs.items() if not e[1] <= tol}
                if bad:
                    raise AssertionError(f"K6 disagrees at {shape}, d={d} "
                                         f"{dtype}: {bad} > {tol}")
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
                        plan=wk.band_plan(*shape[:3]),
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


# -- The file datasets -------------------------------------------------------
# Trees in each dataset's layout at its real frame size, written from a
# seed (generated content, not the datasets): (pairs, frame size); Sintel
# (scenes, frames per scene, frame size), both passes.
CHAIRS_TREE = (40, (384, 512))
THINGS_TREE = (8, (540, 960))
SINTEL_TREE = (2, 4, (436, 1024))
KITTI_TREE = (20, (375, 1242))
FILE_TRAIN_STEPS = 20  # file_train, with a stop at half and a resume
FILE_SHAPE_STEPS = 5   # file_train_shapes, per preset
AUG_TOL = 2e-6         # apply_augment, card vs CPU (max abs)
# The file presets' periodic eval: batch 4 (data.eval_batch) of Sintel's
# 436x1024 and KITTI's 375x1242 frames, padded to multiples of 64.
EVAL_BATCH = 4
EVAL_HW = [(448, 1024), (384, 1280)]
# The port's kernel symbols that the profile_dir trace must name: the bf16
# K1 band, the K2/K3 band, the conv tile of K4/K5, K5's weight gradient.
TRACE_KERNELS = ("corr_band", "corr_bwd_band", "conv3x3", "wgrad")


def level_shapes(n: int, hw) -> list:
    """The correlation's (N, H, W, C) at levels 6..2 of a batch of n pairs
    of size hw."""
    return [(n, hw[0] >> lv, hw[1] >> lv, c)
            for lv, c in ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))]


def file_config(preset: str, root: str, name: str, preset_crop=False,
                **train_kw):
    """``preset`` on the tree at ``root``, logging under RUN_DIR/name. With
    ``preset_crop`` the augmentation crops the preset's ``data.crop_hw``:
    the JAX package's trainer reads ``data.augment.crop_hw`` only, which
    every preset leaves at (384, 448), so the crops that things-ft
    (384x768) and kitti-multihost (320x896) name take effect only so."""
    import dataclasses
    from pwcnet_tpu_torch.config import PRESETS
    cfg = PRESETS[preset]
    data = dataclasses.replace(cfg.data, root=root)
    if preset_crop:
        data = dataclasses.replace(data, augment=dataclasses.replace(
            data.augment, crop_hw=data.crop_hw))
    return dataclasses.replace(cfg, data=data, train=dataclasses.replace(
        cfg.train, log_dir=os.path.join(RUN_DIR, name), **train_kw))


def file_trees(root: str) -> dict:
    """file_trees: write the four trees under ``root``."""
    from pwcnet_tpu_torch.data import trees
    t0 = time.perf_counter()
    roots = {
        "chairs": trees.write_chairs(os.path.join(root, "chairs"),
                                     *CHAIRS_TREE, seed=1),
        "things": trees.write_things(os.path.join(root, "things"),
                                     *THINGS_TREE, seed=2),
        "sintel": trees.write_sintel(os.path.join(root, "sintel"),
                                     *SINTEL_TREE, seed=3),
        "kitti": trees.write_kitti(os.path.join(root, "kitti"),
                                   *KITTI_TREE, seed=4),
    }
    sizes = {k: sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(v) for f in fs) / 1e6
             for k, v in roots.items()}
    emit({"phase": "file_trees", "generated_not_real_data": True,
          "chairs": CHAIRS_TREE, "things_subset": THINGS_TREE,
          "sintel_clean_final": SINTEL_TREE, "kitti": KITTI_TREE,
          "mb": sizes, "seconds": time.perf_counter() - t0})
    return roots


def _metrics(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _finite_steps(recs) -> bool:
    rows = [r for r in recs if "loss" in r]
    return bool(rows) and all(np.isfinite(
        [r["loss"], r["train_epe"], r["grad_norm"]]).all() for r in rows)


def file_train(roots: dict, out_dir: str, dev, smi: str, timer) -> dict:
    """file_train: train(chairs-1chip) on the chairs tree for
    FILE_TRAIN_STEPS steps with the periodic eval, launches per step,
    then the same steps stopped at half and resumed (the Loader's indices
    and the augmented batches of the resumed half must equal the
    uninterrupted run's bit for bit); then the host feed and the step
    timed: each decode path alone, the pinned copy, the augmentation, the
    step's wall and its profile."""
    import hashlib
    import shutil
    from unittest import mock

    import pwcnet_tpu_torch.train.loop as loop_mod
    import pwcnet_tpu_torch.train.step as step_mod
    from pwcnet_tpu_torch.data.augment import (apply_augment,
                                               draw_augment_params)
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.data.pipeline import Loader
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.train.loop import build_model, to_device, train
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    t0 = time.perf_counter()
    kw = dict(summary_interval=1, eval_interval=FILE_TRAIN_STEPS // 2,
              eval_limit=8)
    rec = {"indices": {}, "aug": [], "eval_launches": {}}
    real_indices, real_aug = Loader.indices_for_step, step_mod.augment_batch
    real_eval = loop_mod._evaluate

    def indices(self, step):
        out = real_indices(self, step)
        rec["indices"][step] = out.copy()
        return out

    def augment(*args, **kwargs):
        out = real_aug(*args, **kwargs)
        digest = hashlib.sha1()
        for k in sorted(out):
            digest.update(out[k].detach().cpu().numpy().tobytes())
        rec["aug"].append(digest.hexdigest())
        return out

    def evaluate(*args, **kwargs):
        before = {**ck.LAUNCHES, **sk.LAUNCHES}
        real_eval(*args, **kwargs)
        for k, v in {**ck.LAUNCHES, **sk.LAUNCHES}.items():
            rec["eval_launches"][k] = (rec["eval_launches"].get(k, 0)
                                       + v - before[k])

    def run(name, steps):
        for key in ("indices", "aug", "eval_launches"):
            rec[key] = type(rec[key])()
        with mock.patch.object(Loader, "indices_for_step", indices), \
                mock.patch.object(step_mod, "augment_batch", augment), \
                mock.patch.object(loop_mod, "_evaluate", evaluate):
            final = train(file_config("chairs-1chip", roots["chairs"], name,
                                      **kw), max_steps=steps)
        return final, dict(rec["indices"]), list(rec["aug"]), dict(
            rec["eval_launches"])

    for name in ("file_train", "file_resume"):
        shutil.rmtree(os.path.join(RUN_DIR, name), ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches(ck, sk)
    final, idx_whole, aug_whole, eval_launches = run("file_train",
                                                     FILE_TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {**ck.LAUNCHES, **sk.LAUNCHES}
    per_step = {k: (v - eval_launches.get(k, 0)) / FILE_TRAIN_STEPS
                for k, v in launches.items() if v - eval_launches.get(k, 0)}
    recs = _metrics(os.path.join(RUN_DIR, "file_train"))
    half = FILE_TRAIN_STEPS // 2
    run("file_resume", half)
    resumed, idx_rest, aug_rest, _ = run("file_resume", half)
    same_indices = all(np.array_equal(idx_rest[s], idx_whole[s])
                       for s in range(half, FILE_TRAIN_STEPS))
    same_aug = aug_rest == aug_whole[half:]
    shutil.copy(os.path.join(RUN_DIR, "file_train", "metrics.jsonl"),
                os.path.join(out_dir, "file_train_metrics.jsonl"))
    train_s = time.perf_counter() - t0

    # The host feed, each part alone, and the step with its data.
    cfg = file_config("chairs-1chip", roots["chairs"], "file_times")
    ds = get_dataset("flyingchairs", roots["chairs"], split="train")
    loader = Loader(ds, cfg.train.global_batch, cfg.data.sample_hw,
                    num_threads=cfg.data.num_threads, prefetch=1)
    try:
        host = next(loader)
        while not loader._q.full():  # the producer now waits: time alone
            time.sleep(0.01)
        idxs = loader.indices_for_step(0)

        def host_ms(fn, reps):
            ts = []
            for _ in range(reps):
                t = time.perf_counter()
                out = fn()
                ts.append((time.perf_counter() - t) * 1e3)
            return statistics.median(ts), out

        native_ms, nat = host_ms(lambda: loader.native_batch(idxs), 5)
        python_ms, py = host_ms(lambda: loader.python_batch(idxs), 3)
        paths_diff = max(float(np.abs(nat[k] - py[k]).max()) for k in nat)
        pin_ms, pinned = host_ms(lambda: {
            k: torch.from_numpy(v).pin_memory() for k, v in host.items()}, 5)
        copy_ms = timer(lambda: {k: v.to(dev, non_blocking=True)
                                 for k, v in pinned.items()}, reps=10,
                        inner=2)
        batch_mb = sum(v.nbytes for v in host.values()) / 1e6
        batch = to_device(host, dev)
        aug = cfg.data.augment
        params, _ = draw_augment_params(torch.Generator().manual_seed(0),
                                        cfg.train.global_batch,
                                        cfg.data.sample_hw, aug)
        noise_gen = torch.Generator(device=dev).manual_seed(0)
        augment_ms = timer(lambda: apply_augment(batch, params, aug,
                                                 noise_gen), reps=10)
        model = build_model(cfg)
        opt, sched = optimizer_from_config(model.parameters(), cfg.train)
        state = TrainState.create(model, opt, sched, seed=1)
        step_fn = make_train_step(model, opt, sched, aug=aug)

        def one_iter():
            step_fn(state, to_device(next(loader), dev))

        step_wall = wall_ms(one_iter, reps=10)
        busy, n_launch, top = profile_kernels(one_iter, n=5)
        decoded = dict(loader.decoded)
    finally:
        loader.close()
    row = {"phase": "file_train", "config": "chairs-1chip, bf16, batch "
           f"{cfg.train.global_batch}, samples {cfg.data.sample_hw}, crop "
           f"{cfg.data.augment.crop_hw}, native decoder",
           "steps": [{k: r[k] for k in ("step", "loss", "train_epe",
                                        "grad_norm")}
                     for r in recs if "loss" in r],
           "val": [{k: r[k] for k in ("step", "val_epe", "val_fl_all")}
                   for r in recs if "val_epe" in r],
           "final": final, "finite": _finite_steps(recs),
           "launches_per_step": per_step,
           "eval_launches_total": eval_launches,
           "resumed_to_step": resumed["step"],
           "resume_same_indices": same_indices,
           "resume_same_augmented_batches": same_aug,
           "train_and_resume_s": train_s,
           "loader_native_ms_per_batch": native_ms,
           "loader_python_ms_per_batch": python_ms,
           "native_vs_python_max_abs": paths_diff,
           "batch_mb": batch_mb, "pin_ms_host": pin_ms,
           "copy_ms_device": copy_ms, "augment_ms_device": augment_ms,
           "step_ms_wall_median": step_wall,
           "pairs_per_s": cfg.train.global_batch * 1e3 / step_wall,
           "profile_busy_ms_per_step": busy,
           "idle_share_of_wall": 1 - busy / step_wall,
           "kernel_launches_per_step": n_launch, "profile_top": top,
           "loader_decoded": decoded, "nvidia_smi": smi,
           "seconds": time.perf_counter() - t0}
    emit(row)
    bad = []
    if not row["finite"] or len(row["steps"]) != FILE_TRAIN_STEPS:
        bad.append("metrics not finite or missing")
    if per_step != TRAIN_LAUNCHES:
        bad.append(f"launches per step {per_step} != {TRAIN_LAUNCHES}")
    if [v["step"] for v in row["val"]] != [half, FILE_TRAIN_STEPS]:
        bad.append(f"periodic eval at {row['val']}")
    if not (resumed["step"] == FILE_TRAIN_STEPS and same_indices
            and same_aug and len(aug_rest) == half):
        bad.append("the resumed run's indices or augmented batches differ")
    if paths_diff > 1e-7 or decoded["native"] == 0 or decoded["python"]:
        bad.append(f"decode paths: {decoded}, differ by {paths_diff}")
    if bad:
        raise AssertionError(f"file_train: {bad}")
    return row


def k1_row(timer, dev, gen, shape, dtype) -> dict:
    """K1 against cost_volume_ref at ``shape``; bf16 timed with its plan
    and bound. Raises beyond TOL."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    with torch.inference_mode():
        f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
        f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
        err, rel = rel_err(ck.cost_volume_cuda(f1, f2),
                           cost_volume_ref(f1, f2))
        row = {"kernel": "K1", "shape": shape, "dtype": str(dtype),
               "max_abs_err": err, "rel_err": rel,
               "tol": TOL[("corr", dtype)]}
        if dtype == torch.bfloat16:
            b, tb, to = bound_ms(*corr_cost(shape, dtype), dtype)
            row.update(plan=ck.band_plan(*shape[:3]),
                       ms=timer(lambda: ck.cost_volume_cuda(f1, f2)),
                       plain_ms=timer(lambda: cost_volume_ref(f1, f2),
                                      inner=2),
                       bound_ms=b, bytes_ms=tb, ops_ms=to)
    if not rel <= row["tol"]:
        raise AssertionError(f"K1 disagrees: {row}")
    return row


def k4_row(timer, dev, gen, params, shape, dtype) -> dict:
    """K4 against stem_ref at ``shape``; bf16 timed with its bound. Raises
    beyond TOL."""
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    with torch.inference_mode():
        im = torch.rand(shape, device=dev, generator=gen).to(dtype)
        err, rel = rel_err(sk.stem_cuda(im, params), sk.stem_ref(im, params))
        row = {"kernel": "K4", "shape": shape, "dtype": str(dtype),
               "max_abs_err": err, "rel_err": rel,
               "tol": TOL[("stem", dtype)]}
        if dtype == torch.bfloat16:
            b, tb, to = bound_ms(*stem_cost(shape, dtype), dtype)
            row.update(ms=timer(lambda: sk.stem_cuda(im, params)),
                       plain_ms=timer(lambda: sk.stem_ref(im, params)),
                       bound_ms=b, bytes_ms=tb, ops_ms=to)
    if not rel <= row["tol"]:
        raise AssertionError(f"K4 disagrees: {row}")
    return row


def k23_row(timer, dev, gen, shape, dtype) -> dict:
    """K2 and K3 against autograd through cost_volume_ref at ``shape``;
    bf16 timed (each alone) with their plans and bound. Raises beyond
    TOL."""
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
    f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
    g = torch.randn(shape[:3] + (81,), device=dev, generator=gen).to(dtype)
    got = ck.cost_volume_bwd_cuda(g, f1, f2)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    want = torch.autograd.grad(cost_volume_ref(a1, a2), (a1, a2), g)
    errs = [rel_err(got[i], want[i]) for i in (0, 1)]
    row = {"kernel": "K2, K3", "shape": shape, "dtype": str(dtype),
           "max_abs_err": [e[0] for e in errs],
           "rel_err": [e[1] for e in errs], "tol": TOL[("corr_bwd", dtype)]}
    if dtype == torch.bfloat16:
        b, tb, to = bound_ms(*corr_bwd_cost(shape, dtype), dtype)
        row.update(plan=[ck.bwd_band_plan(i, *shape) for i in (1, 2)],
                   ms=[timer(lambda: ck.cost_volume_bwd_cuda(
                       g, f1, f2, need_f1=i == 1, need_f2=i == 2))
                       for i in (1, 2)],
                   bound_ms_each=b, bytes_ms=tb, ops_ms=to)
    if not max(row["rel_err"]) <= row["tol"]:
        raise AssertionError(f"K2/K3 disagree: {row}")
    return row


def file_train_shapes(roots: dict, dev, smi: str, timer, gen) -> dict:
    """file_train_shapes: FILE_SHAPE_STEPS steps each of things-ft (PNG +
    PFM) and kitti-multihost (robust loss, sparse valid) at the crops they
    name, then K1, K2, K3 at their five levels and K4, K5 on both frames,
    in bf16 and f32, against the plain versions at TOL; bf16 timed with
    its plan and bound. Then (file_eval_shapes) K1 and K4 at the eval
    forward's shapes of Sintel and KITTI."""
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.train.loop import train
    t0 = time.perf_counter()
    out = {}
    for preset, tree in (("things-ft", "things"),
                         ("kitti-multihost", "kitti")):
        cfg = file_config(preset, roots[tree], preset, preset_crop=True,
                          summary_interval=1)
        torch.cuda.synchronize()
        reset_launches(ck, sk)
        t1 = time.perf_counter()
        final = train(cfg, max_steps=FILE_SHAPE_STEPS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t1
        per_step = {k: v / FILE_SHAPE_STEPS
                    for k, v in {**ck.LAUNCHES, **sk.LAUNCHES}.items() if v}
        recs = _metrics(cfg.train.log_dir)
        n, crop = cfg.train.global_batch, cfg.data.augment.crop_hw
        row = {"phase": "file_train_shapes", "preset": preset,
               "batch": [n, *crop], "loss": cfg.train.loss,
               "final": final, "finite": _finite_steps(recs),
               "launches_per_step": per_step, "wall_s": wall_s}
        if not row["finite"] or per_step != TRAIN_LAUNCHES:
            emit(row)
            raise AssertionError(f"{preset}: finite={row['finite']}, "
                                 f"launches per step {per_step}")
        dtypes = (torch.bfloat16, torch.float32)
        row["corr"] = [k1_row(timer, dev, gen, shape, dt)
                       for dt in dtypes for shape in level_shapes(n, crop)]
        row["corr_bwd"] = [k23_row(timer, dev, gen, shape, dt) for dt in
                           dtypes for shape in level_shapes(n, crop)]
        params = stem_params(dev, seed=7)
        shape = (2 * n, *crop, 3)
        row["stem"] = [k4_row(timer, dev, gen, params, shape, dt)
                       for dt in dtypes]
        # K5 in the train step's form: images need no gradient.
        row["stem_bwd"] = [{k: v for k, v in k5_case(
            timer, dev, gen, params, dt, shape, phase="file_train_shapes_k5",
            floor_rule=True, time_it=True, need_im=False).items() if k in (
                "shape", "dtype", "rel_err", "tol", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "floor_1e-6")} for dt in dtypes]
        row["seconds"] = time.perf_counter() - t1
        emit(row)
        out[preset] = row
    # The periodic eval's forward at the file presets' eval batch (4):
    # Sintel's 436x1024 and KITTI's 375x1242 padded to /64.
    params = stem_params(dev, seed=8)
    evals = [r for hw in EVAL_HW for dt in (torch.bfloat16, torch.float32)
             for r in [k1_row(timer, dev, gen, shape, dt)
                       for shape in level_shapes(EVAL_BATCH, hw)]
             + [k4_row(timer, dev, gen, params, (2 * EVAL_BATCH, *hw, 3),
                       dt)]]
    emit({"phase": "file_eval_shapes", "rows": evals})
    emit({"phase": "file_train_shapes_done",
          "seconds": time.perf_counter() - t0})
    return out


def augment_card_vs_cpu(dev) -> None:
    """augment_card_vs_cpu: apply_augment on the card against the CPU on
    the same batch (chairs-1chip's 8 x 384x512), params and noise."""
    from pwcnet_tpu_torch.config import PRESETS
    from pwcnet_tpu_torch.data.augment import (apply_augment,
                                               draw_augment_params)
    t0 = time.perf_counter()
    cfg = PRESETS["chairs-1chip"]
    n, hw, aug = cfg.train.global_batch, cfg.data.sample_hw, \
        cfg.data.augment
    gen = torch.Generator().manual_seed(8)
    batch = {"im1": torch.rand((n, *hw, 3), generator=gen),
             "im2": torch.rand((n, *hw, 3), generator=gen),
             "flow": 10 * torch.randn((n, *hw, 2), generator=gen),
             "valid": (torch.rand((n, *hw), generator=gen) > 0.3).float()}
    params, _ = draw_augment_params(gen, n, hw, aug)
    noise = torch.randn((2, n, *aug.crop_hw, 3), generator=gen)
    cpu = apply_augment(batch, params, aug, noise)
    card = apply_augment({k: v.to(dev) for k, v in batch.items()}, params,
                         aug, noise.to(dev))
    errs = {k: (card[k].cpu() - cpu[k]).abs().max().item() for k in cpu}
    emit({"phase": "augment_card_vs_cpu", "batch": [n, *hw],
          "crop": aug.crop_hw, "max_abs_err": errs, "tol": AUG_TOL,
          "hflips": int(params[:, 2].sum()), "vflips": int(params[:, 3].sum()),
          "asymmetric": int(params[:, 4].sum()),
          "seconds": time.perf_counter() - t0})
    if not max(errs.values()) <= AUG_TOL:
        raise AssertionError(f"apply_augment: card and CPU differ: {errs}")


def debug_nans_phase(roots: dict, dev) -> None:
    """debug_nans: one bf16 chairs step on a batch with one NaN pixel (the
    centre of a sample, which every crop keeps):
    under nan_checks it raises FloatingPointError; without, it gives a NaN
    loss and raises nothing."""
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.data.pipeline import Loader
    from pwcnet_tpu_torch.train.loop import build_model, nan_checks, to_device
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    t0 = time.perf_counter()
    cfg = file_config("chairs-1chip", roots["chairs"], "debug_nans")
    loader = Loader(get_dataset("flyingchairs", roots["chairs"]),
                    cfg.train.global_batch, cfg.data.sample_hw)
    try:
        host = next(loader)
    finally:
        loader.close()
    h, w = cfg.data.sample_hw
    host["im1"][0, h // 2, w // 2, 1] = np.nan  # inside every crop

    def step(checked: bool):
        model = build_model(cfg)
        opt, sched = optimizer_from_config(model.parameters(), cfg.train)
        step_fn = make_train_step(model, opt, sched, aug=cfg.data.augment)
        state = TrainState.create(model, opt, sched, seed=1)
        if not checked:
            return float(step_fn(state, to_device(host, dev))[1]["loss"])
        try:
            with nan_checks(model):
                step_fn(state, to_device(host, dev))
        except FloatingPointError as e:
            return str(e)
        return None

    raised = step(True)
    loss = step(False)
    emit({"phase": "debug_nans", "raised": raised, "loss_without": loss,
          "anomaly_mode_after": torch.is_anomaly_enabled(),
          "seconds": time.perf_counter() - t0})
    if raised is None or np.isfinite(loss) or torch.is_anomaly_enabled():
        raise AssertionError("debug_nans: no FloatingPointError with the "
                             "checks, or a finite loss without them")


def profile_dir_phase(roots: dict) -> None:
    """profile_dir: train(chairs-1chip, profile_dir) for 3 steps; the trace
    exists and names the port's kernels."""
    import glob
    import shutil
    from pwcnet_tpu_torch.train.loop import train
    t0 = time.perf_counter()
    prof = os.path.join(RUN_DIR, "profile")
    shutil.rmtree(prof, ignore_errors=True)
    train(file_config("chairs-1chip", roots["chairs"], "profile_run",
                      profile_dir=prof), max_steps=3)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    text = open(traces[0]).read() if len(traces) == 1 else ""
    named = {k: text.count(k) for k in TRACE_KERNELS}
    emit({"phase": "profile_dir", "traces": [os.path.basename(t)
                                             for t in traces],
          "trace_mb": len(text) / 1e6, "kernel_mentions": named,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(prof)
    if len(traces) != 1 or not all(named.values()):
        raise AssertionError(f"profile_dir: traces {traces}, kernel names "
                             f"{named}")


ROOT = os.path.dirname(os.path.abspath(__file__))


def run_cli(*args, env=None, whole=False):
    """``python -m pwcnet_tpu_torch.cli *args`` in a subprocess on the card,
    from the repo root: (its last output line as JSON, or with ``whole``
    its whole output, seconds). ``env``: the environment (default: this
    process's)."""
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    env.pop("PWCNET_PLATFORM", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pwcnet_tpu_torch.cli",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):"
                             f"\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    out = "\n".join(lines[lines.index("{"):]) if whole else lines[-1]
    return json.loads(out), time.perf_counter() - t0


def cli_phase(out_dir: str, roots: dict) -> None:
    """cli: the command line in subprocesses, on the card: predict on the
    repo's parity pair (.flo and --vis PNG), eval of the fused config on 16
    synthetic val samples, a train whose 10 steps cross eval_interval
    twice (val metrics and flow images written), a 10-step train of
    chairs-quick on the chairs tree and an eval of sintel-eval on the
    Sintel tree's val scene (436x1024, padded to 448x1024)."""
    import shutil
    from pwcnet_tpu_torch.io import read_flo, read_png
    root = ROOT
    run = run_cli

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

    log_dir = os.path.join(RUN_DIR, "cli_chairs")
    shutil.rmtree(log_dir, ignore_errors=True)
    chairs, chairs_s = run("train", "--preset", "chairs-quick",
                           "--max-steps", "10", f"data.root={roots['chairs']}",
                           f"train.log_dir={log_dir}")
    shutil.rmtree(log_dir)
    chairs_ok = chairs["step"] == 10 and bool(np.isfinite(
        [chairs["loss"], chairs["train_epe"], chairs["grad_norm"]]).all())
    sintel, sintel_s = run("eval", "--preset", "sintel-eval",
                           f"data.root={roots['sintel']}")
    sintel_ok = (sintel["num_samples"] == SINTEL_TREE[1] - 1
                 and bool(np.isfinite(sintel["epe"])))
    emit({"phase": "cli", "predict": pred, "predict_ok": pred_ok,
          "predict_s": pred_s, "eval": ev, "eval_ok": ev_ok, "eval_s": ev_s,
          "train_final": final, "train_val_steps": val_steps,
          "train_images": images, "train_ok": train_ok, "train_s": train_s,
          "train_chairs_quick": chairs, "train_chairs_quick_ok": chairs_ok,
          "train_chairs_quick_s": chairs_s, "eval_sintel": sintel,
          "eval_sintel_ok": sintel_ok, "eval_sintel_s": sintel_s})
    if not (pred_ok and ev_ok and train_ok and chairs_ok and sintel_ok):
        raise AssertionError("the command line's predict, eval or train "
                             "gave a wrong result")


# RAFT at full width (128-channel features, hidden 96, context 64, radius 4,
# 12 iterations). K1-K3 at its correlation shapes: the 1/8 and 1/16
# features of a 448x1024 pair (inference) and of raft-chairs' 8 x 384x448
# (training), and the 1/16 features of a 368x496 input (ragged).
RAFT_INFER = [(1, 56, 128, 128), (1, 28, 64, 128)]
RAFT_TRAIN = [(8, 48, 56, 128), (8, 24, 28, 128)]
RAFT_RAGGED = [(1, 23, 31, 128)]
RAFT_SEED = 10  # the raft_kernels draws' own generator
RAFT_NPZ = os.path.join(ROOT, "runs", "raft-synthetic",
                        "params_step20000_bf16.npz")
RAFT_ITERS = 12
RAFT_FWD_LAUNCHES = {"corr_fwd": 2 * RAFT_ITERS}
RAFT_TRAIN_LAUNCHES = {"corr_fwd": 2 * RAFT_ITERS,
                       "corr_bwd_f1": 2 * RAFT_ITERS,
                       "corr_bwd_f2": 2 * RAFT_ITERS}
RAFT_TRAIN_STEPS = 6
# The trained checkpoint's val EPE on synthetic-proof's val split (128
# samples, 384x448): its TPU run read 0.0897; a convention fault (u/v, the
# warp's direction, the upsampling) shows as pixels.
RAFT_EPE_MAX = 0.15
INSCAN_TOL = 2e-4  # sequence vs sequence_inscan: loss, grad_norm (JAX's)
RAFT_OVERFIT_STEPS = 60
RAFT_OVERFIT_RATIO = 0.35  # JAX tests/test_raft.py::test_overfit


@contextlib.contextmanager
def no_plain_correlation():
    """While open, the plain correlation raises: a run inside it goes
    through the correlation kernels only."""
    import importlib
    from unittest import mock
    import pwcnet_tpu_torch.models.raft as raft_mod
    # The module: the package ``ops`` exports a function of the same name.
    cv = importlib.import_module("pwcnet_tpu_torch.ops.cost_volume")

    def refuse(*args, **kwargs):
        raise AssertionError("the plain correlation ran on the card's path")

    with mock.patch.object(cv, "cost_volume_ref", refuse), \
            mock.patch.object(raft_mod, "cost_volume_ref", refuse):
        yield


def raft_kernels(timer, dev) -> dict:
    """raft_kernels: K1, K2 and K3 at RAFT's correlation shapes (C = 128,
    d = 4), bf16 and f32, each against its plain version (K2, K3: autograd
    of cost_volume_ref); at the bf16 inference and train shapes the plan,
    time, bound and plain time of each; at the train shapes K2 + K3 in one
    call against cost_volume_bwd_ref, the plain autograd backward (what the
    JAX model's bwd="lax" pin would be here)."""
    from pwcnet_tpu_torch.ops.cost_volume import (cost_volume_bwd_ref,
                                                  cost_volume_ref)
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    gen = torch.Generator(device=dev).manual_seed(RAFT_SEED)
    rows = {"corr_fwd": {}, "corr_bwd_f1": {}, "corr_bwd_f2": {}}
    vs_plain = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in RAFT_INFER + RAFT_TRAIN + RAFT_RAGGED:
            f1 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            f2 = torch.randn(shape, device=dev, generator=gen).to(dtype)
            g = torch.randn(shape[:3] + (81,), device=dev,
                            generator=gen).to(dtype)
            with torch.inference_mode():
                got = {"corr_fwd": ck.cost_volume_cuda(f1, f2)}
                want = {"corr_fwd": cost_volume_ref(f1, f2)}
            got["corr_bwd_f1"], got["corr_bwd_f2"] = ck.cost_volume_bwd_cuda(
                g, f1, f2)
            a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
            out = cost_volume_ref(a1, a2)
            want["corr_bwd_f1"], want["corr_bwd_f2"] = torch.autograd.grad(
                out, (a1, a2), g, retain_graph=True)
            torch.cuda.synchronize()
            timed = dtype == torch.bfloat16 and shape not in RAFT_RAGGED
            for name in rows:
                err, rel = rel_err(got[name], want[name])
                tol = TOL[("corr" if name == "corr_fwd" else "corr_bwd",
                           dtype)]
                row = {"phase": "raft_kernels", "kernel": name,
                       "shape": shape, "dtype": str(dtype),
                       "max_abs_err": err, "rel_err": rel, "tol": tol}
                if timed:
                    if name == "corr_fwd":
                        nbytes, flops = corr_cost(shape, dtype)
                        plan = ck.band_plan(*shape[:3])
                        with torch.inference_mode():
                            ms = timer(lambda: ck.cost_volume_cuda(f1, f2))
                            plain = timer(lambda: cost_volume_ref(f1, f2),
                                          inner=2)
                    else:
                        i = int(name == "corr_bwd_f2")
                        nbytes, flops = corr_bwd_cost(shape, dtype)
                        plan = ck.bwd_band_plan(i + 1, *shape)
                        ms = timer(lambda: ck.cost_volume_bwd_cuda(
                            g, f1, f2, need_f1=i == 0, need_f2=i == 1))
                        plain = timer(lambda: torch.autograd.grad(
                            out, (a1, a2)[i], g, retain_graph=True), inner=2)
                    b, tb, to = bound_ms(nbytes, flops, dtype)
                    row.update(plan=plan, ms=ms, plain_ms=plain, bound_ms=b,
                               bytes_ms=tb, ops_ms=to)
                    rows[name][shape] = row
                emit(row)
                if not rel <= tol:
                    raise AssertionError(f"{name} disagrees at RAFT's {shape} "
                                         f"{dtype}: {rel} > {tol}")
            if timed and shape in RAFT_TRAIN:
                k23 = timer(lambda: ck.cost_volume_bwd_cuda(g, f1, f2))
                plain = timer(lambda: cost_volume_bwd_ref(g, f1, f2),
                              inner=2)
                vs_plain.append({"shape": shape, "k2_k3_ms": k23,
                                 "plain_backward_ms": plain,
                                 "plain_over_kernels": plain / k23})
            del out
    emit({"phase": "raft_bwd_vs_plain", "dtype": "bfloat16",
          "rows": vs_plain,
          "sum_k2_k3_ms": sum(r["k2_k3_ms"] for r in vs_plain),
          "sum_plain_backward_ms": sum(r["plain_backward_ms"]
                                       for r in vs_plain)})
    return rows


def raft_model(dtype, device):
    """The port's RAFT at full width with the repo's trained weights."""
    from pwcnet_tpu_torch.compat import load_flax_params, read_flax_npz
    from pwcnet_tpu_torch.models import RAFT
    model = RAFT(dtype=dtype, device=device)
    load_flax_params(model, read_flax_npz(RAFT_NPZ))
    return model.eval()


def raft_forward(dev, timer, smi) -> dict:
    """raft_forward: the trained checkpoint (bf16) at 448x1024 with the
    launches of one forward (24 K1, no plain correlation), its times at
    batch 1 and 4 (wall, CUDA-event device time, profiler busy time, idle
    share) and predict_flow's; the f32 card forward against the CPU's per
    iteration on a smooth synthetic pair; evaluate_dataset on
    synthetic-proof's val split."""
    from pwcnet_tpu_torch import predict_flow
    from pwcnet_tpu_torch.config import PRESETS
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    model = raft_model(torch.bfloat16, dev)
    s = SyntheticFlow(split="val", hw=(448, 1024))[0]
    im1 = torch.tensor(s["im1"], device=dev)[None]
    im2 = torch.tensor(s["im2"], device=dev)[None]

    def fwd(a, b):
        return model(a, b, train=False)

    with torch.inference_mode():
        fwd(im1, im2)  # warm-up
        torch.cuda.synchronize()
        with no_plain_correlation():
            reset_launches(ck)
            flows = fwd(im1, im2)
            torch.cuda.synchronize()
            launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        flow = flows[-1][0].float().cpu().numpy()
        finite = bool(np.isfinite(flow).all())
        epe = float(np.sqrt(((flow - s["flow"]) ** 2).sum(-1)).mean())
        b1_wall = wall_ms(lambda: fwd(im1, im2), reps=10)
        b1_dev = timer(lambda: fwd(im1, im2), reps=10, inner=1)
        b1_busy, b1_n, top = profile_kernels(lambda: fwd(im1, im2))
        im1_4, im2_4 = im1.repeat(4, 1, 1, 1), im2.repeat(4, 1, 1, 1)
        b4_wall = wall_ms(lambda: fwd(im1_4, im2_4), reps=5)
        b4_dev = timer(lambda: fwd(im1_4, im2_4), reps=5, inner=1)
        b4_busy = profile_kernels(lambda: fwd(im1_4, im2_4))[0]
    predict_wall = wall_ms(lambda: predict_flow(model, s["im1"], s["im2"]),
                           reps=10)
    emit({"phase": "raft_forward", "dtype": "bfloat16", "hw": [448, 1024],
          "iters": RAFT_ITERS, "launches": launches, "finite": finite,
          "flow_shape": list(flows[-1].shape), "epe_sample0": epe,
          "ms_per_frame_batch1_wall": b1_wall,
          "ms_per_frame_batch1_device": b1_dev,
          "device_busy_ms_batch1": b1_busy,
          "idle_share_of_wall_batch1": 1 - b1_busy / b1_wall,
          "kernel_launches_batch1": b1_n, "top": top,
          "ms_batch4_wall": b4_wall, "ms_batch4_device": b4_dev,
          "device_busy_ms_batch4": b4_busy,
          "idle_share_of_wall_batch4": 1 - b4_busy / b4_wall,
          "frames_per_s_batch4_wall": 4e3 / b4_wall,
          "predict_flow_ms_wall": predict_wall, "nvidia_smi": smi})
    if not finite or tuple(flows[-1].shape) != (1, 448, 1024, 2):
        raise AssertionError(f"bad RAFT flow: finite={finite} "
                             f"{tuple(flows[-1].shape)}")
    if launches != RAFT_FWD_LAUNCHES:
        raise AssertionError(f"expected {RAFT_FWD_LAUNCHES} per RAFT forward,"
                             f" got {launches}")

    # f32, card kernels against the CPU's plain ops, every iteration.
    v = SyntheticFlow(split="val", hw=(384, 448))[2]
    a, b = (torch.tensor(v[k])[None] for k in ("im1", "im2"))
    with torch.inference_mode():
        f_cpu = raft_model(torch.float32, "cpu")(a, b)
        f_card = raft_model(torch.float32, dev)(a.to(dev), b.to(dev))
    per_iter = [rel_err(g.cpu(), w)[1] for g, w in zip(f_card, f_cpu)]
    emit({"phase": "raft_forward_f32_card_vs_cpu", "hw": [384, 448],
          "rel_err_per_iteration": per_iter, "tol": FWD_TOL})
    if not max(per_iter) <= FWD_TOL:
        raise AssertionError(f"RAFT card and CPU forwards disagree: "
                             f"{max(per_iter)}")

    # The trained checkpoint on synthetic-proof's val split, as its
    # trainer's periodic eval reads it (bf16, batch 8, 128 samples).
    cfg = PRESETS["synthetic-proof"]
    ds = get_dataset(cfg.data.name, cfg.data.root, split="val",
                     hw=cfg.data.sample_hw, regime=cfg.data.synthetic_regime,
                     val_length=cfg.data.synthetic_val_length)
    t0 = time.perf_counter()
    ev = evaluate_dataset(model, ds, batch=cfg.data.eval_batch,
                          limit=cfg.train.eval_limit)
    emit({"phase": "raft_eval", "checkpoint": os.path.relpath(RAFT_NPZ, ROOT),
          "dataset": "synthetic-proof val, 384x448", "dtype": "bfloat16",
          "seconds": time.perf_counter() - t0, "epe_max": RAFT_EPE_MAX, **ev})
    if not (ev["num_samples"] == cfg.train.eval_limit
            and ev["epe"] < RAFT_EPE_MAX):
        raise AssertionError(f"RAFT val EPE {ev['epe']} on "
                             f"{ev['num_samples']} samples")
    return {"launches": launches, "ms_per_frame_batch1_wall": b1_wall}


def raft_config(name: str, loss: str = "sequence", **train_kw):
    """synthetic-proof with RAFT and a sequence loss, logging under
    RUN_DIR/name."""
    import dataclasses
    cfg = train_config(name, loss=loss, **train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, family="raft"))


def raft_train(out_dir: str, dev, smi: str, timer) -> dict:
    """raft_train: train() with RAFT (bf16, 8 x 384x448, sequence loss):
    finite metrics, 24 launches of each of K1-K3 per step and no plain
    correlation, a checkpoint round trip bit for bit and a resume; the
    step's wall, device span, busy time and idle share; one f32 step on the
    card against the CPU; sequence against sequence_inscan on the card; an
    overfit on a constant flow."""
    import dataclasses
    import shutil
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.losses import sequence_loss
    from pwcnet_tpu_torch.models import RAFT
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model, train
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step

    cfg = raft_config("raft_train", summary_interval=1)
    shutil.rmtree(cfg.train.log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches(ck)
    t0 = time.perf_counter()
    with no_plain_correlation():
        final = train(cfg, max_steps=RAFT_TRAIN_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    per_step = {k: v / RAFT_TRAIN_STEPS for k, v in ck.LAUNCHES.items() if v}
    recs = _metrics(cfg.train.log_dir)
    steps = [{k: r[k] for k in ("step", "loss", "train_epe", "grad_norm",
                                "pairs_per_sec")} for r in recs]
    finite = _finite_steps(recs)
    ckpt = CheckpointManager(os.path.join(cfg.train.log_dir, "ckpt"))
    model = build_model(cfg)
    fresh = TrainState.create(model, *optimizer_from_config(
        model.parameters(), cfg.train), seed=cfg.train.seed + 1)
    ckpt.restore(fresh)
    saved = ckpt.load()["model"]
    restored = (fresh.step == RAFT_TRAIN_STEPS and all(
        torch.equal(v.cpu(), saved[k]) for k, v in
        fresh.model.state_dict().items()))
    resumed = train(cfg, max_steps=2)["step"]
    shutil.copy(os.path.join(cfg.train.log_dir, "metrics.jsonl"),
                os.path.join(out_dir, "raft_train_metrics.jsonl"))
    shutil.rmtree(cfg.train.log_dir)

    # The step alone, on one device-rendered batch.
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    state = TrainState.create(model, opt, sched, seed=1)
    step_fn = make_train_step(model, opt, sched, loss_kind="sequence")
    batch = make_device_batcher(cfg.train.global_batch,
                                cfg.data.augment.crop_hw, seed=5,
                                device=dev)(0)

    def one_step():
        step_fn(state, batch)

    step_wall = wall_ms(one_step, reps=5)
    step_dev = timer(one_step, reps=5, inner=1)
    busy, n_launch, top = profile_kernels(one_step, n=2)
    emit({"phase": "raft_train", "config": "synthetic-proof, RAFT, "
          f"sequence, bf16, batch {cfg.train.global_batch}, "
          f"{cfg.data.augment.crop_hw}", "steps": steps, "final": final,
          "wall_s": wall_s, "launches_per_step": per_step, "finite": finite,
          "restored": restored, "resumed_to_step": resumed,
          "ms_per_step_wall": step_wall, "ms_per_step_device": step_dev,
          "pairs_per_s_wall": cfg.train.global_batch * 1e3 / step_wall,
          "device_busy_ms_per_step": busy,
          "idle_share_of_wall": 1 - busy / step_wall,
          "kernel_launches_per_step": n_launch, "top": top,
          "nvidia_smi": smi})
    if not finite or len(steps) != RAFT_TRAIN_STEPS:
        raise AssertionError(f"RAFT train steps not finite: {steps}")
    if per_step != RAFT_TRAIN_LAUNCHES:
        raise AssertionError(f"expected {RAFT_TRAIN_LAUNCHES} per RAFT train "
                             f"step, got {per_step}")
    if not restored or resumed != RAFT_TRAIN_STEPS + 2:
        raise AssertionError(f"RAFT checkpoint round trip failed: restored="
                             f"{restored}, resumed to {resumed}")

    # One f32 step (TF32 off), card against CPU, same weights and batch.
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    small = make_device_batcher(2, (128, 160), seed=6, device="cpu")(0)
    ref_state = build_model(cfg32, "cpu").state_dict()

    def f32_step(where, im_noise=0.0, seed=0, loss_kind="sequence"):
        m = build_model(cfg32, where)
        m.load_state_dict(ref_state)
        return one_step_grads(m, cfg32.train, small, loss_kind, im_noise,
                              seed)

    m_cpu, g_cpu = f32_step("cpu")
    m_card, g_card = f32_step(dev)
    floor = max(max(grad_rel(f32_step("cpu", 1e-6, s)[1], g_cpu).values())
                for s in range(3))
    metric_rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                  for k in m_cpu}
    vs_cpu = grad_rel(g_card, g_cpu)
    tol = max(TRAIN_TOL, FLOOR_FACTOR * floor)
    # sequence against sequence_inscan on the card (f32, same weights and
    # batch): the loss summed inside the loop equals the external one.
    m_inscan = f32_step(dev, loss_kind="sequence_inscan")[0]
    inscan_rel = {k: abs(m_inscan[k] - m_card[k]) / abs(m_card[k])
                  for k in ("loss", "grad_norm")}
    emit({"phase": "raft_train_f32_card_vs_cpu", "batch": [2, 128, 160],
          "metrics_cpu": m_cpu, "metrics_card": m_card,
          "metric_rel_err": metric_rel, "metric_tol": TRAIN_TOL,
          "grad_rel_err_vs_cpu_max": max(vs_cpu.values()),
          "grad_rel_err_vs_cpu_worst3": sorted(
              vs_cpu.items(), key=lambda t: -t[1])[:3],
          "cpu_floor_1e-6": floor, "grad_tol": tol,
          "metrics_card_inscan": m_inscan, "inscan_rel_err": inscan_rel,
          "inscan_tol": INSCAN_TOL})
    if not (max(metric_rel.values()) <= TRAIN_TOL
            and max(vs_cpu.values()) <= tol):
        raise AssertionError("RAFT f32 train step: card and CPU disagree "
                             "beyond the tolerances")
    if not max(inscan_rel.values()) <= INSCAN_TOL:
        raise AssertionError(f"sequence and sequence_inscan disagree on the "
                             f"card: {inscan_rel}")

    # Overfit a constant flow, as JAX tests/test_raft.py::test_overfit: the
    # flow is refined at 1/8 resolution, and a constant is representable.
    gen = torch.Generator().manual_seed(0)
    im1, im2 = (torch.rand((1, 32, 32, 3), generator=gen).to(dev)
                for _ in range(2))
    gt = torch.tensor([3.0, -2.0], device=dev).expand(1, 32, 32, 2)
    m = RAFT(num_iters=4, corr_radius=2, device=dev)
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    losses = []
    for _ in range(RAFT_OVERFIT_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = sequence_loss(m(im1, im2), gt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    emit({"phase": "raft_overfit", "steps": RAFT_OVERFIT_STEPS,
          "losses": losses[::10] + losses[-1:],
          "ratio": losses[-1] / losses[0], "max_ratio": RAFT_OVERFIT_RATIO})
    if not (np.isfinite(losses).all()
            and losses[-1] < RAFT_OVERFIT_RATIO * losses[0]):
        raise AssertionError(f"RAFT overfit: {losses[::10]}")
    return {"launches_per_step": per_step, "ms_per_step_wall": step_wall}


def raft_cli(out_dir: str, roots: dict) -> None:
    """raft_cli: the command line with RAFT, in subprocesses on the card:
    train --preset raft-chairs on the chairs tree, crossing eval_interval
    once; predict with model.family=raft; match with RAFT and with
    PWC-Net on the repo's parity pair."""
    import shutil
    from pwcnet_tpu_torch.io import read_flo
    fixtures = os.path.join(ROOT, "tests", "fixtures", "parity")
    pair = ("--im1", os.path.join(fixtures, "im1.png"), "--im2",
            os.path.join(fixtures, "im2.png"))
    log_dir = os.path.join(RUN_DIR, "cli_raft_chairs")
    shutil.rmtree(log_dir, ignore_errors=True)
    final, train_s = run_cli("train", "--preset", "raft-chairs",
                             "--max-steps", "4",
                             f"data.root={roots['chairs']}",
                             "train.eval_interval=3", "train.eval_limit=8",
                             "train.summary_interval=2",
                             f"train.log_dir={log_dir}")
    vals = [r for r in _metrics(log_dir) if "val_epe" in r]
    shutil.rmtree(log_dir)
    val_steps = [r["step"] for r in vals]
    train_ok = (final["step"] == 4 and val_steps == [3] and bool(np.isfinite(
        [final["loss"], final["train_epe"], final["grad_norm"],
         vals[0]["val_epe"]]).all()))
    flo = os.path.join(out_dir, "cli_raft_predict.flo")
    pred, pred_s = run_cli("predict", *pair, "--out", flo,
                           "model.family=raft")
    flow = read_flo(flo)
    pred_ok = flow.shape == (128, 160, 2) and bool(np.isfinite(flow).all())
    matches = {}
    for family in ("raft", "pwcnet"):
        txt = os.path.join(out_dir, f"cli_match_{family}.txt")
        out, secs = run_cli("match", *pair, "--out", txt,
                            f"model.family={family}")
        rows = np.loadtxt(txt, ndmin=2)
        matches[family] = dict(out, seconds=secs, rows=len(rows),
                               ok=out["num_matches"] == len(rows) and bool(
                                   np.isfinite(rows).all()))
    emit({"phase": "raft_cli", "train_raft_chairs": final,
          "train_val": vals, "train_ok": train_ok,
          "train_s": train_s, "predict": pred, "predict_ok": pred_ok,
          "predict_s": pred_s, "match": matches})
    if not (train_ok and pred_ok and all(m["ok"] for m in matches.values())):
        raise AssertionError("the command line's RAFT train, predict or "
                             "match gave a wrong result")


TRAINED_NPZ = os.path.join(ROOT, "runs", "synthetic-proof",
                           "params_step125000_bf16.npz")
TRAINED_EVAL = os.path.join(ROOT, "runs", "synthetic-proof",
                            "final_eval.json")  # the TPU run, 256 pairs
TRAINED_PAIRS = 256
TRAINED_EPE_MAX = 0.05
TRAINED_HW = (384, 448)
PWC_FWD_LAUNCHES = {"corr_fwd": 5, "stem_fwd": 1}


def trained_pwcnet(dtype, device):
    """The port's PWC-Net with the repo's trained weights."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.compat import load_flax_params, read_flax_npz
    model = PWCNet(dtype=dtype, device=device)
    load_flax_params(model, read_flax_npz(TRAINED_NPZ))
    return model.eval()


def pwc_trained(dev, smi: str) -> None:
    """pwc_trained: the repo's trained PWC-Net checkpoint (bf16 stored as
    uint16 views) in bf16 with corr_backend="pallas": K1 5 and K4 1
    launches per forward with the plain correlation refused, val EPE and
    Fl-all on synthetic-proof's 256 val pairs at 384x448 beside the TPU
    run's; the f32 card forward against the CPU's per level."""
    from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    model = trained_pwcnet(torch.bfloat16, dev)
    val = SyntheticFlow(split="val", hw=TRAINED_HW, val_length=TRAINED_PAIRS)
    s = val[0]
    im1, im2 = (torch.tensor(s[k], device=dev)[None] for k in ("im1", "im2"))
    with torch.inference_mode():
        model(im1, im2, train=False)  # warm-up
        torch.cuda.synchronize()
        with no_plain_correlation():
            reset_launches(ck, sk)
            model(im1, im2, train=False)
            torch.cuda.synchronize()
            launches = {k: v for m in (ck, sk) for k, v in m.LAUNCHES.items()
                        if v}
    t0 = time.perf_counter()
    ev = evaluate_dataset(model, val, batch=8, limit=TRAINED_PAIRS)
    with open(TRAINED_EVAL) as f:
        tpu = json.load(f)
    # f32: the card's kernels against the CPU's plain ops, per level.
    a, b = (torch.tensor(s[k])[None] for k in ("im1", "im2"))
    with torch.inference_mode():
        f_cpu = trained_pwcnet(torch.float32, "cpu")(a, b)
        f_card = trained_pwcnet(torch.float32, dev)(a.to(dev), b.to(dev))
    per_level = [rel_err(g.cpu(), w)[1] for g, w in zip(f_card, f_cpu)]
    emit({"phase": "pwc_trained",
          "checkpoint": os.path.relpath(TRAINED_NPZ, ROOT),
          "dataset": "synthetic-proof val, 384x448", "dtype": "bfloat16",
          "launches_per_forward": launches, "epe": ev["epe"],
          "fl_all": ev["fl_all"], "num_samples": ev["num_samples"],
          "tpu_epe_same_pairs": tpu["epe"], "tpu_fl_all": tpu["fl_all"],
          "epe_max": TRAINED_EPE_MAX, "eval_seconds": time.perf_counter() - t0,
          "f32_rel_err_per_level": per_level, "tol": FWD_TOL,
          "nvidia_smi": smi})
    if launches != PWC_FWD_LAUNCHES:
        raise AssertionError(f"expected {PWC_FWD_LAUNCHES} per forward, got "
                             f"{launches}")
    if not (ev["num_samples"] == TRAINED_PAIRS and np.isfinite(ev["epe"])
            and ev["epe"] < TRAINED_EPE_MAX):
        raise AssertionError(f"trained PWC-Net val EPE {ev['epe']} on "
                             f"{ev['num_samples']} pairs")
    if not max(per_level) <= FWD_TOL:
        raise AssertionError(f"trained PWC-Net card and CPU forwards "
                             f"disagree: {per_level}")


# -- GroupNorm (use_norm), the parity harness and the .pth import ----------
NORM_FWD_HW = (448, 1024)      # norm_forward, bf16, batch 1
NORM_F32_HW = (384, 448)       # the f32 forward, card vs CPU
NORM_TRAIN_STEPS = 3           # norm_train through train()
NORM_STEP_BATCH = (2, 128, 192)  # the f32 step, card vs CPU
# use_norm turns the fused stem off (as in JAX): K1 only in a forward, K1-K3
# in a train step, no K4 or K5.
NORM_FWD_LAUNCHES = {"corr_fwd": 5}
NORM_TRAIN_LAUNCHES = {"corr_fwd": 5, "corr_bwd_f1": 5, "corr_bwd_f2": 5}
PARITY_DIR = os.path.join(ROOT, "tests", "fixtures", "parity")
PARITY_RTOL = 1e-4  # every number of the card's f32 report vs the CPU's


def norm_model(dtype, device, state=None):
    """The full-width PWC-Net with GroupNorm (6 levels, pallas), weights
    seeded, or ``state``."""
    from pwcnet_tpu_torch import PWCNet
    model = PWCNet(use_norm=True, dtype=dtype, device=device,
                   generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    return model.eval()


def norm_forward(dev, base, timer, smi) -> dict:
    """norm_forward: the use_norm PWC-Net in bf16 at 448x1024, batch 1: K1
    5 and K4 0 launches a forward with the plain correlation refused, wall,
    device span and busy time; its f32 forward on the card against the
    CPU's per level (pyramid, correlation, flows)."""
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    h, w = NORM_FWD_HW
    pair = [torch.from_numpy(np.ascontiguousarray(a))[None].to(dev) for a in
            (base[:h, :w], np.roll(base, (2, 5), (0, 1))[:h, :w])]
    model = norm_model(torch.bfloat16, dev)
    with torch.inference_mode():
        model(*pair)  # warm-up
        torch.cuda.synchronize()
        with no_plain_correlation():
            reset_launches(ck, sk, wk)
            flows = model(*pair)
            torch.cuda.synchronize()
            launches = {k: v for m in (ck, sk, wk)
                        for k, v in m.LAUNCHES.items() if v}
        finite = all(bool(torch.isfinite(f).all()) for f in flows)
        fwd_wall = wall_ms(lambda: model(*pair))
        fwd_dev = timer(lambda: model(*pair), reps=20, inner=1)
        busy, n_launch, top = profile_kernels(lambda: model(*pair))
    h, w = NORM_F32_HW
    a, b = (torch.from_numpy(np.ascontiguousarray(x))[None] for x in
            (base[:h, :w], np.roll(base, (2, 5), (0, 1))[:h, :w]))
    cpu_model = norm_model(torch.float32, "cpu")
    card_model = norm_model(torch.float32, dev, cpu_model.state_dict())
    inter_cpu, inter_card = {}, {}
    with torch.inference_mode():
        f_cpu = cpu_model(a, b, intermediates=inter_cpu)
        f_card = card_model(a.to(dev), b.to(dev), intermediates=inter_card)
    per_level = {key: [rel_err(g.cpu(), w)[1] for g, w in zip(got, want)]
                 for key, got, want in (
                     ("pyramid", inter_card["pyramid"], inter_cpu["pyramid"]),
                     ("corr", inter_card["corr"], inter_cpu["corr"]),
                     ("flows", f_card, f_cpu))}
    worst = max(max(v) for v in per_level.values())
    out = {"phase": "norm_forward", "dtype": "bfloat16",
           "hw": list(NORM_FWD_HW), "flow_shapes": [list(f.shape)
                                                    for f in flows],
           "finite": finite, "launches_per_forward": launches,
           "ms_per_frame_batch1_wall": fwd_wall,
           "ms_per_frame_batch1_device": fwd_dev,
           "device_busy_ms_per_frame": busy,
           "idle_share_of_wall": 1 - busy / fwd_wall,
           "kernel_launches_per_frame": n_launch, "top": top,
           "f32_hw": list(NORM_F32_HW), "f32_rel_err_per_level": per_level,
           "tol": FWD_TOL, "nvidia_smi": smi}
    emit(out)
    if not finite or launches != NORM_FWD_LAUNCHES:
        raise AssertionError(f"use_norm forward: finite={finite}, expected "
                             f"{NORM_FWD_LAUNCHES} per forward, got "
                             f"{launches}")
    if not worst <= FWD_TOL:
        raise AssertionError(f"use_norm card and CPU forwards disagree: "
                             f"{per_level}")
    return out


def norm_train(dev, timer, smi) -> dict:
    """norm_train: synthetic-proof with use_norm, bf16, batch 8 at 384x448:
    train() for NORM_TRAIN_STEPS steps with the plain correlation refused
    (K1, K2, K3 5/5/5 a step, K4 and K5 0), then the step on a fixed batch
    (wall, device span, busy time, pairs/s); one f32 step's metrics and
    gradients, card against CPU, under the f32 floor rule."""
    import dataclasses
    import shutil
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    from pwcnet_tpu_torch.train.loop import build_model, train
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    from pwcnet_tpu_torch.train.step import make_train_step
    cfg = train_config("norm", summary_interval=1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_norm=True))
    shutil.rmtree(cfg.train.log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with no_plain_correlation():
        reset_launches(ck, sk, wk)
        final = train(cfg, max_steps=NORM_TRAIN_STEPS)
        torch.cuda.synchronize()
    per_step = {k: v / NORM_TRAIN_STEPS for m in (ck, sk, wk)
                for k, v in m.LAUNCHES.items() if v}
    shutil.rmtree(cfg.train.log_dir, ignore_errors=True)
    finite = _finite(final)

    model = build_model(cfg)
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    state = TrainState.create(model, opt, sched, seed=1)
    step_fn = make_train_step(model, opt, sched)
    batch = make_device_batcher(cfg.train.global_batch,
                                cfg.data.augment.crop_hw, seed=5,
                                device=dev)(0)

    def one_step():
        step_fn(state, batch)

    step_wall = wall_ms(one_step, reps=10)
    step_dev = timer(one_step, reps=10, inner=1)
    busy, n_launch, top = profile_kernels(one_step)

    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    small = make_device_batcher(NORM_STEP_BATCH[0], NORM_STEP_BATCH[1:],
                                seed=6, device="cpu")(0)
    ref_state = build_model(cfg32, "cpu").state_dict()

    def f32_step(where, im_noise=0.0, seed=0):
        m = build_model(cfg32, where)
        m.load_state_dict(ref_state)
        return one_step_grads(m, cfg32.train, small, im_noise=im_noise,
                              seed=seed)

    m_cpu, g_cpu = f32_step("cpu")
    m_card, g_card = f32_step(dev)
    floor = max(max(grad_rel(f32_step("cpu", 1e-6, s)[1], g_cpu).values())
                for s in range(3))
    tol = max(TRAIN_TOL, FLOOR_FACTOR * floor)
    metric_rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
                  for k in m_cpu}
    vs_cpu = grad_rel(g_card, g_cpu)
    out = {"phase": "norm_train", "config": "synthetic-proof, use_norm, "
           f"bf16, batch {cfg.train.global_batch}, "
           f"{cfg.data.augment.crop_hw}", "final": final, "finite": finite,
           "launches_per_step": per_step,
           "ms_per_step_wall": step_wall, "ms_per_step_device": step_dev,
           "pairs_per_s_wall": cfg.train.global_batch * 1e3 / step_wall,
           "device_busy_ms_per_step": busy,
           "idle_share_of_wall": 1 - busy / step_wall,
           "kernel_launches_per_step": n_launch, "top": top,
           "f32_batch": list(NORM_STEP_BATCH), "metric_rel_err": metric_rel,
           "metric_tol": TRAIN_TOL,
           "grad_rel_err_vs_cpu_max": max(vs_cpu.values()),
           "grad_rel_err_vs_cpu_worst3": sorted(
               vs_cpu.items(), key=lambda t: -t[1])[:3],
           "cpu_floor_1e-6": floor, "grad_tol": tol, "nvidia_smi": smi}
    emit(out)
    if not finite or per_step != NORM_TRAIN_LAUNCHES:
        raise AssertionError(f"use_norm train: finite={finite}, expected "
                             f"{NORM_TRAIN_LAUNCHES} per step, got "
                             f"{per_step}")
    if not (max(metric_rel.values()) <= TRAIN_TOL
            and max(vs_cpu.values()) <= tol):
        raise AssertionError("use_norm f32 train step: card and CPU "
                             "disagree beyond the tolerances")
    return out


def _reports_close(got, want, rtol: float) -> bool:
    """Same keys and entries; every float within ``rtol`` relative."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _reports_close(got[k], want[k], rtol) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(
            _reports_close(g, w, rtol) for g, w in zip(got, want))
    if isinstance(want, float):
        return abs(got - want) <= rtol * abs(want)
    return got == want


def run_parity_cli(*args):
    """``python -m pwcnet_tpu_torch.cli parity`` on the repo's parity pair,
    f32, in a subprocess on the card (TF32 off, as in this script's f32
    checks): its report and seconds."""
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    report, secs = run_cli(
        "parity", "--im1", os.path.join(PARITY_DIR, "im1.png"), "--im2",
        os.path.join(PARITY_DIR, "im2.png"), "--gt",
        os.path.join(PARITY_DIR, "gt.flo"), "--sweep", *args,
        "model.dtype=float32", env=env, whole=True)
    return report, secs


def parity_trained(out_dir: str, smi: str) -> str:
    """parity_trained: the repo's trained PWC-Net written into a port
    checkpoint directory; the CLI's ``parity --sweep --ckpt DIR`` on the
    repo's parity pair on the card (f32) against ``parity_report`` on the
    CPU: every number within PARITY_RTOL relative, the same ``best``.
    Returns the directory."""
    import dataclasses
    from pwcnet_tpu_torch.config import Config
    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.parity import parity_report
    from pwcnet_tpu_torch.train.schedule import optimizer_from_config
    from pwcnet_tpu_torch.train.state import TrainState
    ckpt = os.path.join(RUN_DIR, "parity_ckpt")
    model = trained_pwcnet(torch.float32, "cpu")
    opt, sched = optimizer_from_config(model.parameters(), Config().train)
    CheckpointManager(ckpt).save(TrainState.create(model, opt, sched,
                                                    seed=0))
    card, secs = run_parity_cli("--ckpt", ckpt)
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    cpu = parity_report(cfg, os.path.join(PARITY_DIR, "im1.png"),
                        os.path.join(PARITY_DIR, "im2.png"),
                        gt_path=os.path.join(PARITY_DIR, "gt.flo"),
                        ckpt=ckpt, sweep=True, device="cpu")
    with open(os.path.join(out_dir, "parity_trained.json"), "w") as f:
        json.dump({"card": card, "cpu": cpu}, f, indent=1)
    close = _reports_close(card, cpu, PARITY_RTOL)
    emit({"phase": "parity_trained",
          "checkpoint": os.path.relpath(TRAINED_NPZ, ROOT),
          "pair": os.path.relpath(PARITY_DIR, ROOT), "report": card,
          "cpu_best": cpu["best"], "rtol": PARITY_RTOL,
          "card_matches_cpu": close, "cli_seconds": secs,
          "nvidia_smi": smi})
    if not close or card["best"] != cpu["best"]:
        raise AssertionError("the card's parity report disagrees with the "
                             "CPU's")
    return ckpt


def reference_state_dict(model) -> dict:
    """The port PWC-Net's convs under the reference's key names (its
    ``feature_pyramid_extractor.convs.<level>.<i>.0``, coarse-first
    ``flow_estimators.<i>.convs.<j>.0`` and ``.flow_conv``,
    ``context_networks.convs.<j>.0`` and ``.flow_conv``), in the
    reference's registration order."""
    p = model.pyramid
    convs = [p.stem.conv1, p.stem.conv2, p.stem.conv3, p.stem.conv4] + [
        b.conv for b in p.blocks]
    named = [(f"feature_pyramid_extractor.convs.{i // 2}.{i % 2}.0", c)
             for i, c in enumerate(convs)]
    for i, lv in enumerate(sorted((int(k[1:]) for k in model.estimators),
                                  reverse=True)):
        est = model.estimators[f"l{lv}"]
        named += [(f"flow_estimators.{i}.convs.{j}.0", b.conv)
                  for j, b in enumerate(est.stack.blocks)]
        named.append((f"flow_estimators.{i}.flow_conv", est.flow))
    named += [(f"context_networks.convs.{j}.0", b.conv)
              for j, b in enumerate(model.context.blocks)]
    named.append(("context_networks.flow_conv", model.context.flow))
    return {f"{n}.{leaf}": getattr(c, leaf).detach().clone()
            for n, c in named for leaf in ("weight", "bias")}


def pth_import(ckpt: str, dev, smi: str) -> None:
    """pth_import: the trained weights under the reference's module layout,
    saved as a .pth and imported (``compat.import_torch_checkpoint``): on
    the card the .pth model's f32 flows on the parity pair equal the
    checkpoint directory's bit for bit, and the CLI's ``parity --ckpt
    <file>.pth`` reports what ``parity --ckpt DIR`` does."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.compat import import_torch_checkpoint
    from pwcnet_tpu_torch.data.base import read_image
    from pwcnet_tpu_torch.train.checkpoint import load_model_weights
    from pwcnet_tpu_torch.train.evaluate import pad_to_divisible
    pth = os.path.join(RUN_DIR, "trained_reference.pth")
    torch.save(reference_state_dict(trained_pwcnet(torch.float32, "cpu")),
               pth)
    from_pth = PWCNet(device=dev)
    filled = import_torch_checkpoint(pth, from_pth)
    from_dir = PWCNet(device=dev)
    load_model_weights(from_dir, ckpt)
    pair = [torch.tensor(pad_to_divisible(read_image(os.path.join(
        PARITY_DIR, n))[None], 64)[0], device=dev)
        for n in ("im1.png", "im2.png")]
    with torch.inference_mode():
        fa = from_pth.eval()(*pair)
        fb = from_dir.eval()(*pair)
    flows_equal = all(torch.equal(x, y) for x, y in zip(fa, fb))
    params_equal = all(torch.equal(v, from_dir.state_dict()[k])
                       for k, v in from_pth.state_dict().items())
    by_pth, secs = run_parity_cli("--ckpt", pth)
    by_dir, _ = run_parity_cli("--ckpt", ckpt)
    emit({"phase": "pth_import", "keys": len(filled),
          "params_equal": params_equal, "flows_bit_equal": flows_equal,
          "cli_report_equal": by_pth == by_dir, "cli_seconds": secs,
          "best": by_pth["best"], "nvidia_smi": smi})
    if not (params_equal and flows_equal and by_pth == by_dir
            and len(filled) == len(from_pth.state_dict())):
        raise AssertionError("the .pth import of the trained weights does "
                             "not give the checkpoint directory's model")


DDP_WORLD = 2      # gloo ranks sharing the one card
DDP_STEPS = 4      # (a): a checkpoint at 2, resumed to 4 in a second launch
DDP_F32_STEPS = 2  # (b): two ranks against one process
# (b) as the f32 train-step check holds one step (TRAIN_TOL on the metrics,
# its measured floor rule on the gradients): the first step's metrics and
# gradients, and the second step's loss. The second step's gradients and the
# parameters are printed: Adam moves an entry whose gradient is within
# rounding of 0 by about +-lr either way, and the second step's gradients
# then jump where a LeakyReLU input crossed 0.


def _ranks_equal(results) -> bool:
    """Whether every rank ended with rank 0's parameters, bit for bit
    (their SHA-256, or the tensors)."""
    first = results[0]["params"]
    if isinstance(first, str):
        return all(r["params"] == first for r in results)
    return all(torch.equal(r["params"][k], v) for r in results
               for k, v in first.items())


def _finite(metrics: dict) -> bool:
    return bool(np.isfinite([v for k, v in metrics.items()
                             if k != "step"]).all())


def ddp_train(out_dir: str, dev, smi: str, grad_tol: float) -> dict:
    """ddp_train: data-parallel training on DDP_WORLD gloo ranks that share
    the card (parallel.launch.run_ranks, one process a rank): (a) PWC-Net
    bf16, synthetic-proof with device_gen, global batch 8 at 384x448, 4
    rows a rank, DDP_STEPS steps with a checkpoint at 2 and a resume to 4
    in a second launch: finite metrics, the ranks' parameters equal bit for
    bit (SHA-256), one record a step in metrics.jsonl and the checkpoints
    of process 0, K1-K5 5/5/5/1/1 per step on each rank, the wall per step
    and the collectives' host time (two ranks on one card: no speed is
    claimed); (b) PWC-Net f32, two ranks against one process on the same
    global batches; (c) RAFT bf16, one step: 24 of each of K1-K3 per rank;
    (d) nccl: two ranks on one card are refused before any NCCL
    communicator exists, and (a) runs under nccl where there are two
    cards."""
    import dataclasses
    import shutil
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    from pwcnet_tpu_torch.parallel.launch import params_digest, run_ranks
    from pwcnet_tpu_torch.parallel.launch import run_steps
    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model
    cfg = train_config("ddp", summary_interval=1, checkpoint_interval=2)
    shutil.rmtree(cfg.train.log_dir, ignore_errors=True)
    half = DDP_STEPS // 2

    def job(tasks, backend="gloo"):
        return dict(backend=backend, device=str(dev), allow_tf32=False,
                    tasks=tasks)

    # (a), first launch: steps 1-2, checkpoint at 2.
    t0 = time.perf_counter()
    first = [r[0] for r in run_ranks(DDP_WORLD, job([dict(
        kind="train", cfg=cfg, max_steps=half, digest=True)]),
        os.path.join(RUN_DIR, "ddp_job1"), timeout=600)]
    first_s = time.perf_counter() - t0
    ckpt = CheckpointManager(os.path.join(cfg.train.log_dir, "ckpt"))
    saved = build_model(cfg, "cpu")
    saved.load_state_dict(ckpt.load(half)["model"])
    ckpt_digest = params_digest(saved)

    # (a) resumed to DDP_STEPS (its collectives profiled on each rank), (b)
    # and (c) in one second launch.
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="float32"))
    sd32 = build_model(cfg32, "cpu").state_dict()
    batcher = make_device_batcher(cfg.train.global_batch,
                                  cfg.data.augment.crop_hw, seed=7,
                                  device="cpu")
    batches = [batcher(s) for s in range(DDP_F32_STEPS)]
    rcfg = raft_config("ddp_raft", summary_interval=1)
    shutil.rmtree(rcfg.train.log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    second = run_ranks(DDP_WORLD, job([
        dict(kind="train", cfg=cfg, max_steps=DDP_STEPS - half, digest=True,
             profile=True),
        dict(kind="step", cfg=cfg32, state_dict=sd32, batches=batches),
        dict(kind="train", cfg=rcfg, max_steps=1, digest=True)]),
        os.path.join(RUN_DIR, "ddp_job2"), timeout=600)
    second_s = time.perf_counter() - t0
    resumed, f32, raft = ([r[i] for r in second] for i in range(3))

    # (a): metrics, files, launches, equality.
    recs = _metrics(cfg.train.log_dir)
    steps_logged = [r["step"] for r in recs]
    ckpt_steps = ckpt.steps()
    launches = [r["launches_per_step"] for r in first + resumed]
    walls = {r["step"]: cfg.train.global_batch * 1e3 / r["pairs_per_sec"]
             for r in recs}
    coll = resumed[0]["collectives"]

    def coll_ms(name):  # per step: the gradients' and metrics' all-reduces
        return sum(c["cpu_ms"] for c in coll if c["name"] == name) / (
            DDP_STEPS - half)
    # (b): two ranks against one process on the card, same global batches.
    one = run_steps(cfg32, sd32, batches, device=dev)
    got = f32[0]
    metric_rel = [{k: abs(g[k] - w[k]) / abs(w[k]) for k in w}
                  for g, w in zip(got["metrics"], one["metrics"])]
    grad_rel_steps = [max(grad_rel(g, w).values())
                      for g, w in zip(got["grads"], one["grads"])]
    diffs = {n: (got["params"][n] - w).abs() for n, w in one["params"].items()}
    inside = sum(int((d <= 2e-6 + 2e-4 * one["params"][n].abs()).sum())
                 for n, d in diffs.items())
    total = sum(d.numel() for d in diffs.values())
    # (c): RAFT's launches per rank.
    raft_launches = [r["launches_per_step"] for r in raft]
    # (d): nccl.
    try:
        run_ranks(DDP_WORLD, job([dict(kind="mesh", device="cuda:0")],
                                 backend="nccl"),
                  os.path.join(RUN_DIR, "ddp_nccl_refused"), timeout=300)
        refused = "not refused"
    except RuntimeError as e:
        refused = "refused" if "backend='gloo'" in str(e) else str(e)[-2000:]
    nccl = "not run: one card"
    if torch.cuda.device_count() >= DDP_WORLD:
        ncfg = train_config("ddp_nccl", summary_interval=1)
        shutil.rmtree(ncfg.train.log_dir, ignore_errors=True)
        runs = [r[0] for r in run_ranks(DDP_WORLD, job([dict(
            kind="train", cfg=ncfg, max_steps=DDP_STEPS, digest=True)],
            backend="nccl"), os.path.join(RUN_DIR, "ddp_nccl"),
            timeout=600)]
        nccl = {"finite": all(_finite(r["final"]) for r in runs),
                "ranks_equal": _ranks_equal(runs),
                "launches": [r["launches_per_step"] for r in runs]}
    shutil.copy(os.path.join(cfg.train.log_dir, "metrics.jsonl"),
                os.path.join(out_dir, "ddp_train_metrics.jsonl"))
    row = {"phase": "ddp_train", "world": DDP_WORLD, "backend": "gloo",
           "device": str(dev), "nvidia_smi": smi,
           "a_pwcnet_bf16": {
               "config": f"synthetic-proof, bf16, global batch "
                         f"{cfg.train.global_batch} at "
                         f"{cfg.data.augment.crop_hw}, "
                         f"{cfg.train.global_batch // DDP_WORLD} rows a rank",
               "launch_seconds": [first_s, second_s],
               "final": [r["final"] for r in resumed],
               "steps_logged": steps_logged, "checkpoint_steps": ckpt_steps,
               "digests_first": [r["params"] for r in first],
               "checkpoint_digest": ckpt_digest,
               "digests_final": [r["params"] for r in resumed],
               "launches_per_step_per_rank": launches,
               "ms_per_step_wall": walls,
               "pairs_per_s_step2": cfg.train.global_batch * 1e3 / walls[2],
               "wall_note": "steps 3-4 ran under the profiler",
               "rank0_collectives": coll,
               "rank0_gloo_all_reduce_ms_per_step": coll_ms(
                   "gloo:all_reduce"),
               "rank0_c10d_allreduce_ms_per_step": coll_ms(
                   "c10d::allreduce_")},
           "b_pwcnet_f32": {
               "steps": DDP_F32_STEPS, "metrics_two_ranks": got["metrics"],
               "metrics_one_process": one["metrics"],
               "metric_rel_err": metric_rel, "metric_tol": TRAIN_TOL,
               "grad_rel_err_max_per_step": grad_rel_steps,
               "grad_tol": grad_tol,
               "params_max_abs_diff": max(d.max().item()
                                          for d in diffs.values()),
               "params_share_within_rtol2e-4_atol2e-6": inside / total,
               "ranks_equal": _ranks_equal(f32)},
           "c_raft_bf16": {"final": [r["final"] for r in raft],
                           "launches_per_step_per_rank": raft_launches,
                           "ranks_equal": _ranks_equal(raft)},
           "d_nccl": {"two_ranks_one_card": refused, "nccl": nccl}}
    emit(row)
    ok_a = (all(_finite(r["final"]) for r in first + resumed)
            and all(np.isfinite([r["loss"], r["train_epe"], r["grad_norm"]]
                                ).all() for r in recs)
            and steps_logged == list(range(1, DDP_STEPS + 1))
            and ckpt_steps == [half, DDP_STEPS]
            and [r["final"]["step"] for r in resumed] == [DDP_STEPS] * 2
            and _ranks_equal(first) and _ranks_equal(resumed)
            and ckpt_digest == first[0]["params"]
            and all(lc == TRAIN_LAUNCHES for lc in launches))
    if not ok_a:
        raise AssertionError(f"ddp_train (a) failed: {row['a_pwcnet_bf16']}")
    first_metrics = metric_rel[0].values()
    if not (max(first_metrics) <= TRAIN_TOL
            and metric_rel[1]["loss"] <= TRAIN_TOL
            and grad_rel_steps[0] <= grad_tol and _ranks_equal(f32)):
        raise AssertionError(f"ddp_train (b) failed: {row['b_pwcnet_f32']}")
    if not (all(_finite(r["final"]) for r in raft) and _ranks_equal(raft)
            and all(lc == RAFT_TRAIN_LAUNCHES for lc in raft_launches)):
        raise AssertionError(f"ddp_train (c) failed: {row['c_raft_bf16']}")
    if refused != "refused" or (isinstance(nccl, dict) and not (
            nccl["finite"] and nccl["ranks_equal"])):
        raise AssertionError(f"ddp_train (d) failed: {row['d_nccl']}")
    return {"launches_per_step": launches[0]}


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
    train_launches, f32_grad_tol = train_phases(out_dir, dev, smi, timer)
    fused_launches = fused_train(dev, timer, smi)

    # -- 5c. The file datasets: trees written under the output directory,
    # train() on them through the Loader and the augmentation, the kernels
    # at the file presets' shapes, the debug switches; then the command
    # line. The trees and the trainer's runs are removed at the end. -------
    import shutil
    tree_dir = os.path.join(out_dir, "trees")
    try:
        roots = file_trees(tree_dir)
        file_train(roots, out_dir, dev, smi, timer)
        file_train_shapes(roots, dev, smi, timer, gen)
        augment_card_vs_cpu(dev)
        debug_nans_phase(roots, dev)
        profile_dir_phase(roots)
        cli_phase(out_dir, roots)

        # -- 5d. RAFT at full width: K1-K3 at its shapes, the trained
        # checkpoint's forward and eval, the trainer, the command line -----
        raft_rows = raft_kernels(timer, dev)
        raft_fwd = raft_forward(dev, timer, smi)
        raft_tr = raft_train(out_dir, dev, smi, timer)
        raft_cli(out_dir, roots)

        # -- 5e. The trained PWC-Net checkpoint; data-parallel training on
        # two gloo ranks sharing the card ------------------------------------
        pwc_trained(dev, smi)

        # -- 5f. GroupNorm (use_norm): the forward and the trainer through
        # K1-K3; the parity harness and the .pth import on the trained
        # weights -----------------------------------------------------------
        norm_fwd = norm_forward(dev, base, timer, smi)
        norm_tr = norm_train(dev, timer, smi)
        pth_import(parity_trained(out_dir, smi), dev, smi)
        ddp = ddp_train(out_dir, dev, smi, f32_grad_tol)
    finally:
        shutil.rmtree(tree_dir, ignore_errors=True)
        shutil.rmtree(RUN_DIR, ignore_errors=True)

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
    # K1-K3 on RAFT's path: its launches per forward (448x1024) and per
    # train step (8 x 384x448), and the sums over its two scales (bf16).
    for k in kernels[:3]:
        rs = raft_rows[k["name"]]
        k["raft"] = {
            "launches_per_forward": raft_fwd["launches"].get(k["name"], 0),
            "launches_per_train_step": raft_tr["launches_per_step"][
                k["name"]]}
        for label, shapes in (("train", RAFT_TRAIN), ("448x1024", RAFT_INFER)):
            for key in ("ms", "bound_ms", "plain_ms"):
                k["raft"][f"{key}_{label}"] = sum(rs[sh][key] for sh in shapes)
    # K1-K3 on the use_norm path: launches per bf16 448x1024 forward and
    # per train step (8 x 384x448).
    for k in kernels[:3]:
        k["use_norm"] = {
            "launches_per_forward": norm_fwd["launches_per_forward"].get(
                k["name"], 0),
            "launches_per_train_step": norm_tr["launches_per_step"][
                k["name"]]}
    # K1-K5 under data parallelism: launches per step on each rank.
    for k in kernels[:5]:
        k["ddp_launches_per_step_per_rank"] = ddp["launches_per_step"][
            k["name"]]
    emit({"phase": "raft_levels", "levels": {
        name: [{k: r[k] for k in ("shape", "plan", "ms", "bound_ms",
                                  "plain_ms")} for r in rs.values()]
        for name, rs in raft_rows.items()}})
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
    # K6, K2 and K3 per level in the same form: K6 at the fused step's and
    # the 448x1024 pair's warped levels and K6p at the S = 2 shards (tile,
    # dy groups); K2 and K3 at the train step's levels (tile, channels a
    # block takes).
    for phase, sets in (
            ("k6_levels", (("train", k6_timed["train"]),
                           ("main_448x1024", k6_timed["main"]),
                           ("k6p_s2", k6p_timed))),
            ("k2_levels", (("train", corr_bwd_main["k2_check"]),)),
            ("k3_levels", (("train", corr_bwd_main["k3_check"]),))):
        levels = {name: [{k: r[k] for k in ("shape", "plan", "ms",
                                            "bound_ms", "plain_ms")}
                         for r in rs.values()] for name, rs in sets}
        emit({"phase": phase, "levels": levels,
              "sum_ms": {k: sum(r["ms"] for r in v)
                         for k, v in levels.items()},
              "sum_bound_ms": {k: sum(r["bound_ms"] for r in v)
                               for k, v in levels.items()},
              "sum_plain_ms": {k: sum(r["plain_ms"] for r in v)
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
