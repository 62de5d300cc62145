#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pwcnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from ``pwcnet_tpu_torch/csrc`` into ``build/``,
holds each against its plain PyTorch version on the card, drives the
PWC-Net inference forward (bf16, 448x1024, random seeded weights) through
the kernels, checks the flows, and times the kernels and the forward with
CUDA events. Each phase prints one JSON line; any failure raises and the
script exits non-zero. Without a CUDA device it exits 1 at once. The last
line is ``{"ok": true, "device": {...}}``; every phase's result and the
predicted flow go to ``DIR`` (default ``build/chip_smoke``).

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
K4_MAIN = (2, 448, 1024, 3)  # both frames of one 448x1024 pair
K4_MORE = [(1, 64, 192, 3), (4, 384, 448, 3)]
# Tolerances on max|kernel - plain| / max|plain|. f32: only the order of
# f32 sums differs (TF32 off). bf16, correlation: the same f32 sums, then
# one rounding to bf16, so at most one bf16 step (2**-8) apart. bf16, stem:
# four layers each rounded to bf16 at slightly different points.
TOL = {("corr", torch.float32): 1e-5, ("corr", torch.bfloat16): 8e-3,
       ("stem", torch.float32): 1e-4, ("stem", torch.bfloat16): 3e-2}
FWD_TOL = 1e-4  # f32 forward, card kernels vs CPU plain ops, per level

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


def bound_ms(bytes_moved: float, flops: float, dtype):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def corr_cost(shape, dtype):
    n, h, w, c = shape
    s = torch.empty((), dtype=dtype).element_size()
    return (2 * n * h * w * c + n * h * w * 81) * s, 2.0 * n * h * w * 81 * c


def stem_cost(shape, dtype):
    n, h, w, _ = shape
    s = torch.empty((), dtype=dtype).element_size()
    l1, l2 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    macs = n * (l1 * 16 * 27 + l1 * 16 * 144 + l2 * 32 * 144 + l2 * 32 * 288)
    n_w = 27 * 16 + 144 * 16 + 144 * 32 + 288 * 32 + 16 + 16 + 32 + 32
    return (n * h * w * 3 + n * l2 * 32) * s + n_w * 4, 2.0 * macs


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
    from pwcnet_tpu_torch.models.init import init_params
    from pwcnet_tpu_torch.models.layers import StemConvs
    from pwcnet_tpu_torch.ops.cost_volume import cost_volume_ref
    from pwcnet_tpu_torch.ops.kernels import (build, cost_volume_kernel,
                                              stem_kernel)

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

    # -- 3. K4 against stem_ref --------------------------------------------
    cpu_gen = torch.Generator().manual_seed(1)
    stem_mod = StemConvs(16, 32)
    init_params(stem_mod, cpu_gen)
    with torch.no_grad():
        for conv in (stem_mod.conv1, stem_mod.conv2, stem_mod.conv3,
                     stem_mod.conv4):
            # Non-zero biases: a wrong SAME-padding mask shows only then.
            conv.bias.copy_(0.1 * torch.randn(conv.bias.shape,
                                              generator=cpu_gen))
    stem_mod.to(dev)
    params = stem_mod.params()
    k4_main = None
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for shape in [K4_MAIN] + K4_MORE:
                im = torch.rand(shape, device=dev, generator=gen).to(dtype)
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
        cost_volume_kernel.LAUNCHES = 0
        stem_kernel.LAUNCHES = 0
        flows = model(im1, im2)
        torch.cuda.synchronize()
        launches = {"corr_fwd": cost_volume_kernel.LAUNCHES,
                    "stem_fwd": stem_kernel.LAUNCHES}
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

    # -- 5. Times -------------------------------------------------------------
    def wall_ms(fn, reps=20):
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            model(im1, im2)
        torch.cuda.synchronize()
    # Kernel entries only: an operator's entry repeats its kernels' time.
    by_name = sorted(((ev.key, ev.self_device_time_total / 1e3 / n_prof,
                       ev.count // n_prof) for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA
                      and ev.self_device_time_total > 0),
                     key=lambda t: -t[1])
    busy = sum(t[1] for t in by_name)
    emit({"phase": "forward_profile", "device_busy_ms_per_frame": busy,
          "idle_share_of_wall": 1 - busy / b1_wall,
          "kernel_launches_per_frame": sum(t[2] for t in by_name),
          "top": [{"name": k[:80], "ms": ms, "calls": c}
                  for k, ms, c in by_name[:15]]})

    # -- 6. Kernels ------------------------------------------------------------
    k1 = list(k1_main.values())
    k1_bytes = sum(r["bytes_ms"] for r in k1)
    k1_ops = sum(r["ops_ms"] for r in k1)
    kernels = [
        {"name": "corr_fwd", "route": "cuda",
         "source": cost_volume_kernel.SOURCE,
         "replaces": cost_volume_kernel.REPLACES,
         "launches": launches["corr_fwd"],
         "max_abs_err": max(r["max_abs_err"] for r in k1),
         "ms": sum(r["ms"] for r in k1),
         "plain_ms": sum(r["plain_ms"] for r in k1),
         "bound_ms": sum(r["bound_ms"] for r in k1),
         "bound_by": "bytes" if k1_bytes >= k1_ops else "operations",
         "library_ms": None},
        {"name": "stem_fwd", "route": "cuda", "source": stem_kernel.SOURCE,
         "replaces": stem_kernel.REPLACES,
         "launches": launches["stem_fwd"],
         "max_abs_err": k4_main["max_abs_err"], "ms": k4_main["ms"],
         "plain_ms": k4_main["plain_ms"], "bound_ms": k4_main["bound_ms"],
         "bound_by": ("bytes" if k4_main["bytes_ms"] >= k4_main["ops_ms"]
                      else "operations"),
         "library_ms": None},
    ]
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
