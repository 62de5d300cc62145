#!/usr/bin/env python3
"""Time every launch plan of the bf16 banded kernels K6, K2 and K3 on one GPU.

    python3 tools/tune_band.py [--out FILE]

For each level of the train step (``chip_smoke.CORR_TRAIN``; K6 at the
warped levels 5..2) and of a 448x1024 pair (``K6_MAIN``, K6 only), for K6
at the 512x1024 pair's S = 2 shard levels (``K6P[2]``, through the
unsharded entry at the shard's shape), and for K2 and K3 also at the
levels of the things-ft (8 x 384x768) and kitti-multihost (16 x 320x896)
crops (``chip_smoke.level_shapes``), the script runs the kernel under
every plan that its explicit-plan entry takes (K6: tile x dy groups,
``pwc_warp_corr_fwd_tiled``; K2 and K3: tile x channel slice,
``pwc_cost_volume_bwd_tiled``), holds each result against the plain
version within ``chip_smoke.TOL`` and times it with ``chip_smoke.Timer``
(CUDA events). It prints one JSON line per kernel and level: the ms of
each plan, the fastest, and the plan that ``pick_wc_band`` /
``pick_bwd_band`` take; the whole table, with the registers and spills of
the two libraries' kernels, goes to FILE (default
``build/tune_band.json``). These tables set the two plan functions.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pwcnet_tpu_torch.ops.cost_volume import cost_volume_bwd_ref  # noqa: E402
from pwcnet_tpu_torch.ops.kernels import build  # noqa: E402
from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck  # noqa
from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk  # noqa
from pwcnet_tpu_torch.ops.warp_corr import warp_corr_ref  # noqa: E402

K6_TILES = ("2x32", "1x32", "1x16", "4x16", "8x16")
K6_GROUPS = (1, 3, 9)
BWD_TILES = ("2x32", "1x32", "1x16", "4x16")
BWD_SLICES = (32, 64)
_P, _I = ctypes.c_void_p, ctypes.c_int


def k6_fn():
    fn = build.load_library("warp_corr").pwc_warp_corr_fwd_tiled
    fn.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def bwd_fn():
    fn = build.load_library("cost_volume_bwd").pwc_cost_volume_bwd_tiled
    fn.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    fn.restype = _I
    return fn


def run(fn, out, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("build",
                                                      "tune_band.json"))
    out_path = parser.parse_args().out
    if not torch.cuda.is_available():
        print("tune_band: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOGS.items()
             if name in ("warp_corr", "cost_volume_bwd")}
    dev = torch.device("cuda")
    timer = cs.Timer()
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.bfloat16
    tol = cs.TOL[("corr", dtype)]
    rows = []
    k6, kb = k6_fn(), bwd_fn()
    with torch.inference_mode():
        k6_sets = (("train", cs.K6_TRAIN), ("main_448x1024", cs.K6_MAIN),
                   ("k6p_s2_shape", cs.K6P[2]))
        for name, shapes in k6_sets:
            for shape in shapes:
                n, h, w, c = shape
                f1, f2 = (torch.randn(shape, device=dev,
                                      generator=gen).to(dtype)
                          for _ in range(2))
                flow = cs.k6_flow(shape, "normal4", dev, gen)
                want = warp_corr_ref(f1, f2, flow)
                o = torch.empty_like(want)
                ms = {}
                for ti, tile in enumerate(K6_TILES):
                    for dg in K6_GROUPS:
                        def call():
                            return run(k6, o, f1.data_ptr(), f2.data_ptr(),
                                       flow.data_ptr(), o.data_ptr(), n, h,
                                       w, c, 4, ti, dg)
                        rel = cs.rel_err(call(), want)[1]
                        if not rel <= tol:
                            raise AssertionError(f"K6 {tile}/{dg} at "
                                                 f"{shape}: {rel}")
                        ms[f"{tile}/{dg}"] = timer(call)
                row = {"kernel": "k6", "set": name, "shape": shape,
                       "ms": ms, "best": min(ms, key=ms.get),
                       "plan": "%s/%d" % wk.band_plan(n, h, w)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    # K2 (which 1: f2 staged, df1 out) and K3 (which 2: f1 staged, df2
    # out); their plain version is autograd: outside inference mode.
    bwd_sets = (("train", cs.CORR_TRAIN),
                ("things_ft", cs.level_shapes(8, (384, 768))),
                ("kitti_multihost", cs.level_shapes(16, (320, 896))))
    for set_name, shape in ((k, sh) for k, shapes in bwd_sets
                            for sh in shapes):
        n, h, w, c = shape
        f1, f2 = (torch.randn(shape, device=dev, generator=gen).to(dtype)
                  for _ in range(2))
        g = torch.randn(shape[:3] + (81,), device=dev,
                        generator=gen).to(dtype)
        grads = cost_volume_bwd_ref(g, f1, f2, 4)
        for which, feat in ((1, f2), (2, f1)):
            want = grads[which - 1]
            o = torch.empty_like(want)
            ms = {}
            for ti, tile in enumerate(BWD_TILES):
                for cb in BWD_SLICES:
                    def call():
                        return run(kb, o, g.data_ptr(), feat.data_ptr(),
                                   o.data_ptr(), n, h, w, c, 4, which, ti,
                                   cb // 32)
                    rel = cs.rel_err(call(), want)[1]
                    if not rel <= cs.TOL[("corr_bwd", dtype)]:
                        raise AssertionError(f"K{which + 1} {tile}/{cb} at "
                                             f"{shape}: {rel}")
                    ms[f"{tile}/{cb}"] = timer(call)
            row = {"kernel": f"k{which + 1}", "set": set_name,
                   "shape": shape,
                   "ms": ms, "best": min(ms, key=ms.get),
                   "plan": "%s/%d" % ck.bwd_band_plan(which, n, h, w, c)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows, "ptxas": ptxas}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
