#!/usr/bin/env python3
"""Compare the kernels of two checkouts on one GPU.

    python3 tools/ab_kernels.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) each hold a
``pwcnet_tpu_torch`` package and its ``chip_smoke.py``, e.g. a ``git
archive`` of the parent commit unpacked under ``build/``. Each side runs in
its own process (both packages have one name), in the order parent, change,
change, parent, so that drift of the card shows. A side builds its kernels
and times them (bf16, CUDA events, ``chip_smoke.Timer``): K1 and K6 at the
train step's and the 448x1024 pair's levels (K1 per level and summed per
set: ``k1_train_sum``, ``k1_main_sum``, ``k6_train_sum``,
``k6_main_sum``); K2 and K3 alone at the train step's levels, per level
(``k2``, ``k3``: the parent's and the change's time at each level of the
same run) and summed (``k2_train_sum``, ``k3_train_sum``); the stem
forward K4 and backward K5 (``need_im=False``, the train step's form) on
the train step's 16 frames of 384x448; and, where the side has them, K1p and K6p at the 512x1024
pair's levels under 2 shards (``k1p_sum``, ``k6p_sum``) and K7 at each
conv of ``K7_CHAIN``. Prints one JSON line per run (``k7_sum``: K7 summed
over the chain); after each side's first run, the registers, spills and shared
memory of every kernel entry (nvcc -Xptxas=-v), demangled where
``c++filt`` is found. Those first runs compile into a temporary directory,
so that ptxas runs; the others use the checkout's build cache.
"""

import json
import os
import re
import subprocess
import sys

ONE_SIDE = r'''
import json, re, shutil, sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from pwcnet_tpu_torch.ops.kernels import build
from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk
fresh = sys.argv[2] == "fresh"
if fresh:  # compile anew (ptxas lines), beside the checkout's cache
    build.BUILD_DIR = Path(tempfile.mkdtemp())
build.build_all()
dev = torch.device("cuda")
timer = cs.Timer()
gen = torch.Generator(device=dev).manual_seed(0)
out = {"root": sys.argv[1], "k1": {}, "k6": {}, "k1p": {}, "k6p": {},
       "k7": {}, "k2": {}, "k3": {}}

def rnd(shape):
    return torch.randn(shape, device=dev, generator=gen).bfloat16()

with torch.inference_mode():
    for shape in cs.CORR_TRAIN + cs.K1_MAIN:
        f1, f2 = rnd(shape), rnd(shape)
        out["k1"][str(shape)] = timer(lambda: ck.cost_volume_cuda(f1, f2))
        if shape in cs.K6_TRAIN + cs.K6_MAIN:
            flow = cs.k6_flow(shape, "normal4", dev, gen)
            out["k6"][str(shape)] = timer(
                lambda: wk.warp_corr_cuda(f1, f2, flow))
    for shape in cs.CORR_TRAIN:  # K2 and K3 alone, as autograd asks
        f1, f2, g = rnd(shape), rnd(shape), rnd(shape[:3] + (81,))
        for key, need in (("k2", (True, False)), ("k3", (False, True))):
            out[key][str(shape)] = timer(lambda: ck.cost_volume_bwd_cuda(
                g, f1, f2, need_f1=need[0], need_f2=need[1]))
    for shape in getattr(cs, "K1P", {}).get(2, []):
        n, t, w, c = shape
        f1, f2e = rnd(shape), rnd((n, t + 8, w, c))
        out["k1p"][str(shape)] = timer(
            lambda: ck.cost_volume_prepadded_cuda(f1, f2e))
        if shape in cs.K6P[2]:
            halo = cs.k6p_halo(t)
            f2h = rnd((n, t + 2 * halo, w, c))
            flow = cs.k6p_flow(shape, "normal4", halo, dev, gen)
            out["k6p"][str(shape)] = timer(lambda: wk.warp_corr_prepadded_cuda(
                f1, f2h, flow, t, 2 * t, halo))
params = cs.stem_params(dev, seed=2)
im = rnd(cs.STEM_TRAIN)
g = rnd((cs.STEM_TRAIN[0], cs.STEM_TRAIN[1] // 4, cs.STEM_TRAIN[2] // 4, 32))
out["k5"] = timer(lambda: sk.stem_bwd_cuda(im, params, g, need_im=False))
with torch.inference_mode():
    out["k4"] = timer(lambda: sk.stem_cuda(im, params))
    if hasattr(cs, "K7_CHAIN"):
        from pwcnet_tpu_torch.ops.kernels import conv_folded_kernel as fk
        for shape, co, stride in cs.K7_CHAIN:
            x = rnd(shape)
            w = 0.3 * torch.randn((3, 3, shape[-1], co), device=dev,
                                  generator=gen)
            b = 0.1 * torch.randn((co,), device=dev, generator=gen)
            out["k7"][str((shape, co, stride))] = timer(
                lambda: fk.conv_folded_cuda(x, w, b, stride, 0.1))
        out["k7_sum"] = sum(out["k7"].values())
# Sums per set of levels (the per-level times are in "k1", "k6", "k2",
# "k3").
for key, kernel, shapes in (("k1_train_sum", "k1", cs.CORR_TRAIN),
                            ("k1_main_sum", "k1", cs.K1_MAIN),
                            ("k6_train_sum", "k6", cs.K6_TRAIN),
                            ("k6_main_sum", "k6", cs.K6_MAIN),
                            ("k2_train_sum", "k2", cs.CORR_TRAIN),
                            ("k3_train_sum", "k3", cs.CORR_TRAIN)):
    out[key] = sum(out[kernel][str(s)] for s in shapes)
out["k1p_sum"] = sum(out["k1p"].values())
out["k6p_sum"] = sum(out["k6p"].values())
regs = {}
for name in build.kernel_names():
    entry = None
    for line in build.BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("spill stores" in line or "Used" in line):
            regs.setdefault(entry, []).append(line.strip())
out["ptxas"] = regs
if fresh:
    shutil.rmtree(build.BUILD_DIR)
print(json.dumps(out))
'''


def main() -> int:
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    for i, root in enumerate((parent, change, change, parent)):
        proc = subprocess.run([sys.executable, "-c", ONE_SIDE, root,
                               "fresh" if i < 2 else "cached"],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ptxas = res.pop("ptxas")
        print(json.dumps(res), flush=True)
        if i < 2:
            for entry, lines in ptxas.items():
                print(root, demangle(entry), " | ".join(lines))
    return 0


def demangle(name: str) -> str:
    """The kernel's C++ name (without its arguments) where c++filt is
    found, else the symbol."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except OSError:
        return name
    out = re.sub(r"^void |\(anonymous namespace\)::", "", out)
    return out.split("(")[0] or name


if __name__ == "__main__":
    sys.exit(main())
