#!/usr/bin/env python3
"""Compare the correlation kernels of two checkouts on one GPU.

    python3 tools/ab_kernels.py PARENT_DIR [CHANGE_DIR]

PARENT_DIR and CHANGE_DIR (default: this checkout) each hold a
``pwcnet_tpu_torch`` package and its ``chip_smoke.py``, e.g. a ``git
archive`` of the parent commit unpacked under ``build/``. Each side runs in
its own process (both packages have one name), in the order parent, change,
change, parent, so that drift of the card shows. A side builds its kernels
and times them (bf16, CUDA events, ``chip_smoke.Timer``): K1 and K6 at the
train step's and the 448x1024 pair's levels, and, where the side has them,
K1p and K6p at the 512x1024 pair's levels under 2 shards. Prints one JSON
line per run; after each side's first run, the registers and spills of
its K1 and K6 variants (nvcc -Xptxas=-v).
"""

import json
import os
import re
import subprocess
import sys

ONE_SIDE = r'''
import json, re, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from pwcnet_tpu_torch.ops.kernels import build
from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
build.build_all()
dev = torch.device("cuda")
timer = cs.Timer()
gen = torch.Generator(device=dev).manual_seed(0)
out = {"root": sys.argv[1], "k1": {}, "k6": {}, "k1p": {}, "k6p": {}}

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
regs = {}
for name in ("cost_volume", "warp_corr"):
    entry = None
    for line in build.BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("spill stores" in line or "Used" in line):
            regs.setdefault(entry, []).append(line.strip())
out["ptxas"] = regs
print(json.dumps(out))
'''


def main() -> int:
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) > 2 else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    for i, root in enumerate((parent, change, change, parent)):
        proc = subprocess.run([sys.executable, "-c", ONE_SIDE, root],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ptxas = res.pop("ptxas")
        print(json.dumps(res), flush=True)
        if i < 2:
            for entry, lines in ptxas.items():
                print(root, re.sub(r"^.*?(warp_corr_fwd|corr_fwd)", r"\1",
                                   entry), " | ".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
