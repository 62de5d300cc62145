#!/usr/bin/env python3
"""Where the bf16 stem backward's image gradient (K5's d_im) departs from
its plain model, on one GPU.

    python3 tools/k5_dim_tail.py [--out FILE]

For each shape (N, H, W, 3) of ``SHAPES`` the script draws an image and an
output gradient (bf16, seeded), runs ``stem_kernel.stem_bwd_cuda`` (the
kernel), ``stem_kernel.stem_bwd_bf16_ref`` (its arithmetic in plain torch,
the model) and autograd through ``stem_ref`` on f32 copies of the same
bf16 values (the oracle), and prints one JSON line: max|a - b| / max|b| of
d_im for kernel vs model, kernel vs oracle and model vs oracle; the same
per sample (``per_sample_kernel_vs_model``: max over sample n of
|kernel - model|, over the max of |model| in the whole batch); and where
the elements with |kernel - model| > 0.05 max|model| lie: per sample, per
(row, column) parity, and their distance from the border. A fault of the
kernel at large N (an index past a limit, a tile edge) would put those
elements at some samples or positions only; a tail of bf16 rounding
spreads them over all. The lines also go to FILE (default
``build/k5_dim_tail.json``).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pwcnet_tpu_torch.ops.kernels import build  # noqa: E402
from pwcnet_tpu_torch.ops.kernels import stem_kernel as sk  # noqa: E402

# The train step's stem (chip_smoke.STEM_TRAIN), the things-ft and
# kitti-multihost stems, and the latter's H x W at half its N.
SHAPES = [(16, 384, 448, 3), (16, 384, 768, 3), (16, 320, 896, 3),
          (32, 320, 896, 3)]
FAR = 0.05  # |kernel - model| / max|model| counted as far


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("build",
                                                      "k5_dim_tail.json"))
    out_path = parser.parse_args().out
    if not torch.cuda.is_available():
        print("k5_dim_tail: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    params = cs.stem_params(dev, seed=7)
    dt = torch.bfloat16
    f32_params = [(w.to(dt).float(), b.to(dt).float()) for w, b in params]
    rows = []
    for shape in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        n, h, w, _ = shape
        im = torch.rand(shape, device=dev, generator=gen).to(dt)
        g = torch.randn((n, h // 4, w // 4, 32), device=dev,
                        generator=gen).to(dt)
        kernel = sk.stem_bwd_cuda(im, params, g)[0].float()
        model = sk.stem_bwd_bf16_ref(im, params, g)[0].float()
        oracle = cs.k5_plain_grads(im.float(), f32_params, g.float())[0]
        scale = model.abs().max()
        diff = (kernel - model).abs() / scale
        far = torch.nonzero(diff > FAR)
        ys, xs = far[:, 1], far[:, 2]
        border = torch.minimum(torch.minimum(ys, h - 1 - ys),
                               torch.minimum(xs, w - 1 - xs))
        row = {"shape": shape, "nvidia_smi": smi,
               "kernel_vs_model": rel(kernel, model),
               "kernel_vs_oracle": rel(kernel, oracle),
               "model_vs_oracle": rel(model, oracle),
               "per_sample_kernel_vs_model": [
                   round(v, 4) for v in diff.flatten(1).max(1).values.tolist()],
               "share_over_0.01": (diff > 0.01).float().mean().item(),
               "far_count": len(far),
               "far_per_sample": torch.bincount(far[:, 0],
                                                minlength=n).tolist(),
               "far_by_parity": {f"{py}{px}": int(((ys % 2 == py)
                                                   & (xs % 2 == px)).sum())
                                 for py in (0, 1) for px in (0, 1)},
               "far_border_distance_min": (int(border.min()) if len(far)
                                           else None),
               "far_within_4_of_border": int((border < 4).sum())}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del kernel, model, oracle, diff
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
