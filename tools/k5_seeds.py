#!/usr/bin/env python3
"""K5 (the stem backward kernel) at the train step's stem shape over many
input draws, on one GPU: how often ``chip_smoke.py``'s ``k5_check`` rules
fail there, and whether the kernel or the rule is at fault.

    python3 tools/k5_seeds.py [--seeds N] [--out FILE]

For seed s in 0..N-1 (default 16) the image and the output gradient are
drawn at ``chip_smoke.STEM_TRAIN`` (16, 384, 448, 3) from a device
generator seeded s, with ``k5_check``'s stem parameters
(``stem_params(seed=2)``), and ``chip_smoke.k5_case`` runs once per dtype:

- f32 with the float64 witness and the perturbation floor (``f64``,
  ``floor_rule``): the kernel's and the plain f32 version's errors against
  float64, the plain version's own change under a 1e-6 input perturbation,
  and, where the kernel is still further than that, float64 with one
  LeakyReLU slope swapped. ``plain_rule_ok`` is the rule ``k5_check``
  applied at this shape before (1e-4 of the plain version's max);
- bf16 as ``k5_check`` runs it: against the f32 oracle (within 3x the
  plain bf16 autograd's error, or 5e-3) and against ``stem_bwd_bf16_ref``,
  the kernel's own arithmetic (``stem_kernel.BF16_MODEL_TOL``).

One JSON line per seed and dtype, then a summary line; also written to
FILE (default ``build/k5_seeds.json``).
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

KEEP = ("rel_err", "tol", "kernel_rel_err_vs_f64", "plain_rel_err_vs_f64",
        "near_zero_f64", "floor_1e-6", "swapped_slope", "plain_bf16_rel",
        "rel_err_vs_bf16_model", "model_tol")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=16)
    parser.add_argument("--out", default=os.path.join("build",
                                                      "k5_seeds.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k5_seeds: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    params = cs.stem_params(dev, seed=2)
    lines, fails = [], {"float32": {"plain_rule": [], "new_rule": []},
                        "bfloat16": {"oracle": [], "model": []}}
    for seed in range(args.seeds):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(seed)
            f32 = dtype == torch.float32
            try:
                cs.k5_case(None, dev, gen, params, dtype, cs.STEM_TRAIN,
                           phase="k5_seeds", f64=f32, floor_rule=f32)
                ok = True
            except AssertionError:
                ok = False
            row = cs.RESULTS[-1]
            out = {"seed": seed, "dtype": str(dtype), "ok": ok,
                   **{k: row[k] for k in KEEP if k in row}}
            name = str(dtype).split(".")[1]
            if f32:
                out["plain_rule_ok"] = max(row["rel_err"]) <= cs.TOL[
                    ("stem_bwd", dtype)]
                if not out["plain_rule_ok"]:
                    fails[name]["plain_rule"].append(seed)
                if not ok:
                    fails[name]["new_rule"].append(seed)
            else:
                if any(r > t for r, t in zip(row["rel_err"], row["tol"])):
                    fails[name]["oracle"].append(seed)
                if any(r > t for r, t in zip(
                        row["rel_err_vs_bf16_model"],
                        [row["model_tol"][0]] + [row["model_tol"][1]] * 8)):
                    fails[name]["model"].append(seed)
            lines.append(out)
            print(json.dumps(out), flush=True)
    summary = {"summary": fails, "seeds": args.seeds,
               "shape": cs.STEM_TRAIN, "nvidia_smi": smi}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
