#!/usr/bin/env python3
"""How far two eager one-process f32 ``train()`` runs of the same config
lie apart on one GPU, and which parameters hold the difference.

    python3 tools/eager_spread.py [--steps N] [--out FILE]

Each variant trains ``chip_smoke.f32_config`` (synthetic-proof in f32,
batch 8 at 384x448, a checkpoint every step) for N steps (default 3,
``chip_smoke.SPATIAL_TRAIN_STEPS``), eagerly, twice, each run in a fresh
process of its own (``run_ranks`` of one rank), as ``chip_smoke.py``'s
reference for ``spatial_train`` and ``grid_2x2`` runs:

- ``default``: the optimizer as ``make_optimizer`` makes it (torch's
  Adam: a float rate, its bias corrections on the host);
- ``capturable``: the same, made ``capturable`` first (``make_capturable``:
  a device rate, the bias corrections in f32 on the device), the form a
  captured step takes;
- ``deterministic``: ``default`` under deterministic algorithms
  (``chip_smoke.DETERMINISTIC``, as ``chip_smoke.py``'s references run).

Then the same config on two gloo ranks as spatial replicas
(``parallel.spatial=2``, ``chip_smoke.py``'s ``spatial_train``), once
with ``default`` and once with ``deterministic`` steps.

Per step it prints the share of parameter entries within rtol 2e-4, atol
2e-6 of the other run (``chip_smoke.params_share``, the rule of the
DDP and spatial gates), the largest difference, and the tensors holding
the most entries outside that rule; the variants' first runs against
``deterministic``'s, and the replicas' rank 0 against it.
First it prints the cuBLAS workspace each process takes, with and without
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``chip_smoke.py`` sets it for its
whole process): the caching allocator's bytes held after the first
matmul, less its output. Every run here has that setting, as
``chip_smoke.py``'s references do. One JSON line per result, also
written to FILE (default ``build/eager_spread.json``).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pwcnet_tpu_torch.train.schedule import make_capturable  # noqa: E402
from pwcnet_tpu_torch.train.step import make_train_step  # noqa: E402

VARIANTS = {
    "default": {},
    "capturable": {"pwcnet_tpu_torch.train.loop.make_train_step":
                   "tools.eager_spread.capturable_train_step"},
    "deterministic": cs.DETERMINISTIC,
}
WORKSPACE_PROBE = """
import torch
a = torch.randn(1024, 1024, device="cuda")
torch.cuda.synchronize()
before = torch.cuda.memory_allocated()
c = a @ a
torch.cuda.synchronize()
print(torch.cuda.memory_allocated() - before - c.numel() * c.element_size())
"""


def capturable_train_step(model, optimizer, *args, **kwargs):
    """``make_train_step`` after ``make_capturable`` (the rank's patch)."""
    make_capturable(optimizer)
    return make_train_step(model, optimizer, *args, **kwargs)


def train_runs(name: str, patch: dict, steps: int, times: int = 2,
               ranks: int = 1, **parallel) -> list:
    """``times`` fresh-process runs of ``ranks`` ranks: per run, step ->
    parameters (CPU, rank 0's)."""
    from pwcnet_tpu_torch.parallel.launch import run_ranks
    runs = []
    for i in range(times):
        cfg = cs.f32_config(f"spread_{name}_{i}", **parallel)
        job_dir = os.path.join(cs.RUN_DIR, f"spread_{name}_{i}_job")
        run_ranks(ranks, dict(backend="gloo", device="cuda",
                              allow_tf32=False,
                              tasks=[dict(kind="train", cfg=cfg,
                                          max_steps=steps, digest=True,
                                          capture=False, patch=patch)]),
                  job_dir, timeout=600)
        shutil.rmtree(job_dir)
        runs.append({s: cs.checkpoint_params(cfg, s)
                     for s in range(1, steps + 1)})
        shutil.rmtree(cfg.train.log_dir)
    return runs


def compare(got: dict, want: dict) -> dict:
    """``params_share`` and the tensors with the most entries outside its
    rule."""
    share, worst = cs.params_share(got, want)
    outside = {}
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs()
        n = int((d > 2e-6 + 2e-4 * w.double().abs()).sum())
        if n:
            outside[k] = [n, w.numel()]
    top = sorted(outside.items(), key=lambda kv: -kv[1][0])[:6]
    return {"share": share, "max_abs_diff": worst,
            "entries_outside": sum(v[0] for v in outside.values()),
            "tensors_outside": len(outside), "top": top}


def workspace_bytes(env_value) -> int:
    env = dict(os.environ)
    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    if env_value:
        env["CUBLAS_WORKSPACE_CONFIG"] = env_value
    out = subprocess.run([sys.executable, "-c", WORKSPACE_PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return int(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=cs.SPATIAL_TRAIN_STEPS)
    parser.add_argument("--out", default=os.path.join("build",
                                                      "eager_spread.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("eager_spread: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"cublas_workspace_bytes": {
        "unset": workspace_bytes(None),
        ":4096:8": workspace_bytes(":4096:8")},
        "torch": torch.__version__, "nvidia_smi": smi})
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    from pwcnet_tpu_torch.ops.kernels import build
    build.build_all()
    runs = {name: train_runs(name, patch, args.steps)
            for name, patch in VARIANTS.items()}
    replicas = {name: train_runs(f"replicas_{name}", VARIANTS[name],
                                 args.steps, times=1, ranks=2, data=1,
                                 spatial=2)[0]
                for name in ("default", "deterministic")}
    ref = runs["deterministic"][0]
    for step in range(1, args.steps + 1):
        row = {"step": step, "nvidia_smi": smi}
        for name, (a, b) in runs.items():
            row[f"{name}_twice"] = compare(b[step], a[step])
        row["capturable_vs_default"] = compare(runs["capturable"][0][step],
                                               runs["default"][0][step])
        for name in ("default", "capturable"):
            row[f"{name}_vs_deterministic"] = compare(runs[name][0][step],
                                                      ref[step])
        for name, r in replicas.items():
            row[f"replicas_{name}_vs_deterministic"] = compare(r[step],
                                                               ref[step])
        emit(row)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for obj in lines:
            f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
