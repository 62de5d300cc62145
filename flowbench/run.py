"""Run one cell of the port's benchmark once.

    python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``flowbench/``
and the port (``pwcnet_tpu_torch``). Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, with the device's busy and window seconds and a
breakdown), the device, and last the numbers compared with their limits,
which also end standard error. Exits non-zero, printing no result, when
there is no CUDA device or too few, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card(torch) -> dict:
    dev = torch.device("cuda", 0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "power_limit": limit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    sys.path.insert(0, str(ROOT))
    from flowbench import harness
    # Every cache a library may write stays inside the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(harness.CACHE / sub))
    import torch

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"flowbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    out = harness.driver(cell).run(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"flowbench: the process loaded {bad}", file=sys.stderr)
        return 3
    device = _card(torch)
    device["memory_peak_bytes"] = out.memory_peak_bytes
    metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                           "unit": m["unit"]} for m in cell.end_to_end}
    brk = None
    if args.trace:
        view = out.view
        device["busy_s"] = harness.union_us(view.kernels + view.copies,
                                            view.stretch) / 1e6
        device["window_s"] = view.stretch_us / 1e6
        metrics = harness.read_per_layer(cell, view)
        brk = harness.breakdown(view)
        out.notes.append(
            f"traced stretch: {view.items} items in "
            f"{view.stretch_us / 1e6:.4f} s, "
            f"{view.items / view.stretch_us * 1e6:.3f}/s; the window's "
            f"{view.window_items / view.window_s:.3f}/s")
    for line in out.notes:
        print(f"flowbench: {line}", file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(cell, out, metrics, device, brk), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
