"""Readings for the limits of a cell's comparison, in one process: the
program's compared numbers over many seeds (each a whole run of the
driver with a short window: set-up, window, reference), and the control's
over a few (the reference in the program's place, in fp8, and the other
faults that the cell's ``drivers/<kind>.py:control`` knows).

    python3 flowbench/calibrate.py --workload <cell> --seeds 1 2 ...
        --controls fp8 stale --control-seeds 7 8 9 --seconds 2
        --out <readings>.json

Runs on the card only; prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    from flowbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    drv = harness.driver(cell)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = drv.run(cell, seed, args.seconds, False, "cuda", t0)
        rows.append({"kind": "program", "seed": seed, **out.readings,
                     "e2e": out.end_to_end, "notes": out.notes})
        print(json.dumps(rows[-1]), flush=True)
    for variant in args.controls:
        for seed in args.control_seeds:
            got = drv.control(cell, seed, "cuda", variant)
            rows.append({"kind": variant, "seed": seed, **got})
            print(json.dumps(rows[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
