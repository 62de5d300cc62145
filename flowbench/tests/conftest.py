"""Shared helpers of the benchmark's CPU tests: cells cut to a size the
CPU runs in seconds (the drivers, the comparison and the faults are the
same code as on the card)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cell(name: str):
    """A cell of the manifest."""
    from flowbench import harness
    return harness.resolve(name)


def tiny(cell):
    """``cell`` with its traffic cut to a CPU-sized shape."""
    tr = dict(cell.traffic)
    if tr["driver"] == "stream":
        tr.update(frame_hw=[60, 120], ring_frames=5, sample_answers=3)
    else:
        tr.update(global_batch=2, crop_hw=[64, 64])
    cell.traffic = tr
    return cell
