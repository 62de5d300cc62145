"""Streaming inference through GMA (``gma``): one client calls
``predict_flow(model, im1, im2)`` on consecutive frames (t, t + 1) of one
seeded sequence, batch 1, in a closed loop, as ``drivers/stream.py`` and
``drivers/stream_allpairs.py`` do.

The run and the fp8 and stale controls are ``stream_allpairs``' own code:
a private copy of that module, loaded afresh, whose reference module is
``flowbench/reference/gma.py`` (its ``forward``, ``full_res`` and
``param_shapes`` in place of published RAFT's) and whose weights and
kernel shapes are this file's. The weights follow ``stream_allpairs``' law,
with ``gamma`` 1 + |its draw of std 0.01|; a traced run's view carries K8's
shape (one a pair), K9's (one an iteration) and K11's (its map one a pair,
its aggregation one an iteration). The ``no_global`` control puts the
reference with ``gamma`` 0 in the answer's place.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from flowbench import frames, harness
from flowbench.drivers import stream, stream_allpairs
from flowbench.reference import gma
from flowbench.reference.ops import F32, bf16_emulations

GAMMA = "aggregator.gamma"

_base = harness.load_module(harness.BENCH / "drivers" / "stream_allpairs.py")
_base.raft_allpairs = gma
_law = _base.seeded_weights
reference_flow = _base.reference_flow


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``stream_allpairs.seeded_weights``' law over GMA's parameters, drawn
    on ``device`` in one call, and ``gamma`` 1 + |its draw|: the released
    init, 0, would take the aggregation out of every answer."""
    out = _law(cfg, seed, device)
    out[GAMMA] = 1.0 + out[GAMMA].abs()
    return out


def kernel_calls(cfg: dict, n: int, hw) -> dict:
    """K8's, K9's and K11's shapes in one forward of n pairs at the padded
    hw; K11's is (n, h, w, dim_head, iterations): one map and as many
    aggregations as iterations."""
    calls = stream_allpairs.kernel_calls(cfg, n, hw)
    calls["attention"] = [(n, hw[0] // 8, hw[1] // 8, cfg["dim_head"],
                           cfg["iters"])]
    return calls


_base.seeded_weights = seeded_weights
_base.kernel_calls = kernel_calls
run = _base.run


def control(cell: harness.Cell, seed: int, device, variant: str) -> dict:
    """The compared number with the reference in the program's place: in
    fp8 (``"fp8"``), the next pair's (``"stale"``), or with ``gamma`` 0
    (``"no_global"``), over as many seeded pairs as a run samples."""
    if variant != "no_global":
        return _base.control(cell, seed, device, variant)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    harness.reference_precision()
    weights = seeded_weights(cfg, seed, dev)
    off = dict(weights, **{GAMMA: torch.zeros_like(weights[GAMMA])})
    ring = frames.make(tr, seed, dev)
    rng = np.random.default_rng((seed, 8))
    picks = rng.choice(len(ring) - 2, tr["sample_answers"], replace=False)

    def ref(w, j, prec=F32):
        return reference_flow(cfg, w, ring[j], ring[j + 1], dev, prec)

    return stream.compare([(ref(off, j), ref(weights, j)) for j in picks],
                          [[ref(weights, j, p) for j in picks]
                           for p in bf16_emulations(seed, dev)])
