"""The yardstick's arithmetic for published RAFT (``raft_allpairs``): the
bytes and operations of the all-pairs pyramid (K8) and of its lookup (K9)
from their shapes, each input byte counted once and each output byte once,
a kernel's share of its roofline from a trace, and the model's FLOPs per
pair counted from the reference's layers. The shapes of a forward's calls
are the driver's (``drivers/stream_allpairs.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

from flowbench import costs, harness

# (n, h, w, C, levels): the features of both frames at 1/8 resolution.
PyramidShape = Tuple[int, int, int, int, int]
# (n, h, w, levels, radius): the lookup of one iteration.
LookupShape = Tuple[int, int, int, int, int]
PATTERNS = {"pyramid": r"\bcorr_pyramid_(bf16|f32)\b",
            "lookup": r"\bcorr_lookup_kernel\b"}


def pyramid_cost(shape: PyramidShape) -> Tuple[float, float]:
    """K8: read f1 and f2, write every level (h >> l) x (w >> l) of each of
    the h w source pixels; 2 P^2 C operations a pair (P = h w)."""
    n, h, w, c, levels = shape
    p = h * w
    out = n * p * sum((h >> lv) * (w >> lv) for lv in range(levels))
    return ((2 * n * p * c + out) * costs.BF16_BYTES,
            2.0 * n * p * p * c)


def lookup_cost(shape: LookupShape) -> Tuple[float, float]:
    """K9: read the coordinates (two f32 a pixel) and each pixel's
    (2r + 2)^2 patch of each level, clipped to the level's size; write
    L (2r + 1)^2 outputs a pixel; four weighted corners (8 operations) an
    output."""
    n, h, w, levels, r = shape
    px = n * h * w
    s = 2 * r + 2
    patch = sum(min(s, h >> lv) * min(s, w >> lv) for lv in range(levels))
    outputs = px * levels * (2 * r + 1) ** 2
    return (px * 2 * 4 + (px * patch + outputs) * costs.BF16_BYTES,
            8.0 * outputs)


COSTS = {"pyramid": pyramid_cost, "lookup": lookup_cost}


def roofline(view: "harness.TraceView", group: str) -> Optional[float]:
    """100 x the summed bound time of the stretch's calls of ``group``
    (``view.calls[group]``: shapes) over the profiler's time of its
    kernels, one kernel a call (``harness.kernel_time_us`` raises on any
    other count). None where the cell makes no such call."""
    calls = view.calls.get(group, [])
    if not calls:
        return None
    bound = view.items * sum(costs.bound_ms(*COSTS[group](s)) for s in calls)
    us = harness.kernel_time_us(view, PATTERNS[group],
                                view.items * len(calls))
    return 100.0 * bound / (us / 1e3)


def model_flops(cfg: dict, n: int, hw: Tuple[int, int]) -> float:
    """Multiply-add FLOPs (2 per MAC) of the reference's inference forward
    at n pairs of the padded ``hw``, as ``torch.utils.flop_counter`` counts
    them on meta tensors: the convolutions and the volume's matmul (the
    lookup's bilinear sampling and the pools are not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from flowbench.reference import raft_allpairs
    params = {k: torch.empty(s, device="meta")
              for k, s in raft_allpairs.param_shapes(cfg).items()}
    im = torch.empty(n, hw[0], hw[1], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        raft_allpairs.forward(params, cfg, im, im)
    return float(counter.get_total_flops())
