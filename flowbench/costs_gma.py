"""The yardstick's arithmetic for GMA (``gma``): the bytes and operations
of its global attention (K11) from its shape, whatever implements it, its
share of its roofline from a trace, and the model's FLOPs per pair counted
from the reference's layers. K8 and K9 are ``costs_allpairs``'; the shapes
of a forward's calls are the driver's (``drivers/stream_gma.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

from flowbench import costs, harness

# (n, h, w, d, iters): the 1/8 grid, the head's width, the iterations.
AttentionShape = Tuple[int, int, int, int, int]
PATTERN = r"\bglobal_attention_(map|aggregate)_(bf16|f32)\b"


def attention_cost(shape: AttentionShape) -> Tuple[float, float]:
    """K11 over a forward, counted as the operation needs it and not as a
    kernel does it: read q and k once and v in every iteration, write A v
    in every iteration (P = h w values of d each); the scores q k^T and the
    sums A v, 2 P^2 d each, once and once an iteration. Whether the map is
    stored or recomputed moves nothing here."""
    n, h, w, d, iters = shape
    p = h * w
    return ((2 * p * d + 2 * iters * p * d) * n * costs.BF16_BYTES,
            2.0 * n * p * p * d * (1 + iters))


def roofline(view: "harness.TraceView") -> Optional[float]:
    """100 x the summed bound time of the stretch's K11 calls over the
    profiler's time of the kernels matching ``PATTERN``, 1 + iters a call
    (``harness.kernel_time_us`` raises on any other count). None where the
    cell makes no such call."""
    calls = view.calls.get("attention", [])
    if not calls:
        return None
    bound = view.items * sum(costs.bound_ms(*attention_cost(s))
                             for s in calls)
    us = harness.kernel_time_us(view, PATTERN,
                                view.items * sum(1 + s[4] for s in calls))
    return 100.0 * bound / (us / 1e3)


def model_flops(cfg: dict, n: int, hw: Tuple[int, int]) -> float:
    """Multiply-add FLOPs (2 per MAC) of the reference's inference forward
    at n pairs of the padded ``hw``, as ``torch.utils.flop_counter`` counts
    them on meta tensors: the convolutions, the volume's matmul and the
    attention's (the map and every aggregation; the lookup's bilinear
    sampling, the pools and the softmax are not counted). Every iteration
    runs the same layers at the same shapes, so the forwards of 1 and 2
    iterations give the count of any number (a 32-iteration count takes
    seconds of host time in a traced run)."""
    one, two = (_counted(dict(cfg, iters=i), n, hw) for i in (1, 2))
    return one + (cfg["iters"] - 1) * (two - one)


def _counted(cfg: dict, n: int, hw: Tuple[int, int]) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from flowbench.reference import gma
    params = {k: torch.empty(s, device="meta")
              for k, s in gma.param_shapes(cfg).items()}
    im = torch.empty(n, hw[0], hw[1], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        gma.forward(params, cfg, im, im)
    return float(counter.get_total_flops())
