"""The yardstick's arithmetic for GMFlow with refinement (``gmflow``): the
bytes and operations of its window attention (K12) from each call's
shape, whatever implements it, their share of the roofline from a trace,
and the model's FLOPs per pair counted from the reference's layers. The
shapes of a forward's calls are the driver's
(``drivers/stream_gmflow.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

from flowbench import costs, harness

# (images, h, w, splits, shifted, value width): a call over S x S windows
# of (h / S) x (w / S) tokens of every image; q and k 128 wide.
AttentionShape = Tuple[int, int, int, int, bool, int]
DIM = 128
PATTERN = r"\bwindow_attention_(bf16|f32)\b"


def attention_cost(shape: AttentionShape) -> Tuple[float, float]:
    """One call, counted as the operation needs it and not as a kernel does
    it: read q, k and v and write the output once (bf16 at width 128; the
    2-wide values and outputs in f32); every window's whole q k^T (2 L^2
    128) and P v (2 L^2 vw), L tokens a window. The mask changes no count:
    no product is skipped."""
    b, h, w, splits, _, vw = shape
    p = b * h * w
    vbytes = costs.BF16_BYTES if vw == DIM else 4
    tokens = (h // splits) * (w // splits)
    windows = b * splits * splits
    return (p * (2 * DIM * costs.BF16_BYTES + 2 * vw * vbytes),
            2.0 * windows * tokens * tokens * (DIM + vw))


def roofline(view: "harness.TraceView") -> Optional[float]:
    """100 x the summed bound time of the stretch's K12 calls over the
    profiler's time of the kernels matching ``PATTERN``, one a call
    (``harness.kernel_time_us`` raises on any other count). None where the
    cell makes no such call."""
    calls = view.calls.get("window_attention", [])
    if not calls:
        return None
    bound = view.items * sum(costs.bound_ms(*attention_cost(s))
                             for s in calls)
    us = harness.kernel_time_us(view, PATTERN, view.items * len(calls))
    return 100.0 * bound / (us / 1e3)


def model_flops(cfg: dict, n: int, hw: Tuple[int, int]) -> float:
    """Multiply-add FLOPs (2 per MAC) of the reference's inference forward
    at n pairs of the padded ``hw``, as ``torch.utils.flop_counter``
    counts them on meta tensors: the convolutions, the linears and every
    matrix product of the attention and the matching (the softmaxes, the
    norms, the warp and the local matching's sampling are not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from flowbench.reference import gmflow
    params = {k: torch.empty(s, device="meta")
              for k, s in gmflow.param_shapes(cfg).items()}
    im = torch.empty(n, hw[0], hw[1], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        gmflow.forward(params, cfg, im, im)
    return float(counter.get_total_flops())
