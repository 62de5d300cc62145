"""The yardstick's arithmetic: the card's published peaks, each kernel's
operations and bytes from its shapes (frozen from the port's
``chip_smoke.py``: each input byte counted once and each output byte
once, whatever the kernel reads again), the shapes of each kernel's calls
in a cell, and the model's FLOPs per pair counted from the reference's
layers at the cell's shapes."""

from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor cores
BF16_BYTES = 2

Shape = Tuple[int, int, int, int]


def bound_ms(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the bf16 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def corr_cost(shape: Shape) -> Tuple[float, float]:
    """K1: read f1 and f2, write 81 taps a pixel; 81 products of C."""
    n, h, w, c = shape
    return ((2 * n * h * w * c + n * h * w * 81) * BF16_BYTES,
            2.0 * n * h * w * 81 * c)


def corr_bwd_cost(shape: Shape) -> Tuple[float, float]:
    """One of K2/K3: read g and one feature map, write one gradient."""
    n, h, w, c = shape
    return ((n * h * w * 81 + 2 * n * h * w * c) * BF16_BYTES,
            2.0 * n * h * w * 81 * c)


def stem_cost(shape: Shape) -> Tuple[float, float]:
    """K4: read the image and the f32 weights, write level 2; the four
    convs' products."""
    n, h, w, _ = shape
    l1, l2 = (h // 2) * (w // 2), (h // 4) * (w // 4)
    macs = n * (l1 * 16 * 27 + l1 * 16 * 144 + l2 * 32 * 144 + l2 * 32 * 288)
    n_w = 27 * 16 + 144 * 16 + 144 * 32 + 288 * 32 + 16 + 16 + 32 + 32
    return (n * h * w * 3 + n * l2 * 32) * BF16_BYTES + n_w * 4, 2.0 * macs


def stem_bwd_cost(shape: Shape, with_im: bool = False
                  ) -> Tuple[float, float]:
    """K5: read the image and the output gradient (write d_im with
    ``with_im``); the forward again, one product per layer for dW and one
    for the input gradient (conv1's only with d_im)."""
    n, h, w, _ = shape
    fwd_bytes, fwd_flops = stem_cost(shape)
    conv1 = 2.0 * n * (h // 2) * (w // 2) * 16 * 27
    flops = 3 * fwd_flops - (0 if with_im else conv1)
    return fwd_bytes + (n * h * w * 3 * BF16_BYTES if with_im else 0), flops


def padded_hw(cfg: dict, hw: Tuple[int, int]) -> Tuple[int, int]:
    div = cfg["pad_divisor"]
    return (-(-hw[0] // div) * div, -(-hw[1] // div) * div)


def corr_shapes(cfg: dict, n: int, hw: Tuple[int, int]) -> List[Shape]:
    """The correlation's calls of one forward of n pairs at the padded
    ``hw``: PWC-Net's decoder levels, or RAFT's two scales per
    iteration."""
    h, w = hw
    if cfg["family"] == "pwcnet":
        ch = cfg["pyramid_channels"]
        return [(n, h >> lv, w >> lv, ch[lv - 1])
                for lv in range(cfg["num_levels"],
                                cfg["num_levels"] - cfg["output_level"] - 1,
                                -1)]
    c = cfg["feature_dim"]
    return [(n, h // 8, w // 8, c), (n, h // 16, w // 16, c)] * cfg["iters"]


def stem_shapes(cfg: dict, n: int, hw: Tuple[int, int]) -> List[Shape]:
    """The stem's calls of one forward: both frames of n pairs at once
    (PWC-Net; RAFT has no stem)."""
    return [(2 * n, hw[0], hw[1], 3)] if cfg["family"] == "pwcnet" else []


def model_flops(cfg: dict, n: int, hw: Tuple[int, int], train: bool) -> float:
    """Multiply-add FLOPs (2 per MAC) of the reference's forward (and, with
    ``train``, its backward to the parameters) at n pairs of the padded
    ``hw``: the convolutions as ``torch.utils.flop_counter`` counts them
    on meta tensors, plus the correlation's 2 x 81 x C per pixel and
    call (three such products per call in training: K1, K2, K3)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from flowbench.reference import pwcnet, raft
    mod = pwcnet if cfg["family"] == "pwcnet" else raft
    params = {k: torch.empty(s, device="meta", requires_grad=train)
              for k, s in mod.param_shapes(cfg).items()}
    im = torch.empty(n, hw[0], hw[1], 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            flows = mod.forward(params, cfg, im, im)
            if train:
                sum(f.sum() for f in flows).backward()
    corr = sum(corr_cost(s)[1] for s in corr_shapes(cfg, n, hw))
    return float(counter.get_total_flops()) + corr * (3 if train else 1)

