"""3x3 SAME conv + bias (+ LeakyReLU) for small channel counts, in the
width-folded layout (counterpart of ``pwcnet_tpu/ops/pallas/conv_kernel.py``).

``conv2d_folded`` keeps the JAX entry's contract: ``x`` is NHWC, or the
folded output ``(N, H, W/G, G*C)`` of a previous call with fold ``in_g``;
the weights are HWIO; the result comes back folded by ``G = pick_g(W_out,
Co)``. On a contiguous NHWC tensor folding is a view, so the kernel (K7,
``csrc/conv_folded.cu``) is a direct small-channel conv on NHWC; the TPU's
lane folding does not carry over. On CPU tensors it is ``conv_ref``, the
JAX package's oracle; on CUDA tensors K7, whose backward is autograd of
``conv_ref``. It is its own entry point: no model path calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

from pwcnet_tpu_torch.ops.conv import conv_same
from pwcnet_tpu_torch.ops.kernels.conv_folded_kernel import conv_folded_fn

_LANES = 128
_SUBLANES = 8


def conv_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
             stride: int = 1, dilation: int = 1,
             slope: Optional[float] = None) -> torch.Tensor:
    """NHWC SAME conv (HWIO weights) + bias (+ LeakyReLU when ``slope``),
    each step in x's dtype, as the JAX ``conv_ref`` computes it."""
    out = conv_same(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                    stride, dilation).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(x.dtype)
    if slope is not None:
        out = torch.where(out >= 0, out,
                          torch.tensor(slope, dtype=x.dtype) * out)
    return out


def fold_w(x: torch.Tensor, g: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W/G, G*C)."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w // g, g * c)


def unfold_w(x: torch.Tensor, g: int) -> torch.Tensor:
    """(N, H, W/G, G*C) -> (N, H, W, C)."""
    n, h, wg, gc = x.shape
    return x.reshape(n, h, wg * g, gc // g)


def pick_g(w_out: int, co: int) -> int:
    """The JAX entry's fold: the largest power of two G <= 16 with G*Co <=
    128 and a folded width that is a multiple of 8."""
    g = 1
    while (g < 16 and co * g * 2 <= _LANES and w_out % (g * 2) == 0
           and (w_out // (g * 2)) % _SUBLANES == 0):
        g *= 2
    return g


def conv2d_folded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  stride: int = 1, slope: Optional[float] = None,
                  in_g: int = 1) -> torch.Tensor:
    """SAME 3x3 conv + bias (+ LeakyReLU) for small channel counts.

    ``x`` is NHWC when ``in_g == 1``, else the folded output of a previous
    call with fold ``in_g``. Returns (N, H_out, W_out/G, G*Co), G =
    ``pick_g(W_out, Co)``; ``unfold_w`` recovers NHWC."""
    if in_g > 1:
        x = unfold_w(x, in_g)
    co = w.shape[-1]
    wo = -(-x.shape[2] // stride)
    if x.device.type == "cpu":
        out = conv_ref(x, w, b, stride=stride, slope=slope)
    else:
        out = conv_folded_fn(x.contiguous(), w, b, stride, slope)
    return fold_w(out, pick_g(wo, co))
