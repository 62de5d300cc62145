"""Convolution with XLA ``"SAME"`` padding, and the models' LeakyReLU.

XLA's SAME pads ``total = max((ceil(in/s) - 1) * s + (k - 1) * dil + 1 - in,
0)`` with ``total // 2`` before and the rest after. For a 3x3 stride-2 conv
on an even size that is 0 before and 1 after, where
``nn.Conv2d(padding=1)`` would pad 1 on each side and shift every output by
half a pixel. A 7x7 stride-2 conv on an even size pads (2, 3), a 1x1
stride-2 conv pads nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _same_pads(size: int, k: int, stride: int, dilation: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              stride: int = 1, dilation: int = 1) -> torch.Tensor:
    """NCHW conv with XLA SAME padding. ``w`` is OIHW; weights and bias are
    cast to ``x.dtype`` first, as flax ``nn.Conv(dtype=...)`` does."""
    kh, kw = w.shape[-2:]
    top, bottom = _same_pads(x.shape[-2], kh, stride, dilation)
    left, right = _same_pads(x.shape[-1], kw, stride, dilation)
    if top == bottom and left == right:
        return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                        stride=stride, padding=(top, left), dilation=dilation)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, dilation=dilation)
