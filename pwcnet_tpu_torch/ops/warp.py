"""Bilinear backward warp (counterpart of ``pwcnet_tpu/ops/warp.py``).

The JAX package lowers the warp to an XLA gather, not a Pallas kernel, so the
port keeps it in plain PyTorch: the four-corner gather of
``warp_bilinear_ref`` with zero padding, per-corner in-bounds masks and the
reference's coverage mask (a warped all-ones tensor, zeroed below 0.9999).

The corners are gathered from an f32 copy of the features: the same values
in the forward, and in the backward the scatter of the gradient into the
features accumulates in f32 and rounds once to their dtype. A bf16 scatter
rounds at every atomic add, in an order that changes from run to run: with
it, K6's bf16 backward and the plain one (which share this warp) differed
in df2 by up to 7.3e-3 of its max, with the f32 gather by at most 1.2e-3
(``chip_smoke.py``, ``k6_grad_check``; NVIDIA H100 80GB HBM3, 700 W).
"""

from __future__ import annotations

import torch


def warp_bilinear(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``feat`` by ``flow``.

    Args:
      feat: (N, H, W, C) features of frame 2.
      flow: (N, H, W, 2) flow in pixels at this resolution; channel 0 is the
        horizontal (x) displacement, channel 1 the vertical (y).

    Returns:
      (N, H, W, C) in ``feat.dtype``: ``out[n, y, x] ~ feat[n, y + v, x + u]``
      bilinearly interpolated in f32, zero outside, with the coverage mask.
    """
    n, h, w, c = feat.shape
    dev = feat.device
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) \
        + flow[..., 0].float()
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) \
        + flow[..., 1].float()
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0).unsqueeze(-1)
    wy = (ys - y0).unsqueeze(-1)
    flat = feat.reshape(n, h * w, c).float()

    def tap(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        g = torch.gather(flat, 1, idx.reshape(n, h * w, 1).expand(-1, -1, c))
        m = inb.float().unsqueeze(-1)
        return g.reshape(n, h, w, c) * m, m

    g00, m00 = tap(y0, x0)
    g01, m01 = tap(y0, x0 + 1)
    g10, m10 = tap(y0 + 1, x0)
    g11, m11 = tap(y0 + 1, x0 + 1)
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx
    out = w00 * g00 + w01 * g01 + w10 * g10 + w11 * g11
    cov = w00 * m00 + w01 * m01 + w10 * m10 + w11 * m11
    return (out * (cov >= 0.9999).float()).to(feat.dtype)
