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

``warp_ext_corners_ref`` / ``warp_ext_ref`` are the spatially sharded form
(JAX ``parallel/halo.py:_warp_ext_corners`` / ``_warp_ext``): the warp of a
halo-extended shard, masks tested in global rows, corners gathered from a
4-corner table over a 1-pixel zero ring with the halo-bound clamp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    # A NaN flow gathers at index 0 and keeps NaN weights, so the output
    # is NaN there (as JAX's clamped gather gives), not an index fault.
    x0 = torch.floor(xs).nan_to_num(nan=0.0)
    y0 = torch.floor(ys).nan_to_num(nan=0.0)
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


def warp_ext_corners_ref(f2e: torch.Tensor, flow: torch.Tensor, row0: int,
                         h_global: int, halo: int, d: int):
    """Bilinear corners of the halo-extended frame-2 shard.

    ``f2e`` (N, t + 2*halo, W, C) holds global rows ``[row0 - halo, row0 +
    t + halo)``; ``flow`` (N, t + 2d, W, 2) is the pixel flow at global rows
    ``[row0 - d, row0 + t + d)``. Returns ``g`` (N, t + 2d, W, 4C), the four
    corner features (y0x0, y0x1, y1x0, y1x1) of each output row, and ``wm``
    (N, 4, t + 2d, W) f32, bilinear weight x global in-bounds mask x
    coverage mask, so that ``warp_ext_ref`` is their blend. The corner rows
    come from a table over a 1-pixel zero ring, clamped to it: a sample
    beyond the exchanged rows reads the ring and the farthest exchanged
    row, exactly as the JAX island does."""
    n, te, w, c = f2e.shape
    t_out = flow.shape[1]
    dev = f2e.device
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    ys = (torch.arange(t_out, device=dev, dtype=torch.float32).view(
        1, t_out, 1) - d + float(row0)) + fy
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) + fx
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0

    def inb(v, hi):
        return ((v >= 0) & (v <= hi)).float()

    inb_x0, inb_x1 = inb(x0, w - 1), inb(x0 + 1, w - 1)
    inb_y0, inb_y1 = inb(y0, h_global - 1), inb(y0 + 1, h_global - 1)
    m = (inb_y0 * inb_x0, inb_y0 * inb_x1, inb_y1 * inb_x0, inb_y1 * inb_x1)

    fp = F.pad(f2e, (0, 0, 1, 1, 1, 1))
    hp, wp = te + 2, w + 2
    tx = torch.cat([fp, torch.roll(fp, -1, 2)], -1)
    txy = torch.cat([tx, torch.roll(tx, -1, 1)], -1)
    flat = txy.reshape(n, hp * wp, 4 * c)
    j0 = y0 - float(row0) + halo  # f2e row of y0
    yc = torch.clamp(j0 + 1, 0, hp - 2).long()  # the halo-bound clamp
    xc = torch.clamp(x0 + 1, 0, wp - 2).long()
    idx = (yc * wp + xc).reshape(n, t_out * w, 1).expand(-1, -1, 4 * c)
    g = torch.gather(flat, 1, idx).reshape(n, t_out, w, 4 * c)

    ww = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    cov = ww[0] * m[0] + ww[1] * m[1] + ww[2] * m[2] + ww[3] * m[3]
    mask = (cov >= 0.9999).float()
    wm = torch.stack([(wi * mi) * mask for wi, mi in zip(ww, m)], 1)
    return g, wm


def blend_corners(g: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """f32 ``sum_a wm[:, a] * g[..., a]`` in the order a = 0..3."""
    c = g.shape[-1] // 4
    gf = g.float()
    out = wm[:, 0, ..., None] * gf[..., :c]
    for a in range(1, 4):
        out = out + wm[:, a, ..., None] * gf[..., a * c:(a + 1) * c]
    return out


def warp_ext_ref(f2e: torch.Tensor, flow: torch.Tensor, row0: int,
                 h_global: int, halo: int, d: int) -> torch.Tensor:
    """Warp the halo-extended shard: rows [-d, t + d) of the output frame,
    (N, t + 2d, W, C) in ``f2e.dtype`` (see ``warp_ext_corners_ref``)."""
    g, wm = warp_ext_corners_ref(f2e, flow, row0, h_global, halo, d)
    return blend_corners(g, wm).to(f2e.dtype)
