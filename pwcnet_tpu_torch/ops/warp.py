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

``flow_warp`` is GMFlow's warp: the same blend without the coverage mask.

``warp_table`` / ``warp_bilinear_from_table`` (JAX ``ops/warp.py:138``,
``:175``) split the warp for a caller that warps the same features by many
flows (RAFT, once per iteration): the 4-corner table over a 1-pixel zero
ring is built once, and each warp is one gather of 4C-wide rows from it.

``warp_ext_corners_ref`` / ``warp_ext_ref`` are the spatially sharded form
(JAX ``parallel/halo.py:_warp_ext_corners`` / ``_warp_ext``): the warp of a
halo-extended shard, masks tested in global rows, corners gathered from the
same table with the halo-bound clamp.

A NaN flow gathers at index 0 and keeps NaN weights everywhere here, so the
output is NaN there (as JAX's clamped gather gives), not an index fault.
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
    out, cov = _blend(feat, flow)
    return (out * (cov >= 0.9999).float()).to(feat.dtype)


def flow_warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """GMFlow's ``flow_warp`` (the released ``gmflow/geometry.py``):
    ``warp_bilinear`` without the coverage mask, i.e. ``F.grid_sample`` of
    ``feat`` at the pixel grid plus ``flow`` with ``align_corners=True`` and
    zeros outside. NHWC in and out, blended in f32, in ``feat.dtype``."""
    return _blend(feat, flow)[0].to(feat.dtype)


def _blend(feat: torch.Tensor, flow: torch.Tensor):
    """The f32 bilinear blend of the in-image corners and its coverage (the
    in-image corners' summed weights)."""
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
    return out, cov


def warp_table(feat: torch.Tensor) -> torch.Tensor:
    """The warp's 4-corner gather table of ``feat`` (N, H, W, C): (N, (H+2) *
    (W+2), 4C) in ``feat.dtype``, whose channel block k holds the (dy, dx) =
    (k // 2, k % 2) neighbour of each pixel of ``feat`` padded with a
    1-pixel zero ring. The rolls never wrap into a gathered row, because
    gathers clamp rows and columns to at most the padded size - 2."""
    n, h, w, c = feat.shape
    fp = F.pad(feat, (0, 0, 1, 1, 1, 1))
    tx = torch.cat([fp, torch.roll(fp, -1, 2)], -1)
    txy = torch.cat([tx, torch.roll(tx, -1, 1)], -1)
    return txy.reshape(n, (h + 2) * (w + 2), 4 * c)


def _gather_table(flat: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                  hp: int, wp: int) -> torch.Tensor:
    """Rows of ``flat`` (a ``warp_table``) at the ring-padded corner (y0 + 1,
    x0 + 1), clamped into the table; a NaN coordinate takes index 0, as
    JAX's conversion of NaN to an integer gives. y0, x0 (N, ...) f32 ->
    (N, ..., 4C)."""
    yc = torch.clamp(y0 + 1, 0, hp - 2).nan_to_num(nan=0.0).long()
    xc = torch.clamp(x0 + 1, 0, wp - 2).nan_to_num(nan=0.0).long()
    n, c4 = flat.shape[0], flat.shape[-1]
    idx = (yc * wp + xc).reshape(n, -1, 1).expand(-1, -1, c4)
    return torch.gather(flat, 1, idx).reshape(*yc.shape, c4)


def warp_bilinear_from_table(flat: torch.Tensor, feat_shape,
                             flow: torch.Tensor, dtype=None) -> torch.Tensor:
    """``warp_bilinear`` of the features whose ``warp_table`` is ``flat``
    (``feat_shape`` = their (N, H, W, C)), by ``flow`` (N, H, W, 2) in pixels:
    (N, H, W, C) in ``dtype`` (default ``flat.dtype``), blended in f32. Build
    the table from an f32 copy of bf16 features, as ``warp_bilinear`` gathers
    from one: the gather's backward then sums in f32."""
    n, h, w, c = feat_shape
    dtype = flat.dtype if dtype is None else dtype
    dev = flat.device
    xs = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w) \
        + flow[..., 0].float()
    ys = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1) \
        + flow[..., 1].float()
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = (xs - x0).unsqueeze(-1), (ys - y0).unsqueeze(-1)
    g = _gather_table(flat, y0, x0, h + 2, w + 2).float()

    def inb(v, hi):
        return ((v >= 0) & (v <= hi)).float().unsqueeze(-1)

    m = (inb(y0, h - 1) * inb(x0, w - 1), inb(y0, h - 1) * inb(x0 + 1, w - 1),
         inb(y0 + 1, h - 1) * inb(x0, w - 1),
         inb(y0 + 1, h - 1) * inb(x0 + 1, w - 1))
    ww = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    out = sum(wi * g[..., k * c:(k + 1) * c] * mi
              for k, (wi, mi) in enumerate(zip(ww, m)))
    cov = sum(wi * mi for wi, mi in zip(ww, m))
    return (out * (cov >= 0.9999).float()).to(dtype)


def warp_ext_corners_ref(f2e: torch.Tensor, flow: torch.Tensor, row0: int,
                         h_global: int, halo: int, d: int):
    """Bilinear corners of the halo-extended frame-2 shard.

    ``f2e`` (N, t + 2*halo, W, C) holds global rows ``[row0 - halo, row0 +
    t + halo)``; ``flow`` (N, t + 2d, W, 2) is the pixel flow at global rows
    ``[row0 - d, row0 + t + d)``. Returns ``g`` (N, t + 2d, W, 4C), the four
    corner features (y0x0, y0x1, y1x0, y1x1) of each output row, and ``wm``
    (N, 4, t + 2d, W) f32, bilinear weight x global in-bounds mask x
    coverage mask, so that ``warp_ext_ref`` is their blend. The corner rows
    come from ``warp_table``, clamped to it: a sample beyond the exchanged
    rows reads the ring and the farthest exchanged row, exactly as the JAX
    island does."""
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

    # f2e's row of y0 (the halo-bound clamp is the table's).
    g = _gather_table(warp_table(f2e), y0 - float(row0) + halo, x0, te + 2,
                      w + 2)

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
