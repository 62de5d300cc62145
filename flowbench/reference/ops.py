"""Plain building blocks of the reference: XLA SAME convolution, LeakyReLU,
the local correlation, the bilinear backward warp, bilinear resizes, and
the precision of the arithmetic (float32, or the fp8 control)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """Quantize-dequantize through an fp8 type, one scale per tensor (its
    largest magnitude to the type's largest finite value)."""
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8(torch.autograd.Function):
    """fp8 training's rounding of a multiply's input: E4M3 forward, and the
    gradient that flows back through it in E5M2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def _bf16(x: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Round to bfloat16 and back: to nearest, or stochastically with
    ``gen`` (a uniform 16-bit draw added below the kept bits, then cut)."""
    if gen is None:
        return x.to(torch.bfloat16).to(torch.float32)
    bits = x.contiguous().view(torch.int32)
    r = torch.randint(0, 1 << 16, bits.shape, generator=gen,
                      device=x.device, dtype=torch.int32)
    return ((bits + r) & -65536).view(torch.float32)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gen):
        ctx.gen = gen
        return _bf16(x, gen)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g, ctx.gen), None


class Precision:
    """``q(x)`` is what a multiply's input (an activation or a weight)
    becomes: ``x`` itself in float32; rounded to bfloat16 and back, to
    nearest or, with ``generator``, stochastically (the arithmetic that the
    configurations state, which the reference emulates to measure how far
    bfloat16 rounding alone moves a seed's result); or, for the control,
    the fp8 step below bfloat16: E4M3 with one scale per tensor, the
    gradient through it in E5M2."""

    def __init__(self, name: str = "float32",
                 generator: Optional[torch.Generator] = None):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name, self.generator = name, generator

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name == "fp8":
            return _Fp8.apply(x)
        return _Bf16.apply(x, self.generator)


def bf16_emulations(seed: int, device, n: int = 3):
    """The reference's bfloat16 emulations of a run: to nearest, then
    ``n - 1`` stochastic roundings drawn from the seed."""
    return [Precision("bfloat16")] + [
        Precision("bfloat16", torch.Generator(device=device).manual_seed(
            (seed * 31 + r) % 2 ** 63)) for r in range(1, n)]


F32 = Precision("float32")


def lrelu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU, slope 0.1, gradient 1 at exactly 0."""
    return torch.where(x >= 0, x, 0.1 * x)


def _same(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         prec: Precision = F32, stride: int = 1,
         dilation: int = 1) -> torch.Tensor:
    """NCHW convolution with XLA's SAME padding (``total // 2`` before, the
    rest after), OIHW weight, f32 accumulation."""
    kh, kw = w.shape[-2:]
    top, bottom = _same(x.shape[-2], kh, stride, dilation)
    left, right = _same(x.shape[-1], kw, stride, dilation)
    x = F.pad(prec.q(x), (left, right, top, bottom))
    return F.conv2d(x, prec.q(w), b, stride=stride, dilation=dilation)


def correlation(f1: torch.Tensor, f2: torch.Tensor, d: int,
                prec: Precision = F32) -> torch.Tensor:
    """NHWC local cost volume: channel (dy + d) * (2d + 1) + (dx + d) is the
    mean over C of f1[y, x] * f2[y + dy, x + dx], zero outside the image."""
    _, h, w, _ = f1.shape
    a = prec.q(f1)
    bp = F.pad(prec.q(f2), (0, 0, d, d, d, d))
    return torch.stack([(a * bp[:, dy:dy + h, dx:dx + w]).mean(-1)
                        for dy in range(2 * d + 1)
                        for dx in range(2 * d + 1)], -1)


def warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of NHWC ``feat`` by the pixel ``flow`` (channel 0 = x):
    bilinear over the four corners, zero outside, and zero wherever the
    in-image corners' weights sum below 0.9999."""
    n, h, w, c = feat.shape
    xs = torch.arange(w, dtype=torch.float32, device=feat.device).view(
        1, 1, w) + flow[..., 0]
    ys = torch.arange(h, dtype=torch.float32, device=feat.device).view(
        1, h, 1) + flow[..., 1]
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - x0, ys - y0
    flat = feat.reshape(n, h * w, c)
    out = torch.zeros_like(feat)
    cover = torch.zeros_like(xs)
    for yi, xi, wt in ((y0, x0, (1 - wy) * (1 - wx)),
                       (y0, x0 + 1, (1 - wy) * wx),
                       (y0 + 1, x0, wy * (1 - wx)),
                       (y0 + 1, x0 + 1, wy * wx)):
        inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                  & (yi <= h - 1)).float()
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        g = torch.gather(flat, 1, idx.reshape(n, h * w, 1).expand(-1, -1, c))
        out = out + (wt * inside)[..., None] * g.reshape(n, h, w, c)
        cover = cover + wt * inside
    return out * (cover >= 0.9999).float()[..., None]


def upsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear upsampling with half-pixel centres."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="bilinear", align_corners=False
                         ).permute(0, 2, 3, 1)


def downsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC or NHW antialiased bilinear shrink (``jax.image.resize``'s
    bilinear: the triangle kernel widened by the scale)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = x.unsqueeze(-1) if x.dim() == 3 else x
    y = F.interpolate(y.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    return y[..., 0] if x.dim() == 3 else y


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pad_to(img: torch.Tensor, div: int) -> torch.Tensor:
    """Zero-pad NHWC images at the bottom and right to multiples of
    ``div``."""
    h, w = img.shape[1:3]
    ph, pw = -(-h // div) * div - h, -(-w // div) * div - w
    return F.pad(img, (0, 0, 0, pw, 0, ph))
