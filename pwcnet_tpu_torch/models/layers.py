"""Conv building blocks of the PWC-Net modules (counterpart of
``pwcnet_tpu/models/layers.py``).

Activations inside the modules are NCHW tensors (held channels-last by the
model); parameters are f32 and cast to the activations' dtype at each conv,
as flax ``nn.Conv(dtype=..., param_dtype=float32)`` does. Convs use XLA
SAME padding (``conv_same``) and LeakyReLU slope 0.1. ``ConvBlock(
use_norm=True)`` puts flax's ``nn.GroupNorm`` between the conv and the
LeakyReLU (``GroupNorm``).

Every ``forward`` takes an optional ``mesh``
(``pwcnet_tpu_torch.parallel.mesh.SpatialMesh``): with one, the input is
this rank's rows of an H-sharded activation and each conv exchanges the
rows it reads across shard edges (``parallel/spatial_ops.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from pwcnet_tpu_torch.ops.conv import conv_same, leaky_relu  # noqa: F401
from pwcnet_tpu_torch.ops.kernels.stem_kernel import stem, stem_ref
from pwcnet_tpu_torch.parallel.spatial_ops import (all_reduce_sum,
                                                   conv_rows, stem_rows)

# flax ``nn.GroupNorm``'s default epsilon (torch's is 1e-5).
NORM_EPS = 1e-6


class Conv(nn.Module):
    """(kh, kw) conv with bias, XLA SAME padding; OIHW f32 weight."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int] = (3, 3),
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.zeros(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        if mesh is not None:
            return conv_rows(x, self.weight, self.bias, self.stride,
                             self.dilation, mesh)
        return conv_same(x, self.weight, self.bias, self.stride,
                         self.dilation)


class Conv3x3(Conv):
    """3x3 conv with bias, XLA SAME padding; OIHW f32 weight."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__(cin, cout, (3, 3), stride, dilation)


def norm_groups(features: int) -> int:
    """The JAX ConvBlock's group count: the first of 8, 4, 2, 1 that
    divides ``features``."""
    return next(g for g in (8, 4, 2, 1) if features % g == 0)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=norm_groups(C))`` with its defaults,
    as the JAX ConvBlock runs it: statistics over (H, W, the group's
    channels) per image, in f32, the variance as E[x^2] - E[x]^2 clipped
    at 0, ``eps`` 1e-6, then ``* weight + bias`` (flax ``scale``, ``bias``;
    f32, shape (C,)), cast back to the input's dtype.

    Under a ``mesh`` the input is this rank's rows, and the sums are taken
    over the whole image (an all-reduce over the mesh), as GSPMD does for
    the JAX model under its mesh.
    """

    def __init__(self, features: int):
        super().__init__()
        self.groups = norm_groups(features)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        n, c, h, w = x.shape
        per = c // self.groups
        xf = x.float()
        sums = torch.stack([xf.sum((2, 3)), (xf * xf).sum((2, 3))])
        count = per * h * w
        if mesh is not None:
            sums = all_reduce_sum(sums, mesh)
            count *= mesh.size
        sums = sums.view(2, n, self.groups, per).sum(-1) / count
        mean, var = sums[0], (sums[1] - sums[0] * sums[0]).clamp_min(0.0)
        mean = mean.repeat_interleave(per, 1)
        mul = torch.rsqrt(var + NORM_EPS).repeat_interleave(per, 1) \
            * self.weight
        y = (xf - mean[..., None, None]) * mul[..., None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """3x3 conv (stride, dilation) -> [GroupNorm] -> LeakyReLU.

    ``s2b`` is accepted and ignored: in the JAX package it selects an exact
    space-to-batch lowering of the same conv.
    """

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, use_norm: bool = False,
                 s2b: bool = False):
        super().__init__()
        self.conv = Conv3x3(cin, features, stride, dilation)
        self.norm = GroupNorm(features) if use_norm else None

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        x = self.conv(x, mesh)
        if self.norm is not None:
            x = self.norm(x, mesh)
        return leaky_relu(x)


class StemConvs(nn.Module):
    """Pyramid levels 1-2: conv s2 -> conv -> conv s2 -> conv, LeakyReLU 0.1
    after each. NHWC image in, NHWC level-2 features out.

    ``backend`` is the JAX module's: ``"auto"`` and ``"pallas"`` run the
    stem kernels on a CUDA tensor (``csrc/stem.cu``: K4 forward, K5
    backward, through ``StemFunction``) and the plain chain ``stem_ref`` on
    a CPU tensor; ``"lax"`` runs ``stem_ref`` on any device. The plain
    chain's gradients are autograd's.
    """

    def __init__(self, c1: int, c2: int, backend: str = "auto"):
        super().__init__()
        if backend not in ("auto", "pallas", "lax"):
            raise ValueError(f"stem backend must be 'auto', 'pallas' or "
                             f"'lax', got {backend!r}")
        self.backend = backend
        self.conv1 = Conv3x3(3, c1, stride=2)
        self.conv2 = Conv3x3(c1, c1)
        self.conv3 = Conv3x3(c1, c2, stride=2)
        self.conv4 = Conv3x3(c2, c2)

    def params(self):
        return [(c.weight, c.bias) for c in
                (self.conv1, self.conv2, self.conv3, self.conv4)]

    def _run(self, im: torch.Tensor) -> torch.Tensor:
        if self.backend == "lax":
            return stem_ref(im, self.params())
        return stem(im.contiguous(), self.params())

    def forward(self, im: torch.Tensor, mesh=None) -> torch.Tensor:
        if mesh is not None:
            return stem_rows(im, self._run, mesh)
        return self._run(im)


class ConvStack(nn.Module):
    """A straight stack of ConvBlocks with the given widths."""

    def __init__(self, cin: int, features: Sequence[int],
                 use_norm: bool = False):
        super().__init__()
        widths = [cin, *features]
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, use_norm=use_norm)
            for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, mesh)
        return x
