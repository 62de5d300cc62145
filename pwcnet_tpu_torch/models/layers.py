"""Conv building blocks of the PWC-Net modules (counterpart of
``pwcnet_tpu/models/layers.py``).

Activations inside the modules are NCHW tensors (held channels-last by the
model); parameters are f32 and cast to the activations' dtype at each conv,
as flax ``nn.Conv(dtype=..., param_dtype=float32)`` does. Convs use XLA
SAME padding (``conv_same``) and LeakyReLU slope 0.1.

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
from pwcnet_tpu_torch.parallel.spatial_ops import conv_rows, stem_rows


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


class ConvBlock(nn.Module):
    """3x3 conv (stride, dilation) -> LeakyReLU.

    ``s2b`` is accepted and ignored: in the JAX package it selects an exact
    space-to-batch lowering of the same conv. ``use_norm`` (GroupNorm) is
    not ported yet.
    """

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, use_norm: bool = False,
                 s2b: bool = False):
        super().__init__()
        if use_norm:
            raise NotImplementedError("ConvBlock(use_norm=True) is not "
                                      "ported yet (GroupNorm: ROADMAP A9)")
        self.conv = Conv3x3(cin, features, stride, dilation)

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        return leaky_relu(self.conv(x, mesh))


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
