"""RAFT as published (Teed and Deng, ECCV 2020, arXiv:2003.12039; the
released ``core/raft.py``, ``corr.py``, ``extractor.py``, ``update.py``),
with its all-pairs correlation pyramid. A port-only model: the JAX package
runs only the local-correlation RAFT (``models/raft.py``).

- ``fnet``: BasicEncoder with instance norm (eps 1e-5, no affine) on both
  frames as one batch: 7x7 stride-2 conv 3->64, norm, ReLU; residual
  blocks of 64, 64 (stride 1), 96 (stride 2), 96, 128 (stride 2), 128; a
  1x1 conv to ``feat_dim``. A block is ``relu(x' + relu(n2(c2(relu(n1(c1(
  x)))))))``, ``x'`` a 1x1 conv of the block's stride plus norm where the
  stride is 2. Stride-2 convs pad ``k // 2`` on both sides, as PyTorch's
  do (not XLA SAME).
- ``cnet``: the same encoder with batch norm in its eval form (running
  statistics as buffers) on frame 1, split into hidden (tanh) and context
  (ReLU).
- Each norm of both encoders, with the ReLU and the block's join after it,
  is one ``ops/encoder_norm.py:encoder_norm`` (K10 on the GPU).
- The pyramid: the all-pairs correlation of the 1/8 features over
  sqrt(C) and its ``avg_pool2d`` levels (``ops/corr_pyramid.py``; K8 on
  the GPU), built once; each iteration looks up a window of radius r in
  every level at the detached coordinates (``ops/corr_lookup.py``; K9).
- Per iteration: the motion encoder (1x1 324->256, 3x3 256->192 on the
  correlation; 7x7 2->128, 3x3 128->64 on the flow; 3x3 256->126, the flow
  appended), ``models/raft.py``'s separable ConvGRU on hidden + (context,
  motion), the flow head (3x3 hidden->256, ReLU, 3x3 256->2); at the end
  the mask head (3x3 hidden->256, ReLU, 1x1 256->576, x 0.25) and
  ``models/raft.py``'s convex upsampling x8.
- Inputs are ``2 * image - 1`` (images in [0, 1]); the coordinates are
  detached at the start of every iteration, and the flow is the
  coordinates less the grid.

Precision: convs in the model's dtype with f32 weights (``Conv``), norms
in f32; the coordinates, the flow and the upsampling's softmax in f32; the
pyramid in the model's dtype, summed and pooled in f32.

Public layout is the port's: images (N, H, W, 3), flows (N, H, W, 2) in
pixels, channel 0 = x; inside, NCHW activations in channels-last memory.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.init import init_params
from pwcnet_tpu_torch.models.layers import Conv
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc, _resolve_device
from pwcnet_tpu_torch.models.raft import RAFT, SepConvGRU, convex_upsample
from pwcnet_tpu_torch.ops.corr_lookup import corr_lookup, corr_lookup_ref
from pwcnet_tpu_torch.ops.corr_pyramid import corr_pyramid, corr_pyramid_ref
from pwcnet_tpu_torch.ops.encoder_norm import (INSTANCE, NORM_EPS, Norm,
                                               encoder_norm)
from pwcnet_tpu_torch.ops.kernels import build
from pwcnet_tpu_torch.ops.kernels.corr_pyramid_kernel import check_levels

DIV = 8


class PaddedConv(Conv):
    """A conv with PyTorch's symmetric padding ``k // 2`` (the published
    stride-2 convs; for odd kernels at stride 1 it equals XLA SAME);
    ``bias=False`` leaves the bias out (GMFlow's 3x3 and 7x7 convs)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride)
        if not bias:
            self.bias = None

    def forward(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        kh, kw = self.weight.shape[-2:]
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        padding=(kh // 2, kw // 2))


class InstanceNorm(nn.Module):
    """``nn.InstanceNorm2d(affine=False)``: its statistics are the input's,
    so it has no terms of its own (``ops/encoder_norm.py`` applies it)."""

    def terms(self) -> Norm:
        return INSTANCE


class FrozenBatchNorm(nn.Module):
    """``nn.BatchNorm2d`` in its eval form, in f32: affine ``weight`` and
    ``bias``, the running statistics as buffers (no ``num_batches_tracked``,
    since they never update)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def terms(self) -> Norm:
        """``(mul, add)``: the norm is ``x * mul + add`` in f32."""
        mul = torch.rsqrt(self.running_var + NORM_EPS) * self.weight
        return mul, self.bias - self.running_mean * mul


def _norm(kind: str, features: int) -> nn.Module:
    return InstanceNorm() if kind == "instance" else FrozenBatchNorm(features)


class ResidualBlock(nn.Module):
    """The published block: ``relu(x' + relu(norm2(conv2(relu(norm1(
    conv1(x)))))))``, ``x' = norm3(down(x))`` (a 1x1 conv with bias) where
    the stride or the width changes, else ``x``. Each norm with what
    follows it is one ``encoder_norm`` (K10 on the GPU). ``bias=False``
    drops the 3x3 convs' biases (GMFlow's ``CNNEncoder``); RAFT's have
    them."""

    def __init__(self, cin: int, planes: int, norm: str, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        self.conv1 = PaddedConv(cin, planes, (3, 3), stride, bias=bias)
        self.conv2 = PaddedConv(planes, planes, (3, 3), bias=bias)
        self.norm1, self.norm2 = _norm(norm, planes), _norm(norm, planes)
        self.down = self.norm3 = None
        if stride != 1 or cin != planes:
            self.down = PaddedConv(cin, planes, (1, 1), stride)
            self.norm3 = _norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = encoder_norm(self.conv1(x), self.norm1.terms())
        if self.down is None:
            return encoder_norm(self.conv2(y), self.norm2.terms(), x)
        return encoder_norm(self.conv2(y), self.norm2.terms(), self.down(x),
                            self.norm3.terms())


class BasicEncoder(nn.Module):
    """RAFT's BasicEncoder to 1/8 resolution and ``dim`` channels (NCHW).
    ``strides`` are the three stages' (64, 96 and 128 wide) and ``bias``
    the 7x7 and 3x3 convs': GMFlow's ``CNNEncoder`` is ``strides=(1, 2,
    1)`` (1/4 resolution), ``bias=False``."""

    def __init__(self, dim: int, norm: str, strides=(1, 2, 2),
                 bias: bool = True):
        super().__init__()
        self.conv1 = PaddedConv(3, 64, (7, 7), 2, bias=bias)
        self.norm1 = _norm(norm, 64)
        blocks = []
        cin = 64
        for planes, stride in zip((64, 96, 128), strides):
            blocks += [ResidualBlock(cin, planes, norm, stride, bias),
                       ResidualBlock(planes, planes, norm, 1, bias)]
            cin = planes
        self.blocks = nn.ModuleList(blocks)
        self.conv2 = Conv(128, dim, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = encoder_norm(self.conv1(x), self.norm1.terms())
        for block in self.blocks:
            x = block(x)
        return self.conv2(x)


class MotionEncoder(nn.Module):
    """RAFT's BasicMotionEncoder: 126 channels of correlation and flow
    features, then the flow itself (in the correlation's dtype)."""

    def __init__(self, ncorr: int):
        super().__init__()
        self.convc1 = Conv(ncorr, 256, (1, 1))
        self.convc2 = Conv(256, 192, (3, 3))
        self.convf1 = Conv(2, 128, (7, 7))
        self.convf2 = Conv(128, 64, (3, 3))
        self.conv = Conv(256, 126, (3, 3))

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        flow = flow.to(corr.dtype)
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], 1))), flow], 1)


class RAFTAllPairs(nn.Module):
    """Published RAFT, for inference and training.

    ``corr_backend``: ``"pallas"`` (default) runs K8 and K9 on CUDA tensors
    (their plain versions on CPU tensors; backward through autograd of the
    plain versions), ``"lax"`` their plain versions on any device. It
    chooses only the correlation's kernels: the encoders' norms take K10 on
    any CUDA tensor whatever the backend, so a ``"lax"`` model on the card
    is not all plain PyTorch. ``device=None`` means the GPU, and raises when there is none. Conv
    weights are drawn from ``generator`` (seed 0 when None) with the flax
    defaults' law, as the port's other models; norms start at the identity.

    A subclass widens the GRU's input with ``GRU_MOTION`` (the motion
    features' channels, 128 here) and adds to it through ``_aggregation``
    (``models/gma.py``).
    """

    GRU_MOTION = 128
    # The hand kernels a forward on the card launches (K10; K8 and K9 under
    # "pallas"), compiled side by side when the model is built there; a
    # subclass adds its own.
    KERNELS = ("encoder_norm",)
    CORR_KERNELS = ("corr_pyramid", "corr_lookup")

    def __init__(self, num_iters: int = 12, corr_radius: int = 4,
                 corr_levels: int = 4, feat_dim: int = 256,
                 hidden: int = 128, context: int = 128,
                 corr_backend: str = "pallas",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = _resolve_device(device)
        if corr_backend not in ("lax", "pallas"):
            raise ValueError(f"unknown correlation backend {corr_backend!r} "
                             "(RAFTAllPairs takes 'lax' or 'pallas')")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.num_iters, self.corr_radius = num_iters, corr_radius
        self.corr_levels, self.hidden = corr_levels, hidden
        self.corr_backend, self.dtype = corr_backend, dtype
        self.fnet = BasicEncoder(feat_dim, "instance")
        self.cnet = BasicEncoder(hidden + context, "batch")
        self.menc = MotionEncoder(corr_levels * (2 * corr_radius + 1) ** 2)
        self.gru = SepConvGRU(hidden, context + self.GRU_MOTION)
        self.flow_head_1 = Conv(hidden, 256, (3, 3))
        self.flow_head_2 = Conv(256, 2, (3, 3))
        self.mask_head_1 = Conv(hidden, 256, (3, 3))
        self.mask_head_2 = Conv(256, 9 * DIV * DIV, (1, 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        self.to(self.device)
        if self.device.type == "cuda":
            build.start(self.KERNELS + (self.CORR_KERNELS
                                        if corr_backend == "pallas" else ()))

    @property
    def pad_divisor(self) -> int:
        """Inputs' H and W must be divisible by this: the 1/8 grid."""
        return DIV

    def _upsample(self, hidden: torch.Tensor, flow: torch.Tensor
                  ) -> torch.Tensor:
        logits = 0.25 * self.mask_head_2(F.relu(self.mask_head_1(hidden)))
        return convex_upsample(flow, _nhwc(logits), DIV)

    def _aggregation(self, context: torch.Tensor):
        """A function of each iteration's motion features whose result
        joins the GRU's input after them, made once a forward from the
        context features; None: published RAFT has none."""
        return None

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, *,
                train: bool = True, gt: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None, gamma: float = 0.8,
                max_flow: float = 400.0):
        """(N, H, W, 3) images in [0, 1], H and W divisible by 8 -> a list
        of (N, H, W, 2) f32 pixel flows: every iteration's with
        ``train=True``, the last one's with ``train=False``. With ``gt``
        and ``train=True``: ``([final flow], loss)``, the sequence loss of
        ``RAFT.forward``."""
        h, w = im1.shape[1], im1.shape[2]
        if h % DIV or w % DIV:
            raise ValueError(f"input H, W must be divisible by {DIV}; got "
                             f"{(h, w)} - pad the images (see pwcnet_tpu_torch"
                             ".train.evaluate.pad_to_divisible)")
        check_levels(h // DIV, w // DIV, self.corr_levels)
        n = im1.shape[0]
        cl = torch.channels_last
        im1 = (2 * im1.to(self.device, torch.float32) - 1).to(self.dtype)
        im2 = (2 * im2.to(self.device, torch.float32) - 1).to(self.dtype)
        fmap = self.fnet(_nchw(torch.cat([im1, im2], 0)).contiguous(
            memory_format=cl))
        ctx = self.cnet(_nchw(im1).contiguous(memory_format=cl))
        hidden = torch.tanh(ctx[:, :self.hidden].float()).to(self.dtype)
        context = F.relu(ctx[:, self.hidden:])
        plain = self.corr_backend == "lax"
        f1, f2 = _nhwc(fmap[:n]).contiguous(), _nhwc(fmap[n:]).contiguous()
        pyramid = (corr_pyramid_ref if plain else corr_pyramid)(
            f1, f2, self.corr_levels)
        lookup = corr_lookup_ref if plain else corr_lookup
        aggregate = self._aggregation(context)

        hh, ww = f1.shape[1:3]
        ys, xs = torch.meshgrid(
            torch.arange(hh, dtype=torch.float32, device=self.device),
            torch.arange(ww, dtype=torch.float32, device=self.device),
            indexing="ij")
        coords0 = torch.stack([xs, ys], -1)[None].expand(n, hh, ww, 2)
        coords1 = coords0

        inscan = train and gt is not None
        if inscan:
            gt32 = gt.to(self.device, torch.float32)
            v = (torch.sqrt((gt32 ** 2).sum(-1)) < max_flow).float()
            if valid is not None:
                v = v * valid.to(self.device, torch.float32)
            v_denom = torch.clamp(v.sum(), min=1.0)
        outs = []
        for _ in range(self.num_iters):
            coords1 = coords1.detach()
            corr = lookup(pyramid, coords1, self.corr_radius)
            flow = coords1 - coords0
            m = self.menc(_nchw(corr), _nchw(flow))
            x = [context, m] if aggregate is None else [context, m,
                                                        aggregate(m)]
            hidden = self.gru(hidden, torch.cat(x, 1))
            delta = self.flow_head_2(F.relu(self.flow_head_1(hidden)))
            coords1 = coords1 + _nhwc(delta).float()
            if inscan:
                up = self._upsample(hidden, coords1 - coords0)
                outs.append((torch.abs(up - gt32).sum(-1) * v).sum()
                            / v_denom)
            elif train:
                outs.append(self._upsample(hidden, coords1 - coords0))
        if inscan:
            k = self.num_iters
            wts = gamma ** (k - 1 - torch.arange(k, dtype=torch.float32,
                                                 device=self.device))
            return [up], (wts * torch.stack(outs)).sum()
        if not train:
            return [self._upsample(hidden, coords1 - coords0)]
        return outs

    def full_res_flow(self, flows: List[torch.Tensor],
                      hw: Tuple[int, int]) -> torch.Tensor:
        """As ``RAFT.full_res_flow``."""
        return RAFT.full_res_flow(self, flows, hw)
