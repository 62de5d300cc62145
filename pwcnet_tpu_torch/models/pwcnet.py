"""PWC-Net assembly (counterpart of ``pwcnet_tpu/models/pwcnet.py``).

Public layout is the JAX package's: images (N, H, W, 3) in [0, 1], flows
(N, H_l, W_l, 2) with channel 0 = x, in *scaled units* (full-resolution
pixels / ``flow_scale``), coarsest level first. Inside, activations are NCHW
tensors in ``torch.channels_last`` memory, so a ``permute(0, 2, 3, 1)`` is
already the contiguous NHWC that the correlation and stem kernels take.

The flow chain stays f32 in a bf16 model: the estimator's and the context
net's flow convs are cast to f32, and the upsampled flow is cast to the
working dtype only for the concat.

``forward(..., mesh=...)`` runs the spatially sharded forward on this rank's
image rows (``pwcnet_tpu_torch.parallel.spatial.spatial_forward`` is the
entry that shards and gathers): the convs, the stem and the upsampling
exchange rows across shard edges (``parallel/spatial_ops.py``), and the
warp + correlation runs on halo rows (``parallel/halo.py``: K1p, K6p).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from pwcnet_tpu_torch.models.init import init_params
from pwcnet_tpu_torch.models.layers import (ConvBlock, ConvStack, Conv3x3,
                                            StemConvs, leaky_relu)
from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_ref
from pwcnet_tpu_torch.ops.resize import RESIZE_MODES, resize_bilinear
from pwcnet_tpu_torch.ops.warp import warp_bilinear
from pwcnet_tpu_torch.ops.warp_corr import fused_is_profitable, warp_corr
from pwcnet_tpu_torch.parallel.halo import warp_corr_spatial
from pwcnet_tpu_torch.parallel.mesh import SPATIAL_AXIS
from pwcnet_tpu_torch.parallel.spatial_ops import (input_norm_rows,
                                                   upsample2x_rows)

# Level l (1-indexed, 1/2^l resolution) -> channels.
DEFAULT_PYRAMID_CHANNELS: Tuple[int, ...] = (16, 32, 64, 96, 128, 196, 224)
ESTIMATOR_CHANNELS: Tuple[int, ...] = (128, 128, 96, 64, 32)
# Context network (channels, dilation); a final 2-channel conv follows.
CONTEXT_SPEC: Tuple[Tuple[int, int], ...] = (
    (128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


def _resolve_device(device) -> torch.device:
    """``None`` means the GPU; asking for a GPU that is absent raises, so
    nothing carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class FeaturePyramidExtractor(nn.Module):
    """Stride-2 conv pairs per level; levels 1-2 go through ``StemConvs``
    when the decoder needs nothing finer than level 2 (``min_level >= 2``).

    ``forward`` takes NHWC images and returns NCHW features coarsest first,
    omitting levels finer than ``min_level``.
    """

    def __init__(self, channels=DEFAULT_PYRAMID_CHANNELS, min_level: int = 1,
                 stem_backend: str = "auto", use_norm: bool = False):
        super().__init__()
        self.min_level = min_level
        self.stem = None
        start, cin = 0, 3
        if min_level >= 2 and not use_norm and len(channels) >= 2:
            self.stem = StemConvs(channels[0], channels[1], stem_backend)
            start, cin = 2, channels[1]
        blocks = []
        for ch in channels[start:]:
            blocks += [ConvBlock(cin, ch, stride=2, use_norm=use_norm),
                       ConvBlock(ch, ch, use_norm=use_norm)]
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.first_level = start + 1

    def forward(self, im: torch.Tensor, mesh=None) -> List[torch.Tensor]:
        feats = []
        if self.stem is not None:
            x = _nchw(self.stem(im, mesh))
            if self.min_level <= 2:
                feats.append(x)
        else:
            x = _nchw(im).contiguous(memory_format=torch.channels_last)
        level = self.first_level
        for i in range(0, len(self.blocks), 2):
            x = self.blocks[i + 1](self.blocks[i](x, mesh), mesh)
            if level >= self.min_level:
                feats.append(x)
            level += 1
        return feats[::-1]


class OpticalFlowEstimator(nn.Module):
    """Conv stack 128-128-96-64-32, then a 2-channel flow conv in f32."""

    def __init__(self, cin: int, use_norm: bool = False):
        super().__init__()
        self.stack = ConvStack(cin, ESTIMATOR_CHANNELS, use_norm=use_norm)
        self.flow = Conv3x3(ESTIMATOR_CHANNELS[-1], 2)

    def forward(self, x: torch.Tensor, mesh=None):
        feat = self.stack(x, mesh)
        return feat, self.flow(feat, mesh).float()


class ContextNetwork(nn.Module):
    """Dilated-conv refinement at the output level; returns an f32 delta."""

    def __init__(self, cin: int = ESTIMATOR_CHANNELS[-1] + 2):
        super().__init__()
        blocks = []
        for ch, dil in CONTEXT_SPEC:
            blocks.append(ConvBlock(cin, ch, dilation=dil))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.flow = Conv3x3(cin, 2)

    def forward(self, feat: torch.Tensor, flow: torch.Tensor,
                mesh=None) -> torch.Tensor:
        x = torch.cat([feat, flow.to(feat.dtype)], 1)
        for block in self.blocks:
            x = block(x, mesh)
        return self.flow(x, mesh).float()


class PWCNet(nn.Module):
    """The coarse-to-fine PWC-Net forward, for inference and training.

    Options follow the JAX ``PWCNet``. The correlation and the stem are the
    CUDA kernels on the GPU (differentiable: their backward is a kernel too)
    and their plain versions on the CPU; ``corr_backend="lax"`` and
    ``stem_backend="lax"`` ask for the plain versions on any device (their
    gradients are autograd's). ``corr_backend="fused"`` runs the
    fused warp + correlation (K6) at the warped levels of at least
    ``fused_min_pixels`` pixels (None: the port's ``FUSED_MIN_PIXELS``; 0:
    every warped level), and warp + correlation elsewhere, as the JAX model
    dispatches. ``spatial_axis`` (None or ``"spatial"``) and
    ``spatial_halo`` (halo rows per level, bounding the warp's vertical
    reach across shards) are the JAX model's: a model with a spatial axis
    runs only under a mesh (``forward(..., mesh=...)``). ``device=None``
    means the GPU, and raises when there is none. Weights are drawn from
    ``generator`` (seed 0 when None) with the flax defaults' law.
    """

    def __init__(self, num_levels: int = 6, output_level: int = 4,
                 search_range: int = 4, residual: bool = True,
                 use_norm: bool = False, input_norm: bool = False,
                 input_center: bool = False, corr_backend: str = "pallas",
                 stem_backend: str = "auto",
                 fused_min_pixels: Optional[int] = None,
                 flow_scale: float = 20.0,
                 resize_mode: str = "half_pixel", spatial_axis=None,
                 spatial_halo: int = 16,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = _resolve_device(device)
        if not 1 <= num_levels <= len(DEFAULT_PYRAMID_CHANNELS):
            raise ValueError(f"num_levels must be in 1..7, got {num_levels}")
        if not 0 <= output_level < num_levels:
            raise ValueError(f"output_level must be in 0..{num_levels - 1}, "
                             f"got {output_level}")
        if spatial_axis not in (None, SPATIAL_AXIS):
            raise ValueError(f"spatial_axis must be None or "
                             f"{SPATIAL_AXIS!r}, got {spatial_axis!r}")
        if resize_mode not in RESIZE_MODES:
            raise ValueError(f"resize_mode must be one of {RESIZE_MODES}, "
                             f"got {resize_mode!r}")
        if corr_backend not in ("lax", "pallas", "fused"):
            raise ValueError(f"unknown corr_backend {corr_backend!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.num_levels, self.output_level = num_levels, output_level
        self.search_range, self.residual = search_range, residual
        self.input_norm, self.input_center = input_norm, input_center
        self.flow_scale, self.resize_mode = flow_scale, resize_mode
        self.corr_backend = corr_backend
        self.fused_min_pixels = fused_min_pixels
        self.spatial_axis, self.spatial_halo = spatial_axis, spatial_halo
        self.dtype = dtype

        chans = DEFAULT_PYRAMID_CHANNELS[:num_levels]
        self.pyramid = FeaturePyramidExtractor(
            chans, min_level=num_levels - output_level,
            stem_backend=stem_backend, use_norm=use_norm)
        ncorr = (2 * search_range + 1) ** 2
        self.estimators = nn.ModuleDict({
            f"l{lv}": OpticalFlowEstimator(ncorr + chans[lv - 1] + 2,
                                           use_norm=use_norm)
            for lv in range(num_levels, num_levels - output_level - 1, -1)})
        self.context = ContextNetwork()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        self.to(self.device)

    @property
    def pad_divisor(self) -> int:
        """Inputs' H and W must be divisible by this."""
        return 2 ** self.num_levels

    def _prepare(self, im: torch.Tensor, mesh=None) -> torch.Tensor:
        im = im.to(self.device, torch.float32)
        if self.input_center:
            im = im * 2.0 - 1.0
        if self.input_norm and mesh is not None:
            im = input_norm_rows(im, mesh)
        elif self.input_norm:
            m = im.mean((1, 2, 3), keepdim=True)
            s = im.std((1, 2, 3), keepdim=True, correction=0) + 1e-6
            im = (im - m) / s
        return im.to(self.dtype)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor,
                intermediates: Optional[Dict[str, list]] = None,
                mesh=None, train: bool = True) -> List[torch.Tensor]:
        """(N, H, W, 3) images in [0, 1], H and W divisible by
        ``pad_divisor`` -> per-level f32 flows, coarsest first.

        ``train`` is accepted for callers that drive PWC-Net and RAFT alike
        and changes nothing: the JAX model passes it to its blocks, and
        none reads it (GroupNorm keeps no batch statistics).

        When ``intermediates`` is a dict, it receives the pyramid of both
        frames (``"pyramid"``, NHWC, coarsest first) and each level's
        correlation before its LeakyReLU (``"corr"``, NHWC).

        With a ``mesh`` (a ``parallel.mesh.GridMesh``, whose spatial axis
        is taken), the images are this rank's rows ``[r*t,
        (r+1)*t)`` of the H-sharded pair (the whole image's H divisible by
        ``pad_divisor * S``), and so are the returned flows; every rank of
        the spatial axis must call it. The sharded forward is
        differentiable (``parallel/halo.py``, ``parallel/spatial_ops.py``):
        the global loss is the sum of the ranks' losses on their rows.
        """
        if mesh is None and self.spatial_axis is not None:
            raise ValueError("a model with spatial_axis runs under a mesh: "
                             "pass mesh=, or use parallel.spatial_forward")
        if mesh is not None:
            mesh = mesh.spatial_mesh
        div = self.pad_divisor
        h, w = im1.shape[1], im1.shape[2]
        if h % div or w % div:
            raise ValueError(
                f"input H, W must be divisible by 2**num_levels={div}; got "
                f"{(h, w)} - pad the images (see pwcnet_tpu_torch.train."
                f"evaluate.pad_to_divisible for the inference path)")
        n = im1.shape[0]
        both = torch.cat([self._prepare(im1, mesh),
                          self._prepare(im2, mesh)], 0)
        pyr = self.pyramid(both, mesh)
        if intermediates is not None:
            intermediates["pyramid"] = [_nhwc(p) for p in pyr]
            intermediates["corr"] = []

        flows: List[torch.Tensor] = []
        flow = None
        d = self.search_range
        for i in range(self.output_level + 1):
            level = self.num_levels - i
            f1, f2 = pyr[i][:n], pyr[i][n:]
            f1h, f2h = _nhwc(f1), _nhwc(f2)
            pix = None
            if flow is None:
                up_flow = f1h.new_zeros(f1h.shape[:3] + (2,),
                                        dtype=torch.float32)
            else:
                up_flow = (upsample2x_rows(flow, mesh, self.resize_mode)
                           if mesh is not None
                           else resize_bilinear(flow, tuple(f1h.shape[1:3]),
                                                self.resize_mode))
                pix = up_flow * (self.flow_scale / 2.0 ** level)
            if mesh is not None:
                corr = warp_corr_spatial(
                    f1h, f2h, pix, mesh, max_displacement=d,
                    halo_rows=self.spatial_halo, backend=self.corr_backend,
                    fused_min_pixels=self.fused_min_pixels)
            elif (self.corr_backend == "fused" and pix is not None
                  and fused_is_profitable(f1h.shape[1], f1h.shape[2],
                                          self.fused_min_pixels)):
                corr = warp_corr(f1h, f2h, pix, max_displacement=d)
            else:
                corr_fn = (cost_volume_ref if self.corr_backend == "lax"
                           else cost_volume)
                corr = corr_fn(f1h, f2h if pix is None
                               else warp_bilinear(f2h, pix),
                               max_displacement=d)
            if intermediates is not None:
                intermediates["corr"].append(corr)
            x = torch.cat([_nchw(leaky_relu(corr)), f1,
                           _nchw(up_flow.to(self.dtype))], 1)
            feat, delta = self.estimators[f"l{level}"](x, mesh)
            flow = up_flow + _nhwc(delta) if self.residual else _nhwc(delta)
            if i == self.output_level:
                flow = flow + _nhwc(self.context(feat, _nchw(flow), mesh))
            flows.append(flow)
        return flows

    def full_res_flow(self, flows: List[torch.Tensor],
                      hw: Tuple[int, int]) -> torch.Tensor:
        """Finest prediction -> full-resolution pixel flow (N, H, W, 2)."""
        return resize_bilinear(flows[-1], hw, self.resize_mode) \
            * self.flow_scale
