"""RAFT-style iterative refinement (counterpart of
``pwcnet_tpu/models/raft.py``).

Each of ``num_iters`` iterations warps the frame-2 features by the current
flow and computes a local correlation of radius ``corr_radius`` at two
scales (the 1/8 features and their 2x2 average), the memory-light form of
RAFT's lookup; a motion encoder, a separable ConvGRU and a flow head then
refine the 1/8-resolution flow, and RAFT's convex upsampling lifts it to full
resolution. The correlation is the port's (K1 forward, K2 and K3 backward on
the GPU, through ``CostVolumeFunction``); everything else is plain PyTorch,
as the JAX model is XLA outside its correlation.

Public layout is the JAX package's: images (N, H, W, 3) in [0, 1], flows
(N, H, W, 2) in full-resolution pixels, channel 0 = x. Inside, activations
are NCHW tensors in ``torch.channels_last`` memory (as in ``PWCNet``); the
flow is carried NHWC in f32.

What the JAX model does and this one mirrors:
- only the lookup sees ``flow.detach()``: the carried flow, and the motion
  encoder's copy of it, keep their gradient across iterations (the original
  RAFT detaches the flow at every iteration; this model does not);
- LeakyReLU is ``jax.nn.leaky_relu``, whose gradient at exactly 0 is 1
  (torch's is the slope): at the first iteration the flow is 0, so at init
  (zero biases) the motion encoder's flow branch sits at exactly 0;
- the hidden state is ``tanh`` in f32, then cast to the compute dtype; the
  flow is carried in f32 and cast to the compute dtype for the convs;
- the warp's gather table of each scale is built once per forward;
- the coarse correlation is upsampled 2x nearest and the concat of both
  scales goes through one LeakyReLU;
- the mask logits are scaled by 0.25, the softmax is f32 and the 3x3
  neighbourhood zero-padded;
- ``train=True`` upsamples every iteration, ``train=False`` only the last;
  with ``gt=`` the model returns ``([final flow], loss)``, the sequence
  loss summed inside the loop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.init import init_params
from pwcnet_tpu_torch.models.layers import Conv
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc, _resolve_device
from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_ref
from pwcnet_tpu_torch.ops.resize import resize_bilinear
from pwcnet_tpu_torch.ops.warp import warp_bilinear_from_table, warp_table

# The GRU runs at 1/8 resolution; the second correlation scale halves it.
DIV = 8


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU, slope 0.1, with ``jax.nn.leaky_relu``'s gradient 1 at 0."""
    return torch.where(x >= 0, x, 0.1 * x)


class ResBlock(nn.Module):
    """3x3 conv (stride) -> LeakyReLU -> 3x3 conv, plus the input (through a
    1x1 conv of the same stride where the width or the stride changes),
    then LeakyReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv0 = Conv(cin, features, (3, 3), stride)
        self.conv1 = Conv(features, features, (3, 3))
        self.conv2 = (Conv(cin, features, (1, 1), stride)
                      if cin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(leaky_relu(self.conv0(x)))
        if self.conv2 is not None:
            x = self.conv2(x)
        return leaky_relu(x + y)


class RAFTEncoder(nn.Module):
    """Residual encoder to 1/8 resolution and ``dim`` channels (NCHW)."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.conv0 = Conv(3, 32, (7, 7), 2)
        self.blocks = nn.ModuleList([ResBlock(32, 48, 2), ResBlock(48, dim, 2),
                                     ResBlock(dim, dim)])
        self.conv1 = Conv(dim, dim, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv0(x))
        for block in self.blocks:
            x = block(x)
        return self.conv1(x)


class SepConvGRU(nn.Module):
    """RAFT's separable ConvGRU: a 1x5 pass, then a 5x1 pass. ``convs``
    holds the flax module's ``Conv_0..5`` (z, r, q per pass) or, with
    ``fuse_zr``, ``Conv_0..3`` (z and r as one conv, q per pass)."""

    def __init__(self, hidden: int, cin_x: int, fuse_zr: bool = False):
        super().__init__()
        self.hidden, self.fuse_zr = hidden, fuse_zr
        cin = hidden + cin_x
        convs = []
        for ks in ((1, 5), (5, 1)):
            gates = ([Conv(cin, 2 * hidden, ks)] if fuse_zr else
                     [Conv(cin, hidden, ks), Conv(cin, hidden, ks)])
            convs += gates + [Conv(cin, hidden, ks)]
        self.convs = nn.ModuleList(convs)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        per_pass = 2 if self.fuse_zr else 3
        for p in range(2):
            cs = self.convs[p * per_pass:(p + 1) * per_pass]
            hx = torch.cat([h, x], 1)
            if self.fuse_zr:
                zr = cs[0](hx)
                z = torch.sigmoid(zr[:, :self.hidden])
                r = torch.sigmoid(zr[:, self.hidden:])
            else:
                z, r = torch.sigmoid(cs[0](hx)), torch.sigmoid(cs[1](hx))
            q = torch.tanh(cs[-1](torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    """Correlation and flow features for the GRU: 94 channels, then the
    flow itself (in the correlation's dtype)."""

    def __init__(self, ncorr: int):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(ncorr, 96, (1, 1)), Conv(96, 64, (3, 3)),
            Conv(2, 64, (7, 7)), Conv(64, 32, (3, 3)), Conv(96, 94, (3, 3))])

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        c0, c1, f0, f1, out = self.convs
        flow = flow.to(corr.dtype)
        c = leaky_relu(c1(leaky_relu(c0(corr))))
        f = leaky_relu(f1(leaky_relu(f0(flow))))
        return torch.cat([leaky_relu(out(torch.cat([c, f], 1))), flow], 1)


def convex_upsample(flow: torch.Tensor, mask_logits: torch.Tensor,
                    factor: int = DIV) -> torch.Tensor:
    """RAFT's convex upsampling, in f32: each fine pixel is a softmax-convex
    combination of its coarse pixel's 3x3 neighbourhood (zero-padded at the
    border), with the flow scaled by ``factor``. ``flow`` (N, h, w, 2),
    ``mask_logits`` (N, h, w, 9 * factor**2) -> (N, h * factor, w * factor,
    2)."""
    n, h, w, _ = flow.shape
    ff = factor * factor
    m = torch.softmax(mask_logits.float().reshape(n, h, w, 9, ff), dim=3)
    pad = F.pad(flow.float() * factor, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack([pad[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], 3)
    up = torch.einsum("nhwkp,nhwkc->nhwpc", m, nbrs)  # (N, h, w, ff, 2)
    return up.reshape(n, h, w, factor, factor, 2).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h * factor, w * factor, 2)


class RAFT(nn.Module):
    """The two-scale local-correlation RAFT, for inference and training.

    Options follow the JAX ``RAFT``. ``corr_backend`` is ``"pallas"`` by
    default here (the JAX class defaults to ``"lax"``; its configs pass
    ``"pallas"``), so that a bare ``RAFT()`` runs the correlation kernels on
    the GPU: K1 forward, K2 and K3 backward, on CUDA tensors, and their
    plain versions on CPU tensors. ``"lax"`` runs the plain correlation on
    any device (autograd gradients). ``"fused"`` raises, as JAX's
    ``cost_volume`` does. The JAX model pins the lax backward for RAFT's
    lookup from a TPU measurement; here the backward is the kernels'.
    ``device=None`` means the GPU, and raises when there is none. Weights
    are drawn from ``generator`` (seed 0 when None) with the flax defaults'
    law.
    """

    def __init__(self, num_iters: int = 12, corr_radius: int = 4,
                 feat_dim: int = 128, hidden: int = 96, context: int = 64,
                 corr_backend: str = "pallas", gru_fuse_zr: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = _resolve_device(device)
        if corr_backend not in ("lax", "pallas"):
            raise ValueError(f"unknown cost-volume backend {corr_backend!r} "
                             "(RAFT takes 'lax' or 'pallas')")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.num_iters, self.corr_radius = num_iters, corr_radius
        self.hidden, self.corr_backend = hidden, corr_backend
        self.dtype = dtype
        ncorr = 2 * (2 * corr_radius + 1) ** 2
        self.fnet = RAFTEncoder(feat_dim)
        self.cnet = RAFTEncoder(hidden + context)
        self.gru = SepConvGRU(hidden, context + 96, gru_fuse_zr)
        self.menc = MotionEncoder(ncorr)
        self.flow_head_1 = Conv(hidden, 128, (3, 3))
        self.flow_head_2 = Conv(128, 2, (3, 3))
        self.mask_head_1 = Conv(hidden, 128, (3, 3))
        self.mask_head_2 = Conv(128, 9 * DIV * DIV, (1, 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        self.to(self.device)

    @property
    def pad_divisor(self) -> int:
        """Inputs' H and W must be divisible by this: 8 for the GRU's grid,
        times 2 for the half-scale correlation."""
        return 2 * DIV

    def _lookup(self, f1, f1h, tabs, shapes, flow) -> torch.Tensor:
        """Both scales' correlation at ``flow`` (detached by the caller),
        the coarse one upsampled 2x nearest, through one LeakyReLU: NHWC."""
        d = self.corr_radius
        corr_fn = cost_volume_ref if self.corr_backend == "lax" \
            else cost_volume
        c0 = corr_fn(f1, warp_bilinear_from_table(tabs[0], shapes[0], flow,
                                                  f1.dtype),
                     max_displacement=d)
        c1 = corr_fn(f1h, warp_bilinear_from_table(
            tabs[1], shapes[1], flow[:, ::2, ::2] * 0.5, f1h.dtype),
            max_displacement=d)
        n, hh, hw, cc = c1.shape
        c1_up = c1[:, :, None, :, None, :].expand(n, hh, 2, hw, 2, cc).reshape(
            n, 2 * hh, 2 * hw, cc)
        return leaky_relu(torch.cat([c0, c1_up], -1))

    def _upsample(self, hidden: torch.Tensor, flow: torch.Tensor
                  ) -> torch.Tensor:
        logits = 0.25 * self.mask_head_2(leaky_relu(self.mask_head_1(hidden)))
        return convex_upsample(flow, _nhwc(logits), DIV)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, *,
                train: bool = True, gt: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None, gamma: float = 0.8,
                max_flow: float = 400.0):
        """(N, H, W, 3) images in [0, 1], H and W divisible by 16 -> a list
        of (N, H, W, 2) f32 pixel flows: every iteration's with
        ``train=True``, the last one's with ``train=False``. With ``gt``
        (N, H, W, 2) and ``train=True``: ``([final flow], loss)``, the sum
        over iterations i of ``gamma ** (n - 1 - i)`` times the mean L1
        error over the pixels with |gt| < ``max_flow`` (and ``valid``)."""
        h, w = im1.shape[1], im1.shape[2]
        div = self.pad_divisor
        if h % div or w % div:
            raise ValueError(f"input H, W must be divisible by {div}; got "
                             f"{(h, w)} - pad the images (see pwcnet_tpu_torch"
                             ".train.evaluate.pad_to_divisible)")
        n = im1.shape[0]
        cl = torch.channels_last
        im1 = im1.to(self.device, self.dtype)
        im2 = im2.to(self.device, self.dtype)
        fmap = self.fnet(_nchw(torch.cat([im1, im2], 0)).contiguous(
            memory_format=cl))
        f1, f2 = fmap[:n], fmap[n:]
        f1h, f2h = F.avg_pool2d(f1, 2), F.avg_pool2d(f2, 2)
        ctx = self.cnet(_nchw(im1).contiguous(memory_format=cl))
        hidden = torch.tanh(ctx[:, :self.hidden].float()).to(self.dtype)
        context = leaky_relu(ctx[:, self.hidden:])

        f1, f1h, f2, f2h = (_nhwc(t) for t in (f1, f1h, f2, f2h))
        # The gather tables of the loop-constant frame-2 features, from f32
        # copies (the gather's backward then sums in f32).
        tabs = (warp_table(f2.float()), warp_table(f2h.float()))
        shapes = (tuple(f2.shape), tuple(f2h.shape))

        inscan = train and gt is not None
        if inscan:
            gt32 = gt.to(self.device, torch.float32)
            v = (torch.sqrt((gt32 ** 2).sum(-1)) < max_flow).float()
            if valid is not None:
                v = v * valid.to(self.device, torch.float32)
            v_denom = torch.clamp(v.sum(), min=1.0)

        flow = torch.zeros(f1.shape[:3] + (2,), device=self.device)
        outs = []
        for _ in range(self.num_iters):
            corr = self._lookup(f1, f1h, tabs, shapes, flow.detach())
            m = self.menc(_nchw(corr), _nchw(flow))
            hidden = self.gru(hidden, torch.cat([context, m], 1))
            delta = self.flow_head_2(leaky_relu(self.flow_head_1(hidden)))
            flow = flow + _nhwc(delta).float()
            if inscan:
                up = self._upsample(hidden, flow)
                outs.append((torch.abs(up - gt32).sum(-1) * v).sum()
                            / v_denom)
            elif train:
                outs.append(self._upsample(hidden, flow))
        if inscan:
            k = self.num_iters
            wts = gamma ** (k - 1 - torch.arange(k, dtype=torch.float32,
                                                 device=self.device))
            return [up], (wts * torch.stack(outs)).sum()
        if not train:
            return [self._upsample(hidden, flow)]
        return outs

    def full_res_flow(self, flows: List[torch.Tensor],
                      hw: Tuple[int, int]) -> torch.Tensor:
        """The last iteration's flow at ``hw``: an identity unless the
        caller resized the input. The flows are in pixels, so u scales by
        the W ratio and v by the H ratio."""
        flow = flows[-1]
        sy, sx = hw[0] / flow.shape[1], hw[1] / flow.shape[2]
        up = resize_bilinear(flow, hw)
        # Scalar products, not a host tensor: nothing is copied to the
        # device, so a graph can hold it.
        return torch.stack([up[..., 0] * sx, up[..., 1] * sy], -1)
