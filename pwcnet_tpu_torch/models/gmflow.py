"""GMFlow with refinement (Xu, Zhang, Cai, Rezatofighi, Tao; CVPR 2022,
arXiv:2111.13680; the released ``gmflow/{backbone,trident_conv,position,
transformer,matching,gmflow,utils,geometry}.py``), as its Sintel model with
refinement runs: ``--num_scales 2 --upsample_factor 4 --attn_splits_list
2 8 --corr_radius_list -1 4 --prop_radius_list -1 1``, 128 feature
channels, 6 transformer blocks of one head, FFN expansion 4, Swin windows.
A port-only model, for inference.

- Inputs ``(image - mean) / std`` with ImageNet's mean and std (images in
  [0, 1]; the released code takes ``image / 255`` of 0-255 frames).
- ``backbone``: ``models/raft_allpairs.py``'s BasicEncoder with instance
  norm, stages of stride 1, 2, 1 (so 1/4), bias-free 7x7 and 3x3 convs, a
  1x1 projection (with bias) and its norm wherever the stride or the width
  changes, a 1x1 conv 128 -> 128; then ``trident``: one bias-free 3x3
  weight at stride 1 (the 1/4 features) and at stride 2 (1/8), both frames
  as one batch. Each norm with what follows it is K10 on the GPU.
- Per scale, 1/8 then 1/4 (splits 2 then 8; the transformer, the
  propagation and the upsampler are one set of weights for both):
  1. at 1/4, the flow upsampled x2 (bilinear, align_corners) times 2, and
     frame 2's features warped by it (``ops/warp.py:flow_warp``: bilinear,
     zeros outside, no coverage mask);
  2. DETR's sine position encoding of a window (64 + 64 channels,
     normalised, 2 pi) added to both frames in every window;
  3. ``transformer``: 6 blocks of self-attention (q, k, v, merge linears
     without bias, LayerNorm, added to the input) and cross-attention to
     the other frame (the same, then an FFN on ``cat(source, message)``:
     256 -> 1024, GELU, 1024 -> 128 without bias, LayerNorm, added), over
     the split's windows, the odd blocks on Swin's shifted windows. Both
     frames are one batch (f0, f1); the cross-attention of f1 reads f0 as
     the block received it.
     Each attention is one ``ops/window_attention.py`` call (K12 on the
     GPU): 24 a forward;
  4. matching: at 1/8 global, ``softmax_j(f0_i . f1_j / sqrt(128))`` over
     every pixel applied to the pixel grid, less the grid (one global K12
     call, values the 2 coordinates); at 1/4 local, radius 4: the 81
     correlations of ``ops/cost_volume.py`` (K1, their mean over C) times
     sqrt(C), candidates outside the frame at -1e9, a softmax over the 81
     and the expected offset, added to the upsampled flow;
  5. propagation: ``q = q_proj(f0)``; at 1/8 ``k = k_proj(q)`` (the
     released ``FeatureFlowAttention`` projects the projected query) and a
     global K12 call over the flow; at 1/4 ``k = k_proj(f0)`` (as released)
     and a 3x3 window, zero-padded as ``F.unfold`` pads (plain torch).
- ``upsampler``: 3x3 conv 130 -> 256 on ``cat(flow, f0)``, ReLU, 1x1 256 ->
  144, and ``models/raft.py``'s convex upsampling x4 (no mask scale).

Precision: convs, linears and LayerNorms in the model's dtype with f32
weights cast to it (a LayerNorm's statistics in f32, its result rounded
once); GELU's input and output in the activations' dtype; the attention
as ``ops/window_attention.py`` states (the scores and softmax in f32; at
width 128 the probabilities in bf16, at width 2 all f32); coordinates,
flow, the local softmax and the upsampling in f32; K1's correlation as it
gives it.

``corr_backend`` chooses K1 alone: ``"pallas"`` (default) runs it on CUDA
tensors, ``"lax"`` its plain version on any device. K10 and K12 run on
every CUDA tensor, whatever the backend.
Public layout is the port's: images (N, H, W, 3) in [0, 1], H and W
divisible by 32, flows (N, H, W, 2) in pixels, channel 0 = x.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.init import init_params, lecun_normal_
from pwcnet_tpu_torch.models.layers import Conv
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc, _resolve_device
from pwcnet_tpu_torch.models.raft import RAFT, convex_upsample
from pwcnet_tpu_torch.models.raft_allpairs import BasicEncoder
from pwcnet_tpu_torch.ops.cost_volume import cost_volume, cost_volume_ref
from pwcnet_tpu_torch.ops.kernels import build
from pwcnet_tpu_torch.ops.warp import flow_warp
from pwcnet_tpu_torch.ops.window_attention import window_attention

DIV = 32            # the released padding factor: 1/8 of it splits in two
FEATURES = 128      # feature_channels
LAYERS = 6          # num_transformer_layers
FFN_EXPANSION = 4   # ffn_dim_expansion
UPSAMPLE = 4        # upsample_factor: the last scale, 1/4, to full size
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-5


class Linear(nn.Module):
    """``nn.Linear``'s parameters (f32 (out, in) weight, optional bias),
    cast to the input's dtype."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with its parameters cast to ``x``'s dtype: its statistics
    and arithmetic in f32 (torch's accumulation type for bf16), the result
    rounded once to ``x``'s dtype."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), LN_EPS)


class TransformerLayer(nn.Module):
    """The released ``TransformerLayer``: attention of ``source`` to a
    target (itself, or the other frame), the merge and a LayerNorm; with
    ``ffn`` the MLP on ``cat(source, message)`` and a second LayerNorm;
    ``source + message``."""

    def __init__(self, dim: int, ffn: bool, expansion: int):
        super().__init__()
        self.q_proj = Linear(dim, dim, bias=False)
        self.k_proj = Linear(dim, dim, bias=False)
        self.v_proj = Linear(dim, dim, bias=False)
        self.merge = Linear(dim, dim, bias=False)
        self.norm1 = nn.LayerNorm(dim)
        self.mlp = self.norm2 = None
        if ffn:
            hid = 2 * dim * expansion
            self.mlp = nn.Sequential(Linear(2 * dim, hid, bias=False),
                                     nn.GELU(), Linear(hid, dim, bias=False))
            self.norm2 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, frames: int, splits: int,
                shifted: bool, target: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``x``: (2 frames, h, w, C) = concat(f0, f1). Self-attention
        without ``mlp``; cross-attention with it, image b of ``x`` reading
        image (b + frames) mod 2 frames of ``target``."""
        c = x.shape[-1]
        if self.mlp is None:   # self-attention: q, k and v in one GEMM
            w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight]).to(x.dtype)
            qkv = F.linear(x, w)
            msg = window_attention(qkv[..., :c], qkv[..., c:2 * c],
                                   qkv[..., 2 * c:], splits, shifted)
        else:
            q = self.q_proj(x)
            w = torch.cat([self.k_proj.weight, self.v_proj.weight]
                          ).to(x.dtype)
            kv = F.linear(target, w)
            msg = window_attention(q, kv[..., :c], kv[..., c:], splits,
                                   shifted, frames)
        msg = _layer_norm(self.norm1, self.merge(msg))
        if self.mlp is not None:
            hid = F.gelu(self.mlp[0](torch.cat([x, msg], -1)))
            msg = _layer_norm(self.norm2, self.mlp[2](hid))
        return x + msg


class TransformerBlock(nn.Module):
    """Self-attention, then cross-attention with the FFN to the other
    frame of the block's input (the released block's target is the
    previous block's output, swapped, before this block's
    self-attention)."""

    def __init__(self, dim: int, expansion: int, shifted: bool):
        super().__init__()
        self.shifted = shifted
        self.self_attn = TransformerLayer(dim, False, expansion)
        self.cross_attn_ffn = TransformerLayer(dim, True, expansion)

    def forward(self, x: torch.Tensor, frames: int, splits: int
                ) -> torch.Tensor:
        y = self.self_attn(x, frames, splits, self.shifted)
        return self.cross_attn_ffn(y, frames, splits, self.shifted, target=x)


class FeatureFlowAttention(nn.Module):
    """The released ``FeatureFlowAttention``: the flow propagated by
    self-attention of frame 1's features."""

    def __init__(self, dim: int):
        super().__init__()
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)

    def forward(self, f0: torch.Tensor, flow: torch.Tensor, radius: int
                ) -> torch.Tensor:
        """f0 (N, h, w, C), flow (N, h, w, 2) f32 -> (N, h, w, 2) f32:
        global (``radius`` -1) or over a (2 radius + 1)^2 window."""
        q = self.q_proj(f0)
        if radius < 0:
            return window_attention(q, self.k_proj(q), flow.contiguous(), 1)
        return _local_propagation(q, self.k_proj(f0), flow, radius)


def _local_propagation(q: torch.Tensor, k: torch.Tensor, flow: torch.Tensor,
                       r: int) -> torch.Tensor:
    """``forward_local_window_attn``: each pixel's softmax over the
    (2r + 1)^2 neighbours' ``q . k / sqrt(C)`` (zero keys and zero flow
    outside the frame, as ``F.unfold`` pads), in f32, times their flow."""
    n, h, w, c = q.shape
    qf = q.float()
    kp = F.pad(k.float(), (0, 0, r, r, r, r))
    fp = F.pad(flow.float(), (0, 0, r, r, r, r))
    d = 2 * r + 1
    s = torch.stack([(qf * kp[:, dy:dy + h, dx:dx + w]).sum(-1)
                     for dy in range(d) for dx in range(d)], -1) / c ** 0.5
    p = torch.softmax(s, -1)
    return sum(p[..., i:i + 1] * fp[:, i // d:i // d + h, i % d:i % d + w]
               for i in range(d * d))


def position_encoding(h: int, w: int, dim: int, device) -> torch.Tensor:
    """The released ``PositionEmbeddingSine`` (DETR's: normalised, 2 pi,
    temperature 10000) of an (h, w) window, (h, w, dim) f32: dim / 2
    channels of y, then dim / 2 of x, sine and cosine interleaved."""
    npf = dim // 2
    scale = 2 * math.pi
    ys = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    xs = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    ys = ys / (h + 1e-6) * scale
    xs = xs / (w + 1e-6) * scale
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = 10000 ** (2 * (dim_t // 2) / npf)

    def enc(e):
        p = e[:, None] / dim_t
        return torch.stack((p[:, 0::2].sin(), p[:, 1::2].cos()), 2).flatten(1)

    py, px = enc(ys), enc(xs)
    return torch.cat([py[:, None].expand(h, w, npf),
                      px[None].expand(h, w, npf)], -1)


def _add_position(x: torch.Tensor, splits: int) -> torch.Tensor:
    """``feature_add_position``: every window of the split gets the
    encoding of its own (h / splits, w / splits) grid; the sum rounded
    once to ``x``'s dtype. The windows are a view: (n, S, h / S, S, w / S,
    C) is (n, h, w, C) in memory."""
    n, h, w, c = x.shape
    wh, ww = h // splits, w // splits
    pos = position_encoding(wh, ww, c, x.device)
    y = x.view(n, splits, wh, splits, ww, c) + pos[None, None, :, None]
    return y.to(x.dtype).view(n, h, w, c)


class GMFlow(nn.Module):
    """GMFlow with refinement, for inference (module docstring), at the
    released model's widths and flags.

    ``corr_backend`` chooses K1 (``"pallas"``) or its plain version
    (``"lax"``); K10 and K12 run on every CUDA tensor. ``device=None``
    means the GPU, and raises when there is none. Weights are drawn from ``generator`` (seed 0 when None):
    convs and linears with the flax defaults' law, LayerNorms at the
    identity, biases zero.
    """

    KERNELS = ("encoder_norm", "window_attention")
    CORR_KERNELS = ("cost_volume",)
    # Per scale, 1/8 then 1/4: the README's --attn_splits_list,
    # --corr_radius_list (-1: global) and --prop_radius_list.
    attn_splits = (2, 8)
    corr_radius = (-1, 4)
    prop_radius = (-1, 1)

    def __init__(self, corr_backend: str = "pallas",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = _resolve_device(device)
        if corr_backend not in ("lax", "pallas"):
            raise ValueError(f"unknown correlation backend {corr_backend!r} "
                             "(GMFlow takes 'lax' or 'pallas')")
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"dtype must be float32 or bfloat16, got {dtype}")
        c = FEATURES
        self.corr_backend, self.dtype = corr_backend, dtype
        self.backbone = BasicEncoder(c, "instance", strides=(1, 2, 1),
                                     bias=False)
        self.trident = nn.Module()
        self.trident.weight = nn.Parameter(torch.zeros(c, c, 3, 3))
        self.transformer = nn.ModuleList(
            [TransformerBlock(c, FFN_EXPANSION, i % 2 == 1)
             for i in range(LAYERS)])
        self.feature_flow_attn = FeatureFlowAttention(c)
        self.upsampler_0 = Conv(2 + c, 256, (3, 3))
        self.upsampler_2 = Conv(256, 9 * UPSAMPLE ** 2, (1, 1))
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_params(self, generator)
        lecun_normal_(self.trident.weight, generator)
        for m in self.modules():
            if isinstance(m, Linear):
                lecun_normal_(m.weight, generator)
        # Not parameters: made on the device, so that a captured forward
        # copies nothing from the host.
        self.register_buffer("mean", torch.tensor(MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(STD), persistent=False)
        self.to(self.device)
        self._valid = {}
        if self.device.type == "cuda":
            build.start(self.KERNELS + (self.CORR_KERNELS
                                        if corr_backend == "pallas" else ()))

    @property
    def pad_divisor(self) -> int:
        """Inputs' H and W must be divisible by this (the released padding
        factor)."""
        return DIV

    def _features(self, im1: torch.Tensor, im2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both frames' 1/8 and 1/4 features, (2N, h, w, C) each."""
        x = torch.cat([im1, im2]).to(self.device, torch.float32)
        x = ((x - self.mean) / self.std).to(self.dtype)
        f = self.backbone(_nchw(x).contiguous(
            memory_format=torch.channels_last))
        w = self.trident.weight.to(self.dtype)
        return (_nhwc(F.conv2d(f, w, stride=2, padding=1)),
                _nhwc(F.conv2d(f, w, padding=1)))

    def _valid_taps(self, h: int, w: int, r: int) -> torch.Tensor:
        """(h, w, (2r + 1)^2) bool: which of a pixel's candidates lie in
        the frame, made once per shape."""
        key = (h, w, r)
        if key not in self._valid:
            d = torch.arange(-r, r + 1, device=self.device)
            ys = torch.arange(h, device=self.device)[:, None] + d
            xs = torch.arange(w, device=self.device)[:, None] + d
            vy = (ys >= 0) & (ys < h)
            vx = (xs >= 0) & (xs < w)
            self._valid[key] = (vy[:, None, :, None] & vx[None, :, None, :]
                                ).reshape(h, w, -1)
        return self._valid[key]

    def _local_match(self, f0: torch.Tensor, f1: torch.Tensor, r: int
                     ) -> torch.Tensor:
        """The released ``local_correlation_softmax``'s flow: the expected
        offset over the (2r + 1)^2 candidates."""
        c = f0.shape[-1]
        corr = (cost_volume_ref(f0, f1, r) if self.corr_backend == "lax"
                else cost_volume(f0, f1, max_displacement=r))
        s = corr.float() * c ** 0.5
        s = s.masked_fill(~self._valid_taps(f0.shape[1], f0.shape[2], r),
                          -1e9)
        p = torch.softmax(s, -1)
        d = torch.arange(-r, r + 1, dtype=torch.float32, device=self.device)
        off = torch.stack(torch.meshgrid(d, d, indexing="ij")[::-1], -1
                          ).reshape(-1, 2)   # (dx, dy), dy major
        return torch.matmul(p, off)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, *,
                train: bool = False) -> List[torch.Tensor]:
        """(N, H, W, 3) images in [0, 1], H and W divisible by 32 -> [the
        1/8 flow, the 1/4 flow (each after its propagation, in pixels of
        its grid), the (N, H, W, 2) f32 pixel flow]. Inference only: the
        training-time predictions of the released code are not ported."""
        if train:
            raise ValueError("GMFlow runs inference only (train=False)")
        h, w = im1.shape[1], im1.shape[2]
        if h % DIV or w % DIV:
            raise ValueError(f"input H, W must be divisible by {DIV}; got "
                             f"{(h, w)} - pad the images (see pwcnet_tpu_torch"
                             ".train.evaluate.pad_to_divisible)")
        n = im1.shape[0]
        flow = f0 = None
        flows = []
        for scale, feats in enumerate(self._features(im1, im2)):
            splits = self.attn_splits[scale]
            if flow is not None:
                flow = 2 * _nhwc(F.interpolate(
                    _nchw(flow), scale_factor=2, mode="bilinear",
                    align_corners=True))
                feats = torch.cat([feats[:n], flow_warp(feats[n:], flow)])
            x = _add_position(feats, splits)
            for block in self.transformer:
                x = block(x, n, splits)
            f0, f1 = x[:n], x[n:]
            r = self.corr_radius[scale]
            if r < 0:
                hh, ww = f0.shape[1:3]
                ys, xs = torch.meshgrid(
                    torch.arange(hh, dtype=torch.float32, device=self.device),
                    torch.arange(ww, dtype=torch.float32, device=self.device),
                    indexing="ij")
                grid = torch.stack([xs, ys], -1)[None].expand(n, hh, ww, 2)
                pred = window_attention(f0, f1, grid, 1) - grid
            else:
                pred = self._local_match(f0, f1, r)
            flow = pred if flow is None else flow + pred
            flow = self.feature_flow_attn(f0, flow, self.prop_radius[scale])
            flows.append(flow)
        x = torch.cat([flow.to(self.dtype), f0], -1)
        logits = self.upsampler_2(F.relu(self.upsampler_0(
            _nchw(x).contiguous(memory_format=torch.channels_last))))
        return flows + [convex_upsample(flow, _nhwc(logits), UPSAMPLE)]

    def full_res_flow(self, flows: List[torch.Tensor],
                      hw: Tuple[int, int]) -> torch.Tensor:
        """As ``RAFT.full_res_flow``."""
        return RAFT.full_res_flow(self, flows, hw)
