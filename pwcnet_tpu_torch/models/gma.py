"""GMA: RAFT with global motion aggregation (Jiang, Campbell, Lu, Li,
Hartley; ICCV 2021, arXiv:2104.02409; the released ``core/network.py``,
``core/gma.py``, ``core/update.py``), with one head and content-only
attention, as the released evaluation runs it (``--num_heads 1``; no
relative positions). A port-only model.

Published RAFT (``models/raft_allpairs.py``: its encoders, all-pairs
pyramid, lookup, motion encoder, flow and mask heads, convex upsampling and
iteration loop), plus:

- the attention map, once a pair: ``q, k = split(to_qk(context))`` (a 1x1
  conv 128 -> 256 without bias), ``A = softmax_keys(q k^T / sqrt(128))``
  over all (H/8)(W/8) pixels;
- in every iteration, the aggregation ``g = m + gamma * A to_v(m)`` of the
  motion encoder's 128 channels ``m`` (``to_v`` a 1x1 conv 128 -> 128
  without bias, ``gamma`` one learned scalar; no projection, since the
  head is as wide as ``m``);
- the separable ConvGRU over hidden + (context, m, g): 128 over 384.

``ops/global_attention.py`` computes the map and the aggregation: K11 on
every CUDA tensor, the plain versions on CPU tensors (``corr_backend``
chooses only K8/K9, as for published RAFT; it does not choose K11).
Precision: the map's products and the
aggregation's sums in f32, the softmax in f32, the map stored in the
model's dtype, ``g`` rounded once to it. ``gamma`` starts at 0, as
released.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from pwcnet_tpu_torch.models.init import lecun_normal_
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc
from pwcnet_tpu_torch.models.raft_allpairs import RAFTAllPairs
from pwcnet_tpu_torch.ops.global_attention import aggregate, attention_map


class Project(nn.Module):
    """A 1x1 conv without bias (GMA's ``to_qk``, ``to_v``); OIHW f32
    weight, cast to the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, H W, C), a view of channels-last memory."""
    n, c = x.shape[:2]
    return _nhwc(x).reshape(n, -1, c)


class Attention(nn.Module):
    """GMA's ``Attention``: the map of the context features, (N, P, P)."""

    def __init__(self, dim: int, dim_head: int):
        super().__init__()
        self.to_qk = Project(dim, 2 * dim_head)

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        q, k = _rows(self.to_qk(context)).chunk(2, -1)
        return attention_map(q, k)


class Aggregate(nn.Module):
    """GMA's ``Aggregate``: ``m + gamma * attn @ to_v(m)`` (NCHW)."""

    def __init__(self, dim: int):
        super().__init__()
        self.to_v = Project(dim, dim)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        n, c, h, w = m.shape
        g = aggregate(attn, _rows(self.to_v(m)), _rows(m), self.gamma)
        return _nchw(g.view(n, h, w, c))


class GMA(RAFTAllPairs):
    """GMA for inference and training; the arguments are
    ``RAFTAllPairs``'. ``corr_backend`` chooses K8/K9 alone: K11 runs on
    every CUDA tensor, whatever the backend."""

    GRU_MOTION = 256   # m and g
    KERNELS = RAFTAllPairs.KERNELS + ("global_attention",)

    def __init__(self, num_iters: int = 12, corr_radius: int = 4,
                 corr_levels: int = 4, feat_dim: int = 256,
                 hidden: int = 128, context: int = 128,
                 corr_backend: str = "pallas",
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        super().__init__(num_iters, corr_radius, corr_levels, feat_dim,
                         hidden, context, corr_backend, dtype, device,
                         generator)
        # One head as wide as the context features; the motion features
        # (126 + flow) are as wide.
        self.att = Attention(context, context)
        self.aggregator = Aggregate(128)
        lecun_normal_(self.att.to_qk.weight, generator)
        lecun_normal_(self.aggregator.to_v.weight, generator)
        self.att.to(self.device)
        self.aggregator.to(self.device)

    def _aggregation(self, context: torch.Tensor):
        attn = self.att(context)
        return lambda m: self.aggregator(attn, m)
