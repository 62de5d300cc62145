"""GMA (Jiang, Campbell, Lu, Li, Hartley; ICCV 2021, arXiv:2104.02409),
after the released ``core/network.py``, ``core/gma.py`` and
``core/update.py`` with ``--num_heads 1`` and content-only attention, in
plain float32 PyTorch, as a function of a parameter dict keyed by the
port's ``state_dict`` keys.

Published RAFT's parts are ``reference/raft_allpairs.py``'s functions:
the encoders, the all-pairs pyramid, its lookup, the convex upsampling.
Beside them, once a pair, the attention map of the context features
(``to_qk``, a 1x1 conv without bias, split into q and k; ``softmax(q
k^T / sqrt(128))`` over every pixel), computed ``ROW_BLOCK`` queries at a
time so that the f32 map (4.2 GB at a 135x240 grid) is held once; and in
every iteration the GMA update block: the motion encoder, the aggregation
``m + gamma * A to_v(m)`` of its features, the separable ConvGRU over
(context, m, aggregated m), the flow head. The configuration's
``departures`` list where this differs from the released code.

``prec.q`` is applied where the port rounds to its compute dtype: every
conv's input and weight, q, k and v before their products, the features
before the volume, each pyramid level, and the map before the aggregation.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowbench.reference import raft_allpairs as rap
from flowbench.reference.ops import F32, Precision, nchw, nhwc

Params = Dict[str, torch.Tensor]
ROW_BLOCK = 4096
full_res = rap.full_res


def _project(p: Params, key: str, x: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    """A 1x1 conv without bias."""
    return F.conv2d(prec.q(x), prec.q(p[key + ".weight"]))


def attention(p: Params, inp: torch.Tensor, prec: Precision = F32
              ) -> torch.Tensor:
    """The released ``Attention``: (N, C, h, w) context features -> the
    (N, h w, h w) map, rows by blocks."""
    q, k = _project(p, "att.to_qk", inp, prec).chunk(2, dim=1)
    n, d, h, w = q.shape
    q = prec.q(q).reshape(n, d, h * w).transpose(1, 2) * d ** -0.5
    k = prec.q(k).reshape(n, d, h * w)
    attn = torch.empty((n, h * w, h * w), device=q.device)
    for i in range(0, h * w, ROW_BLOCK):
        attn[:, i:i + ROW_BLOCK] = prec.q(torch.softmax(
            torch.matmul(q[:, i:i + ROW_BLOCK], k), dim=-1))
    return attn


def aggregate(p: Params, attn: torch.Tensor, m: torch.Tensor,
              prec: Precision = F32) -> torch.Tensor:
    """The released ``Aggregate`` (no projection): ``m + gamma * attn
    to_v(m)``, NCHW."""
    v = prec.q(_project(p, "aggregator.to_v", m, prec))
    n, c, h, w = v.shape
    out = torch.matmul(attn, v.reshape(n, c, h * w).transpose(1, 2))
    return m + p["aggregator.gamma"] * out.transpose(1, 2).reshape(
        n, c, h, w)


def _update(p, net, inp, corr, flow, attn, prec):
    """GMAUpdateBlock without its mask: motion encoder, aggregation,
    ConvGRU, flow head."""
    c = rap._c
    cor = F.relu(c(p, "menc.convc2", F.relu(c(p, "menc.convc1", corr,
                                                prec)), prec))
    flo = F.relu(c(p, "menc.convf2", F.relu(c(p, "menc.convf1", flow,
                                                prec)), prec))
    mf = torch.cat([F.relu(c(p, "menc.conv", torch.cat([cor, flo], dim=1),
                             prec)), flow], dim=1)
    x = torch.cat([inp, mf, aggregate(p, attn, mf, prec)], dim=1)
    for k in (0, 3):  # the (1, 5) pass, then the (5, 1) pass
        hx = torch.cat([net, x], dim=1)
        z = torch.sigmoid(c(p, f"gru.convs.{k}", hx, prec))
        r = torch.sigmoid(c(p, f"gru.convs.{k + 1}", hx, prec))
        q = torch.tanh(c(p, f"gru.convs.{k + 2}",
                         torch.cat([r * net, x], dim=1), prec))
        net = (1 - z) * net + z * q
    delta = c(p, "flow_head_2", F.relu(c(p, "flow_head_1", net, prec)),
              prec)
    return net, delta


def forward(p: Params, cfg: dict, im1: torch.Tensor, im2: torch.Tensor,
            prec: Precision = F32) -> List[torch.Tensor]:
    """Inference: (N, H, W, 3) images in [0, 1], H and W divisible by 8 ->
    [the last iteration's (N, H, W, 2) pixel flow]. cuDNN picks each
    conv's algorithm by timing it (TF32 stays off): at a 135x240 grid its
    heuristic picks, for float32, an algorithm of about 33 thousand
    launches a call, and a forward took 9 s."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        return _forward(p, cfg, im1, im2, prec)


def _forward(p, cfg, im1, im2, prec):
    n = im1.shape[0]
    hid, ctxd = cfg["hidden_dim"], cfg["context_dim"]
    r, levels = cfg["corr_radius"], cfg["corr_levels"]
    image1, image2 = 2 * nchw(im1) - 1.0, 2 * nchw(im2) - 1.0
    fmap = rap.encoder(p, "fnet", torch.cat([image1, image2], dim=0),
                       "instance", prec)
    pyramid = [prec.q(t) for t in rap.corr_pyramid(
        prec.q(fmap[:n]), prec.q(fmap[n:]), levels)]
    cnet = rap.encoder(p, "cnet", image1, "batch", prec)
    net, inp = torch.split(cnet, [hid, ctxd], dim=1)
    net, inp = torch.tanh(net), F.relu(inp)
    attn = attention(p, inp, prec)
    h, w = fmap.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(h, device=im1.device),
                            torch.arange(w, device=im1.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], dim=0).float()[None].repeat(n, 1, 1, 1)
    coords1 = coords0.clone()
    for _ in range(cfg["iters"]):
        coords1 = coords1.detach()
        corr = rap.lookup(pyramid, coords1, r)
        flow = coords1 - coords0
        net, delta = _update(p, net, inp, corr, flow, attn, prec)
        coords1 = coords1 + delta
    mask = 0.25 * rap._c(p, "mask_head_2", F.relu(rap._c(
        p, "mask_head_1", net, prec)), prec)
    return [nhwc(rap.upsample_flow(coords1 - coords0, mask))]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's and batch-norm statistic's shape (OIHW weights),
    by the port's key: published RAFT's, the GRU over 128 more input
    channels, and the attention's."""
    shapes = rap.param_shapes(cfg)
    hid, ctxd, d = cfg["hidden_dim"], cfg["context_dim"], cfg["dim_head"]
    for k, (kh, kw) in enumerate(((1, 5),) * 3 + ((5, 1),) * 3):
        shapes[f"gru.convs.{k}.weight"] = (hid, hid + ctxd + 256, kh, kw)
    shapes["att.to_qk.weight"] = (2 * d, ctxd, 1, 1)
    shapes["aggregator.to_v.weight"] = (128, 128, 1, 1)
    shapes["aggregator.gamma"] = (1,)
    return shapes
