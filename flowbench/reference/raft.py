"""RAFT (Teed and Deng, ECCV 2020, arXiv:2003.12039) at the widths the
configuration file gives, in plain float32 PyTorch, as a function of a
parameter dict keyed by the port's ``state_dict`` keys.

The configuration's departures from the paper hold here too: the lookup
is a local correlation of radius r at two scales (the 1/8 features and
their 2x2 average, the coarse one repeated 2x2), not the all-pairs
pyramid. Per iteration: the lookup at the detached flow, the motion
encoder, the separable ConvGRU (1x5 then 5x1), the flow head; at the end
the convex upsampling by 8 from the mask head (logits x 0.25).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowbench.reference.ops import (F32, Precision, conv, correlation,
                                     lrelu, nchw, nhwc, warp)

Params = Dict[str, torch.Tensor]
DIV = 8


def _c(p, key, x, prec, stride=1):
    return conv(x, p[key + ".weight"], p[key + ".bias"], prec, stride)


def encoder(p: Params, key: str, x: torch.Tensor, prec) -> torch.Tensor:
    x = lrelu(_c(p, f"{key}.conv0", x, prec, 2))
    for i, stride in enumerate((2, 2, 1)):
        b = f"{key}.blocks.{i}"
        y = _c(p, b + ".conv1", lrelu(_c(p, b + ".conv0", x, prec, stride)),
               prec)
        if b + ".conv2.weight" in p:
            x = _c(p, b + ".conv2", x, prec, stride)
        x = lrelu(x + y)
    return _c(p, f"{key}.conv1", x, prec)


def _gru(p, h, x, prec):
    for pass_ in range(2):
        k = 3 * pass_
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_c(p, f"gru.convs.{k}", hx, prec))
        r = torch.sigmoid(_c(p, f"gru.convs.{k + 1}", hx, prec))
        q = torch.tanh(_c(p, f"gru.convs.{k + 2}",
                          torch.cat([r * h, x], 1), prec))
        h = (1 - z) * h + z * q
    return h


def _motion(p, corr, flow, prec):
    c = lrelu(_c(p, "menc.convs.1", lrelu(_c(p, "menc.convs.0", corr,
                                              prec)), prec))
    f = lrelu(_c(p, "menc.convs.3", lrelu(_c(p, "menc.convs.2", flow,
                                              prec)), prec))
    out = lrelu(_c(p, "menc.convs.4", torch.cat([c, f], 1), prec))
    return torch.cat([out, flow], 1)


def convex_upsample(flow: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 2) flow, (N, h, w, 9 * 64) logits -> (N, 8h, 8w, 2)."""
    n, h, w, _ = flow.shape
    m = torch.softmax(logits.reshape(n, h, w, 9, DIV * DIV), dim=3)
    pad = F.pad(flow * DIV, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack([pad[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], 3)
    up = (m[..., None] * nbrs[:, :, :, :, None, :]).sum(3)
    return up.reshape(n, h, w, DIV, DIV, 2).permute(
        0, 1, 3, 2, 4, 5).reshape(n, h * DIV, w * DIV, 2)


def forward(p: Params, cfg: dict, im1: torch.Tensor, im2: torch.Tensor,
            prec: Precision = F32) -> List[torch.Tensor]:
    """Inference: (N, H, W, 3) images, H and W divisible by 16 -> [the
    last iteration's (N, H, W, 2) pixel flow]."""
    n = im1.shape[0]
    hid, r = cfg["hidden_dim"], cfg["corr_radius"]
    fmap = encoder(p, "fnet", nchw(torch.cat([im1, im2], 0)), prec)
    f1, f2 = fmap[:n], fmap[n:]
    f1h, f2h = F.avg_pool2d(f1, 2), F.avg_pool2d(f2, 2)
    ctx = encoder(p, "cnet", nchw(im1), prec)
    h = torch.tanh(ctx[:, :hid])
    context = lrelu(ctx[:, hid:])
    f1, f1h, f2, f2h = (nhwc(t) for t in (f1, f1h, f2, f2h))
    flow = f1.new_zeros(f1.shape[:3] + (2,))
    for _ in range(cfg["iters"]):
        fl = flow.detach()
        c0 = correlation(f1, warp(f2, fl), r, prec)
        c1 = correlation(f1h, warp(f2h, fl[:, ::2, ::2] * 0.5), r, prec)
        c1 = c1.repeat_interleave(2, 1).repeat_interleave(2, 2)
        corr = lrelu(torch.cat([c0, c1], -1))
        m = _motion(p, nchw(corr), nchw(flow), prec)
        h = _gru(p, h, torch.cat([context, m], 1), prec)
        delta = _c(p, "flow_head_2", lrelu(_c(p, "flow_head_1", h, prec)),
                   prec)
        flow = flow + nhwc(delta)
    logits = 0.25 * _c(p, "mask_head_2", lrelu(_c(p, "mask_head_1", h,
                                                   prec)), prec)
    return [convex_upsample(flow, nhwc(logits))]


def full_res(cfg: dict, flows: List[torch.Tensor],
             hw: Tuple[int, int]) -> torch.Tensor:
    """The flows are at the input size already."""
    if tuple(flows[-1].shape[1:3]) != tuple(hw):
        raise ValueError("the reference RAFT returns input-size flows")
    return flows[-1]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape (OIHW weights), by the port's key."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def add(key, cin, cout, kh=3, kw=None):
        shapes[key + ".weight"] = (cout, cin, kh, kh if kw is None else kw)
        shapes[key + ".bias"] = (cout,)

    hid, ctxd, feat = cfg["hidden_dim"], cfg["context_dim"], cfg["feature_dim"]
    for key, dim in (("fnet", feat), ("cnet", hid + ctxd)):
        add(f"{key}.conv0", 3, 32, 7)
        cin = 32
        for i, (cout, stride) in enumerate(((48, 2), (dim, 2), (dim, 1))):
            b = f"{key}.blocks.{i}"
            add(b + ".conv0", cin, cout)
            add(b + ".conv1", cout, cout)
            if cin != cout or stride != 1:
                add(b + ".conv2", cin, cout, 1)
            cin = cout
        add(f"{key}.conv1", dim, dim, 1)
    cin = hid + ctxd + 96
    for k, (kh, kw) in enumerate(((1, 5),) * 3 + ((5, 1),) * 3):
        add(f"gru.convs.{k}", cin, hid, kh, kw)
    ncorr = 2 * (2 * cfg["corr_radius"] + 1) ** 2
    for k, (cin_, cout, ks) in enumerate(((ncorr, 96, 1), (96, 64, 3),
                                          (2, 64, 7), (64, 32, 3),
                                          (96, 94, 3))):
        add(f"menc.convs.{k}", cin_, cout, ks)
    add("flow_head_1", hid, 128)
    add("flow_head_2", 128, 2)
    add("mask_head_1", hid, 128)
    add("mask_head_2", 128, 9 * DIV * DIV, 1)
    return shapes
