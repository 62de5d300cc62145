"""RAFT as published (Teed and Deng, ECCV 2020, arXiv:2003.12039), after the
released ``core/raft.py``, ``corr.py``, ``extractor.py`` and ``update.py``,
in plain float32 PyTorch, as a function of a parameter dict keyed by the
port's ``state_dict`` keys.

BasicEncoder with instance norm on both frames (``fnet``) and with batch
norm in its eval form on frame 1 (``cnet``); the all-pairs correlation
over sqrt(C) and its ``avg_pool2d`` pyramid; per iteration, at the
detached coordinates, the pyramid sampled by ``grid_sample``
(``align_corners=True``) in a window of radius r, the motion encoder, the
separable ConvGRU and the flow head; at the end the mask head (x 0.25) and
the convex upsampling x8. Every conv pads ``k // 2`` on both sides, as
the released ``nn.Conv2d``s do. The configuration's ``departures`` list
where this differs from the released code.

``prec.q`` is applied where the port rounds to its compute dtype: every
conv's input and weight, the features before the volume and each pyramid
level before the lookup.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowbench.reference.ops import F32, Precision, nchw, nhwc

Params = Dict[str, torch.Tensor]
DIV = 8
EPS = 1e-5
BLOCKS = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1),
          (96, 128, 2), (128, 128, 1))   # (in, planes, stride)


def _c(p: Params, key: str, x: torch.Tensor, prec: Precision,
       stride: int = 1) -> torch.Tensor:
    w = p[key + ".weight"]
    kh, kw = w.shape[-2:]
    return F.conv2d(prec.q(x), prec.q(w), p[key + ".bias"], stride=stride,
                    padding=(kh // 2, kw // 2))


def _norm(p: Params, key: str, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "instance":
        return F.instance_norm(x, eps=EPS)
    return F.batch_norm(x, p[key + ".running_mean"], p[key + ".running_var"],
                        p[key + ".weight"], p[key + ".bias"], False, 0.0,
                        EPS)


def encoder(p: Params, key: str, x: torch.Tensor, kind: str,
            prec: Precision) -> torch.Tensor:
    """The released BasicEncoder (NCHW): 1/8 resolution."""
    x = F.relu(_norm(p, f"{key}.norm1", _c(p, f"{key}.conv1", x, prec, 2),
                     kind))
    for i, (_, _, stride) in enumerate(BLOCKS):
        b = f"{key}.blocks.{i}"
        y = F.relu(_norm(p, b + ".norm1", _c(p, b + ".conv1", x, prec,
                                               stride), kind))
        y = F.relu(_norm(p, b + ".norm2", _c(p, b + ".conv2", y, prec),
                         kind))
        if stride != 1:
            x = _norm(p, b + ".norm3", _c(p, b + ".down", x, prec, stride),
                      kind)
        x = F.relu(x + y)
    return _c(p, f"{key}.conv2", x, prec)


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                 levels: int) -> List[torch.Tensor]:
    """CorrBlock's ``corr`` and pyramid: NCHW features -> levels (N h w, 1,
    h_l, w_l)."""
    n, c, h, w = f1.shape
    corr = torch.matmul(f1.reshape(n, c, h * w).transpose(1, 2),
                        f2.reshape(n, c, h * w))
    corr = (corr / torch.sqrt(torch.tensor(c).float())).reshape(
        n * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def bilinear_sampler(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The released ``bilinear_sampler``; a level of one row or column gets
    a zero row or column appended first (a departure: the released code
    divides by size - 1 = 0 there)."""
    h, w = img.shape[-2:]
    if h == 1 or w == 1:
        img = F.pad(img, (0, int(w == 1), 0, int(h == 1)))
        h, w = img.shape[-2:]
    xgrid, ygrid = pts.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    return F.grid_sample(img, torch.cat([xgrid, ygrid], dim=-1),
                         align_corners=True)


def lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
           r: int) -> torch.Tensor:
    """CorrBlock's ``__call__``: (N, 2, h, w) coordinates -> (N, L (2r+1)^2,
    h, w)."""
    coords = coords.permute(0, 2, 3, 1)
    n, h, w, _ = coords.shape
    out = []
    for i, corr in enumerate(pyramid):
        dx = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        dy = torch.linspace(-r, r, 2 * r + 1, device=coords.device)
        delta = torch.stack(torch.meshgrid(dy, dx, indexing="ij"), axis=-1)
        centroid = coords.reshape(n * h * w, 1, 1, 2) / 2 ** i
        pts = centroid + delta.view(1, 2 * r + 1, 2 * r + 1, 2)
        out.append(bilinear_sampler(corr, pts).view(n, h, w, -1))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().float()


def _update(p, net, inp, corr, flow, prec):
    """BasicUpdateBlock without its mask: motion encoder, ConvGRU, flow
    head."""
    cor = F.relu(_c(p, "menc.convc2", F.relu(_c(p, "menc.convc1", corr,
                                                  prec)), prec))
    flo = F.relu(_c(p, "menc.convf2", F.relu(_c(p, "menc.convf1", flow,
                                                  prec)), prec))
    out = F.relu(_c(p, "menc.conv", torch.cat([cor, flo], dim=1), prec))
    x = torch.cat([inp, out, flow], dim=1)
    for k in (0, 3):  # the (1, 5) pass, then the (5, 1) pass
        hx = torch.cat([net, x], dim=1)
        z = torch.sigmoid(_c(p, f"gru.convs.{k}", hx, prec))
        r = torch.sigmoid(_c(p, f"gru.convs.{k + 1}", hx, prec))
        q = torch.tanh(_c(p, f"gru.convs.{k + 2}",
                          torch.cat([r * net, x], dim=1), prec))
        net = (1 - z) * net + z * q
    delta = _c(p, "flow_head_2", F.relu(_c(p, "flow_head_1", net, prec)),
               prec)
    return net, delta


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The released convex upsampling: (N, 2, H, W) x 8, mask (N, 576, H,
    W)."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(n, 2, 8 * h, 8 * w)


def forward(p: Params, cfg: dict, im1: torch.Tensor, im2: torch.Tensor,
            prec: Precision = F32) -> List[torch.Tensor]:
    """Inference: (N, H, W, 3) images in [0, 1], H and W divisible by 8 ->
    [the last iteration's (N, H, W, 2) pixel flow]."""
    n = im1.shape[0]
    hid, ctxd = cfg["hidden_dim"], cfg["context_dim"]
    r, levels = cfg["corr_radius"], cfg["corr_levels"]
    image1, image2 = 2 * nchw(im1) - 1.0, 2 * nchw(im2) - 1.0
    fmap = encoder(p, "fnet", torch.cat([image1, image2], dim=0),
                   "instance", prec)
    pyramid = [prec.q(t) for t in corr_pyramid(prec.q(fmap[:n]),
                                               prec.q(fmap[n:]), levels)]
    cnet = encoder(p, "cnet", image1, "batch", prec)
    net, inp = torch.split(cnet, [hid, ctxd], dim=1)
    net, inp = torch.tanh(net), F.relu(inp)
    h, w = fmap.shape[-2:]
    ys, xs = torch.meshgrid(torch.arange(h, device=im1.device),
                            torch.arange(w, device=im1.device),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], dim=0).float()[None].repeat(n, 1, 1, 1)
    coords1 = coords0.clone()
    for _ in range(cfg["iters"]):
        coords1 = coords1.detach()
        corr = lookup(pyramid, coords1, r)
        flow = coords1 - coords0
        net, delta = _update(p, net, inp, corr, flow, prec)
        coords1 = coords1 + delta
    mask = 0.25 * _c(p, "mask_head_2", F.relu(_c(p, "mask_head_1", net,
                                                 prec)), prec)
    return [nhwc(upsample_flow(coords1 - coords0, mask))]


def full_res(cfg: dict, flows: List[torch.Tensor],
             hw: Tuple[int, int]) -> torch.Tensor:
    """The flows are at the input size already."""
    if tuple(flows[-1].shape[1:3]) != tuple(hw):
        raise ValueError("the reference RAFT returns input-size flows")
    return flows[-1]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's and batch-norm statistic's shape (OIHW weights),
    by the port's key."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(key, cin, cout, kh=3, kw=None):
        shapes[key + ".weight"] = (cout, cin, kh, kh if kw is None else kw)
        shapes[key + ".bias"] = (cout,)

    def norm(key, c, kind):
        if kind == "batch":
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{key}.{leaf}"] = (c,)

    hid, ctxd, feat = cfg["hidden_dim"], cfg["context_dim"], cfg["feature_dim"]
    for key, dim, kind in (("fnet", feat, "instance"),
                           ("cnet", hid + ctxd, "batch")):
        conv(f"{key}.conv1", 3, 64, 7)
        norm(f"{key}.norm1", 64, kind)
        for i, (cin, planes, stride) in enumerate(BLOCKS):
            b = f"{key}.blocks.{i}"
            conv(b + ".conv1", cin, planes)
            conv(b + ".conv2", planes, planes)
            norm(b + ".norm1", planes, kind)
            norm(b + ".norm2", planes, kind)
            if stride != 1:
                conv(b + ".down", cin, planes, 1)
                norm(b + ".norm3", planes, kind)
        conv(f"{key}.conv2", 128, dim, 1)
    ncorr = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    conv("menc.convc1", ncorr, 256, 1)
    conv("menc.convc2", 256, 192)
    conv("menc.convf1", 2, 128, 7)
    conv("menc.convf2", 128, 64)
    conv("menc.conv", 256, 126)
    for k, (kh, kw) in enumerate(((1, 5),) * 3 + ((5, 1),) * 3):
        conv(f"gru.convs.{k}", hid + ctxd + 128, hid, kh, kw)
    conv("flow_head_1", hid, 256)
    conv("flow_head_2", 256, 2)
    conv("mask_head_1", hid, 256)
    conv("mask_head_2", 256, 9 * DIV * DIV, 1)
    return shapes
