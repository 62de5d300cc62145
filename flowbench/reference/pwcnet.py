"""PWC-Net (Sun et al., CVPR 2018, arXiv:1709.02371) in plain float32
PyTorch, as a function of a parameter dict whose keys are the port's
``state_dict`` keys.

The configuration file gives the sizes; the structure is the one the
configuration documents: a stride-2 conv pair per pyramid level, the
4-conv stem for levels 1-2, at each decoder level the warp of frame 2's
features by the upsampled flow, the local correlation (search range d),
LeakyReLU, the concat with frame 1's features and the flow, a straight
stack of estimator convs and a 3x3 flow conv (residual), and the dilated
context network at the output level. Images are NHWC in [0, 1]; flows
are in pixels / ``flow_scale``, coarsest first.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from flowbench.reference.ops import (F32, Precision, conv, correlation,
                                     lrelu, nchw, nhwc, upsample, warp)

Params = Dict[str, torch.Tensor]


def _block(p: Params, key: str, x, prec, stride=1, dilation=1):
    return lrelu(conv(x, p[key + ".weight"], p[key + ".bias"], prec, stride,
                      dilation))


def pyramid(p: Params, cfg: dict, x: torch.Tensor,
            prec: Precision) -> List[torch.Tensor]:
    """NCHW features of levels num_levels - output_level .. num_levels,
    coarsest first."""
    for i, stride in enumerate((2, 1, 2, 1), 1):
        x = _block(p, f"pyramid.stem.conv{i}", x, prec, stride)
    feats = [x]
    for k in range(2 * (cfg["num_levels"] - 2)):
        x = _block(p, f"pyramid.blocks.{k}.conv", x, prec, 2 - k % 2)
        if k % 2:
            feats.append(x)
    return feats[::-1]


def forward(p: Params, cfg: dict, im1: torch.Tensor, im2: torch.Tensor,
            prec: Precision = F32) -> List[torch.Tensor]:
    """(N, H, W, 3) f32 images, H and W divisible by 2 ** num_levels -> the
    per-level flows (N, H_l, W_l, 2), coarsest first."""
    n = im1.shape[0]
    pyr = pyramid(p, cfg, nchw(torch.cat([im1, im2], 0)), prec)
    d, scale = cfg["search_range"], cfg["flow_scale"]
    flows, flow = [], None
    for i in range(cfg["output_level"] + 1):
        level = cfg["num_levels"] - i
        f1, f2 = pyr[i][:n], pyr[i][n:]
        f1h, f2h = nhwc(f1), nhwc(f2)
        if flow is None:
            up = f1h.new_zeros(f1h.shape[:3] + (2,))
        else:
            up = upsample(flow, tuple(f1h.shape[1:3]))
            f2h = warp(f2h, up * (scale / 2.0 ** level))
        corr = correlation(f1h, f2h, d, prec)
        x = torch.cat([nchw(lrelu(corr)), f1, nchw(up)], 1)
        est = f"estimators.l{level}"
        for j in range(len(cfg["estimator_channels"])):
            x = _block(p, f"{est}.stack.blocks.{j}.conv", x, prec)
        flow = up + nhwc(conv(x, p[est + ".flow.weight"],
                              p[est + ".flow.bias"], prec))
        if i == cfg["output_level"]:
            y = torch.cat([x, nchw(flow)], 1)
            for j, (_, dil) in enumerate(cfg["context"]):
                y = _block(p, f"context.blocks.{j}.conv", y, prec,
                           dilation=dil)
            flow = flow + nhwc(conv(y, p["context.flow.weight"],
                                    p["context.flow.bias"], prec))
        flows.append(flow)
    return flows


def full_res(cfg: dict, flows: List[torch.Tensor],
             hw: Tuple[int, int]) -> torch.Tensor:
    """The finest flow, upsampled to ``hw`` and in pixels."""
    return upsample(flows[-1], hw) * cfg["flow_scale"]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape (OIHW weights), by the port's key."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def add(key, cin, cout, k=3):
        shapes[key + ".weight"] = (cout, cin, k, k)
        shapes[key + ".bias"] = (cout,)

    ch = cfg["pyramid_channels"]
    add("pyramid.stem.conv1", 3, ch[0])
    add("pyramid.stem.conv2", ch[0], ch[0])
    add("pyramid.stem.conv3", ch[0], ch[1])
    add("pyramid.stem.conv4", ch[1], ch[1])
    cin = ch[1]
    for lv in range(2, cfg["num_levels"]):
        add(f"pyramid.blocks.{2 * lv - 4}.conv", cin, ch[lv])
        add(f"pyramid.blocks.{2 * lv - 3}.conv", ch[lv], ch[lv])
        cin = ch[lv]
    ncorr = (2 * cfg["search_range"] + 1) ** 2
    est = cfg["estimator_channels"]
    for i in range(cfg["output_level"] + 1):
        level = cfg["num_levels"] - i
        cin = ncorr + ch[level - 1] + 2
        for j, cout in enumerate(est):
            add(f"estimators.l{level}.stack.blocks.{j}.conv", cin, cout)
            cin = cout
        add(f"estimators.l{level}.flow", cin, 2)
    cin = est[-1] + 2
    for j, (cout, _) in enumerate(cfg["context"]):
        add(f"context.blocks.{j}.conv", cin, cout)
        cin = cout
    add("context.flow", cin, 2)
    return shapes
