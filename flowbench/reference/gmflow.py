"""GMFlow with refinement (Xu, Zhang, Cai, Rezatofighi, Tao; CVPR 2022,
arXiv:2111.13680), after the released ``gmflow/backbone.py``,
``trident_conv.py``, ``position.py``, ``transformer.py``, ``matching.py``,
``gmflow.py``, ``utils.py`` and ``geometry.py``, run as the released Sintel
model with refinement (``--num_scales 2 --upsample_factor 4
--attn_splits_list 2 8 --corr_radius_list -1 4 --prop_radius_list -1 1``),
in plain float32 PyTorch, as a function of a parameter dict keyed by the
port's ``state_dict`` keys. It imports nothing of the port.

The released functions are kept as written: the CNN encoder with instance
norm and the trident conv; per scale the warp of frame 2's features by the
upsampled flow (``grid_sample``, zeros outside), the sine position
encoding of each window, the transformer over ``torch.roll``, window split
and merge with Swin's region mask, the global or local correlation softmax
and the self-attention flow propagation; the convex upsampling x4. At
1080x1920 (1088x1920 padded) the full score matrices in float32, 2.1 GB of
windowed scores at 1/8 and 2.1 GB at 1/4, 4.3 GB for the global matching
and 4.3 GB for the global propagation, fit on an 80 GB card, so nothing is
blocked. The
configuration's ``departures`` list where this differs from the released
code.

``prec.q`` is applied where the port rounds to its compute dtype: every
conv's and linear's input and weight, q, k and v before their products,
the transformer's attention probabilities before they weigh v, the
features before the correlation and the correlation itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowbench.reference import raft_allpairs as rap
from flowbench.reference.ops import F32, Precision, nchw, nhwc

Params = Dict[str, torch.Tensor]
EPS = 1e-5
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STAGES = ((64, 1), (96, 2), (128, 1))   # (planes, stride): 1/2, 1/4, 1/4
full_res = rap.full_res


# -- backbone ----------------------------------------------------------------

def _conv(p: Params, key: str, x: torch.Tensor, prec: Precision,
          stride: int = 1) -> torch.Tensor:
    w = p[key + ".weight"]
    kh = w.shape[-1]
    return F.conv2d(prec.q(x), prec.q(w), p.get(key + ".bias"),
                    stride=stride, padding=kh // 2)


def backbone(p: Params, x: torch.Tensor, prec: Precision
             ) -> List[torch.Tensor]:
    """The released ``CNNEncoder(num_output_scales=2)`` and its
    ``MultiScaleTridentConv``: [1/4, 1/8] features (NCHW)."""
    norm = lambda t: F.instance_norm(t, eps=EPS)   # noqa: E731
    x = F.relu(norm(_conv(p, "backbone.conv1", x, prec, 2)))
    cin, i = 64, 0
    for planes, stride in STAGES:
        for s in (stride, 1):
            b = f"backbone.blocks.{i}"
            y = F.relu(norm(_conv(p, b + ".conv1", x, prec, s)))
            y = F.relu(norm(_conv(p, b + ".conv2", y, prec)))
            if s != 1 or cin != planes:
                x = norm(_conv(p, b + ".down", x, prec, s))
            x = F.relu(x + y)
            cin, i = planes, i + 1
    x = _conv(p, "backbone.conv2", x, prec)
    w = prec.q(p["trident.weight"])
    return [F.conv2d(prec.q(x), w, stride=s, padding=1) for s in (1, 2)]


# -- transformer -------------------------------------------------------------

def _linear(p: Params, key: str, x: torch.Tensor,
            prec: Precision) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(p[key + ".weight"]),
                    p.get(key + ".bias"))


def split_feature(feature: torch.Tensor, num_splits: int,
                  channel_last: bool = False) -> torch.Tensor:
    """The released ``split_feature``: [B, C, H, W] (or [B, H, W, C]) ->
    [B * K * K, ...] windows, row-major."""
    if channel_last:
        b, h, w, c = feature.size()
        return feature.view(b, num_splits, h // num_splits, num_splits,
                            w // num_splits, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b * num_splits * num_splits,
                                      h // num_splits, w // num_splits, c)
    b, c, h, w = feature.size()
    return feature.view(b, c, num_splits, h // num_splits, num_splits,
                        w // num_splits).permute(
        0, 2, 4, 1, 3, 5).reshape(b * num_splits * num_splits, c,
                                  h // num_splits, w // num_splits)


def merge_splits(splits: torch.Tensor, num_splits: int,
                 channel_last: bool = False) -> torch.Tensor:
    """The released ``merge_splits``, the inverse of ``split_feature``."""
    if channel_last:
        b, h, w, c = splits.size()
        new_b = b // num_splits // num_splits
        return splits.view(new_b, num_splits, num_splits, h, w, c).permute(
            0, 1, 3, 2, 4, 5).contiguous().view(new_b, num_splits * h,
                                                num_splits * w, c)
    b, c, h, w = splits.size()
    new_b = b // num_splits // num_splits
    return splits.view(new_b, num_splits, num_splits, c, h, w).permute(
        0, 3, 1, 4, 2, 5).contiguous().view(new_b, c, num_splits * h,
                                            num_splits * w)


def shift_window_attn_mask(h: int, w: int, wh: int, ww: int, sh: int,
                           sw: int, device) -> torch.Tensor:
    """The released ``generate_shift_window_attn_mask`` (Swin's): -100
    between two regions of the rolled frame, 0 within one; [K * K, L, L]."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    windows = split_feature(img_mask, w // ww, channel_last=True).view(
        -1, wh * ww)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _attend(q, k, v, prec, mask=None):
    """softmax(q k^T / sqrt(C) + mask) v over [B, L, C] (the released
    ``single_head_full_attention`` with the split version's mask)."""
    c = q.size(2)
    scores = torch.matmul(prec.q(q), prec.q(k).permute(0, 2, 1)) / c ** 0.5
    if mask is not None:
        scores = scores + mask
    return torch.matmul(prec.q(torch.softmax(scores, dim=-1)), prec.q(v))


def split_window_attention(q, k, v, num_splits, with_shift, h, w, attn_mask,
                           prec):
    """The released ``single_head_split_window_attention``: [B, L, C]."""
    b, _, c = q.size()
    b_new = b * num_splits * num_splits
    wh, ww = h // num_splits, w // num_splits
    q, k, v = (t.view(b, h, w, c) for t in (q, k, v))
    if with_shift:
        sh, sw = wh // 2, ww // 2
        q, k, v = (torch.roll(t, shifts=(-sh, -sw), dims=(1, 2))
                   for t in (q, k, v))
    q, k, v = (split_feature(t, num_splits, channel_last=True)
               for t in (q, k, v))
    out = _attend(q.reshape(b_new, -1, c), k.reshape(b_new, -1, c),
                  v.reshape(b_new, -1, c), prec,
                  attn_mask.repeat(b, 1, 1) if with_shift else None)
    out = merge_splits(out.view(b_new, wh, ww, c), num_splits,
                       channel_last=True)
    if with_shift:
        out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
    return out.view(b, -1, c)


def _layer_norm(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[key + ".weight"],
                        p[key + ".bias"], EPS)


def transformer_layer(p, key, source, target, h, w, mask, splits, shift,
                      ffn, prec):
    """The released ``TransformerLayer`` (one head, Swin windows)."""
    query = _linear(p, key + ".q_proj", source, prec)
    k = _linear(p, key + ".k_proj", target, prec)
    v = _linear(p, key + ".v_proj", target, prec)
    if splits > 1:
        message = split_window_attention(query, k, v, splits, shift, h, w,
                                         mask, prec)
    else:
        message = _attend(query, k, v, prec)
    message = _layer_norm(p, key + ".norm1",
                          _linear(p, key + ".merge", message, prec))
    if ffn:
        hid = F.gelu(_linear(p, key + ".mlp.0",
                             torch.cat([source, message], dim=-1), prec))
        message = _layer_norm(p, key + ".norm2",
                              _linear(p, key + ".mlp.2", hid, prec))
    return source + message


def feature_transformer(p, cfg, feature0, feature1, splits, prec,
                        shift=True):
    """The released ``FeatureTransformer``: both frames as one batch, the
    odd blocks on shifted windows (none with ``shift=False``: the
    ``no_shift`` control). NCHW in and out."""
    b, c, h, w = feature0.shape
    feature0 = feature0.flatten(-2).permute(0, 2, 1)
    feature1 = feature1.flatten(-2).permute(0, 2, 1)
    wh, ww = h // splits, w // splits
    mask = (shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2,
                                   feature0.device) if splits > 1 else None)
    concat0 = torch.cat((feature0, feature1), dim=0)
    concat1 = torch.cat((feature1, feature0), dim=0)
    for i in range(cfg["num_transformer_layers"]):
        with_shift = shift and splits > 1 and i % 2 == 1
        key = f"transformer.{i}"
        concat0 = transformer_layer(p, key + ".self_attn", concat0, concat0,
                                    h, w, mask, splits, with_shift, False,
                                    prec)
        concat0 = transformer_layer(p, key + ".cross_attn_ffn", concat0,
                                    concat1, h, w, mask, splits, with_shift,
                                    True, prec)
        concat1 = torch.cat(concat0.chunk(chunks=2, dim=0)[::-1], dim=0)
    feature0, feature1 = concat0.chunk(chunks=2, dim=0)
    return (feature0.view(b, h, w, c).permute(0, 3, 1, 2).contiguous(),
            feature1.view(b, h, w, c).permute(0, 3, 1, 2).contiguous())


# -- position, matching, propagation, upsampling -----------------------------

def position_embedding_sine(x: torch.Tensor, num_pos_feats: int
                            ) -> torch.Tensor:
    """The released ``PositionEmbeddingSine`` (normalize=True, scale 2 pi,
    temperature 10000): [B, 2 num_pos_feats, H, W]."""
    b, c, h, w = x.size()
    mask = torch.ones((b, h, w), device=x.device)
    y_embed = mask.cumsum(1, dtype=torch.float32)
    x_embed = mask.cumsum(2, dtype=torch.float32)
    eps, scale = 1e-6, 2 * math.pi
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=x.device)
    dim_t = 10000 ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(),
                         pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
    pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(),
                         pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
    return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def feature_add_position(feature0, feature1, attn_splits, channels):
    """The released ``feature_add_position``: the encoding of each window
    (or of the whole frame, with one split) added to both frames."""
    if attn_splits > 1:
        f0 = split_feature(feature0, attn_splits)
        f1 = split_feature(feature1, attn_splits)
        position = position_embedding_sine(f0, channels // 2)
        return (merge_splits(f0 + position, attn_splits),
                merge_splits(f1 + position, attn_splits))
    position = position_embedding_sine(feature0, channels // 2)
    return feature0 + position, feature1 + position


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """The released ``coords_grid``: [B, 2, H, W], x then y."""
    y, x = torch.meshgrid(torch.arange(h, device=device),
                          torch.arange(w, device=device), indexing="ij")
    return torch.stack([x, y], dim=0).float()[None].repeat(b, 1, 1, 1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The released ``bilinear_sample``: zeros outside, align_corners."""
    _, _, h, w = coords.shape
    x_grid = 2 * coords[:, 0] / (w - 1) - 1
    y_grid = 2 * coords[:, 1] / (h - 1) - 1
    grid = torch.stack([x_grid, y_grid], dim=-1)
    return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def flow_warp(feature: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The released ``flow_warp`` (no mask)."""
    b, _, h, w = feature.size()
    return bilinear_sample(feature, coords_grid(b, h, w, flow.device) + flow)


def global_correlation_softmax(feature0, feature1, prec):
    """The released ``global_correlation_softmax``'s flow."""
    b, c, h, w = feature0.shape
    f0 = prec.q(feature0.view(b, c, -1).permute(0, 2, 1))
    f1 = prec.q(feature1.view(b, c, -1))
    correlation = torch.matmul(f0, f1).view(b, h, w, h, w) / (c ** 0.5)
    init_grid = coords_grid(b, h, w, feature0.device)
    grid = init_grid.view(b, 2, -1).permute(0, 2, 1)
    prob = F.softmax(correlation.view(b, h * w, h * w), dim=-1)
    correspondence = torch.matmul(prob, grid).view(b, h, w, 2).permute(
        0, 3, 1, 2)
    return correspondence - init_grid


def local_correlation_softmax(feature0, feature1, local_radius, prec):
    """The released ``local_correlation_softmax``'s flow."""
    b, c, h, w = feature0.size()
    coords_init = coords_grid(b, h, w, feature0.device)
    coords = coords_init.view(b, 2, -1).permute(0, 2, 1)
    r = local_radius
    d = torch.linspace(-r, r, 2 * r + 1, device=feature0.device)
    x, y = torch.meshgrid([d, d], indexing="ij")
    window_grid = torch.stack((x, y), -1).transpose(0, 1).float()
    window_grid = window_grid.reshape(-1, 2).repeat(b, 1, 1, 1)
    sample_coords = coords.unsqueeze(-2) + window_grid
    valid_x = (sample_coords[..., 0] >= 0) & (sample_coords[..., 0] < w)
    valid_y = (sample_coords[..., 1] >= 0) & (sample_coords[..., 1] < h)
    valid = valid_x & valid_y
    norm = torch.stack([2 * sample_coords[..., 0] / (w - 1) - 1,
                        2 * sample_coords[..., 1] / (h - 1) - 1], -1)
    window_feature = F.grid_sample(prec.q(feature1), norm,
                                   padding_mode="zeros",
                                   align_corners=True).permute(0, 2, 1, 3)
    feature0_view = prec.q(feature0).permute(0, 2, 3, 1).reshape(
        b, h * w, 1, c)
    corr = prec.q(torch.matmul(feature0_view, window_feature).view(
        b, h * w, -1) / (c ** 0.5))
    # The released ``corr[~valid] = -1e9``, without a data-dependent index
    # (so that the reference runs on meta tensors).
    corr = corr.masked_fill(~valid, -1e9)
    prob = F.softmax(corr, -1)
    correspondence = torch.matmul(prob.unsqueeze(-2), sample_coords
                                  ).squeeze(-2).view(b, h, w, 2).permute(
        0, 3, 1, 2)
    return correspondence - coords_init


def feature_flow_attention(p, feature0, flow, radius, prec):
    """The released ``FeatureFlowAttention``: global (``radius`` < 0, k
    the projection of the projected q) or over a (2 radius + 1)^2 window
    (k the projection of the features)."""
    b, c, h, w = feature0.size()
    fq = feature0.view(b, c, h * w).permute(0, 2, 1)
    query = _linear(p, "feature_flow_attn.q_proj", fq, prec)
    if radius < 0:
        key = _linear(p, "feature_flow_attn.k_proj", query, prec)
        value = flow.view(b, flow.size(1), h * w).permute(0, 2, 1)
        scores = torch.matmul(prec.q(query), prec.q(key).permute(0, 2, 1)) \
            / (c ** 0.5)
        out = torch.matmul(torch.softmax(scores, dim=-1), value)
        return out.view(b, h, w, value.size(-1)).permute(0, 3, 1, 2)
    k = 2 * radius + 1
    query = prec.q(query).reshape(b * h * w, 1, c)
    proj = _linear(p, "feature_flow_attn.k_proj", fq, prec).permute(
        0, 2, 1).reshape(b, c, h, w)
    window = F.unfold(prec.q(proj), kernel_size=k, padding=radius)
    window = window.view(b, c, k ** 2, h, w).permute(0, 3, 4, 1, 2).reshape(
        b * h * w, c, k ** 2)
    flow_window = F.unfold(flow, kernel_size=k, padding=radius)
    flow_window = flow_window.view(b, 2, k ** 2, h, w).permute(
        0, 3, 4, 2, 1).reshape(b * h * w, k ** 2, 2)
    prob = torch.softmax(torch.matmul(query, window) / (c ** 0.5), dim=-1)
    return torch.matmul(prob, flow_window).view(b, h, w, 2).permute(
        0, 3, 1, 2).contiguous()


def upsample_flow(p, flow, feature, factor, prec):
    """The released convex ``upsample_flow``: the upsampler on
    ``cat(flow, feature)``, a softmax over the 3x3 neighbours."""
    mask = _conv(p, "upsampler_2", F.relu(_conv(
        p, "upsampler_0", torch.cat((flow, feature), dim=1), prec)), prec)
    b, ch, h, w = flow.shape
    mask = torch.softmax(mask.view(b, 1, 9, factor, factor, h, w), dim=2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(b, ch, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, ch, factor * h, factor * w)


# -- the model ---------------------------------------------------------------

def forward(p: Params, cfg: dict, im1: torch.Tensor, im2: torch.Tensor,
            prec: Precision = F32, shift: bool = True) -> List[torch.Tensor]:
    """Inference: (N, H, W, 3) images in [0, 1], H and W divisible by 32 ->
    [each scale's flow after its propagation (1/8, 1/4; pixels of its
    grid), the (N, H, W, 2) pixel flow]. ``shift=False`` runs every block on
    unshifted windows (the benchmark's ``no_shift`` control). cuDNN picks
    each conv's algorithm by timing it, TF32 off (its heuristic for float32
    convs at full-HD grids can pick algorithms of tens of thousands of
    launches)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=False, allow_tf32=False):
        return _forward(p, cfg, im1, im2, prec, shift)


def _forward(p, cfg, im1, im2, prec, shift):
    c = cfg["feature_channels"]
    mean = torch.tensor(MEAN, device=im1.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=im1.device).view(1, 3, 1, 1)
    img0, img1 = (nchw(im1) - mean) / std, (nchw(im2) - mean) / std
    features = backbone(p, torch.cat((img0, img1), dim=0), prec)[::-1]
    flow = flow_up = None
    flows = []
    scales = len(cfg["attn_splits_list"])
    for s in range(scales):
        feature0, feature1 = torch.chunk(features[s], 2, 0)
        if s > 0:
            flow = F.interpolate(flow, scale_factor=2, mode="bilinear",
                                 align_corners=True) * 2
        if flow is not None:
            feature1 = flow_warp(feature1, flow)
        splits = cfg["attn_splits_list"][s]
        feature0, feature1 = feature_add_position(feature0, feature1, splits,
                                                  c)
        feature0, feature1 = feature_transformer(p, cfg, feature0, feature1,
                                                 splits, prec, shift)
        r = cfg["corr_radius_list"][s]
        pred = (global_correlation_softmax(feature0, feature1, prec) if r < 0
                else local_correlation_softmax(feature0, feature1, r, prec))
        flow = flow + pred if flow is not None else pred
        flow = feature_flow_attention(p, feature0, flow,
                                      cfg["prop_radius_list"][s], prec)
        flows.append(nhwc(flow))
        if s == scales - 1:
            flow_up = upsample_flow(p, flow, feature0,
                                    cfg["upsample_factor"], prec)
    return flows + [nhwc(flow_up)]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape (OIHW conv weights, (out, in) linear
    weights), by the port's key."""
    c, exp = cfg["feature_channels"], cfg["ffn_dim_expansion"]
    shapes: Dict[str, Tuple[int, ...]] = {}
    shapes["backbone.conv1.weight"] = (64, 3, 7, 7)
    cin, i = 64, 0
    for planes, stride in STAGES:
        for s in (stride, 1):
            b = f"backbone.blocks.{i}"
            shapes[b + ".conv1.weight"] = (planes, cin, 3, 3)
            shapes[b + ".conv2.weight"] = (planes, planes, 3, 3)
            if s != 1 or cin != planes:
                shapes[b + ".down.weight"] = (planes, cin, 1, 1)
                shapes[b + ".down.bias"] = (planes,)
            cin, i = planes, i + 1
    shapes["backbone.conv2.weight"] = (c, 128, 1, 1)
    shapes["backbone.conv2.bias"] = (c,)
    shapes["trident.weight"] = (c, c, 3, 3)
    for i in range(cfg["num_transformer_layers"]):
        for layer in ("self_attn", "cross_attn_ffn"):
            key = f"transformer.{i}.{layer}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                shapes[f"{key}.{proj}.weight"] = (c, c)
            shapes[key + ".norm1.weight"] = (c,)
            shapes[key + ".norm1.bias"] = (c,)
            if layer == "cross_attn_ffn":
                shapes[key + ".mlp.0.weight"] = (2 * c * exp, 2 * c)
                shapes[key + ".mlp.2.weight"] = (c, 2 * c * exp)
                shapes[key + ".norm2.weight"] = (c,)
                shapes[key + ".norm2.bias"] = (c,)
    for proj in ("q_proj", "k_proj"):
        shapes[f"feature_flow_attn.{proj}.weight"] = (c, c)
        shapes[f"feature_flow_attn.{proj}.bias"] = (c,)
    f2 = cfg["upsample_factor"] ** 2
    shapes["upsampler_0.weight"] = (256, 2 + c, 3, 3)
    shapes["upsampler_0.bias"] = (256,)
    shapes["upsampler_2.weight"] = (9 * f2, 256, 1, 1)
    shapes["upsampler_2.bias"] = (9 * f2,)
    return shapes
