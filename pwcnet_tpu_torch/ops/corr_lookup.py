"""Lookup in the all-pairs correlation pyramid: RAFT's CorrBlock sampling
(port-only; the JAX package has no all-pairs volume).

For each pixel of the (h, w) grid and each level l, the level's map of that
pixel is sampled bilinearly, zero outside, at the (2r + 1)^2 points of a
window around ``coords / 2**l`` (pixel units, as ``grid_sample`` with
``align_corners=True``). The window is RAFT's ``meshgrid(dy, dx)`` added to
(x, y), so output channel ``l (2r+1)^2 + a (2r+1) + b`` samples at
(x + a - r, y + b - r): the first window index moves x. Samples are f32,
rounded once to the pyramid's dtype. On the GPU K9
(``csrc/corr_lookup.cu``) computes it, differentiable through
``CorrLookupFunction`` (autograd of the plain version).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.kernels.corr_lookup_kernel import corr_lookup_fn


def bilinear_sampler(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """RAFT's ``bilinear_sampler``: ``img`` (B, 1, H, W), ``pts`` (B, a, b,
    2) pixel coordinates (x, y) -> (B, 1, a, b), ``grid_sample`` with
    ``align_corners=True`` and zeros outside. A map of one row or column
    gets a zero row or column appended first: normalizing by its size - 1
    would divide by zero, and a zero beside it is what zero padding
    samples."""
    hh, ww = img.shape[-2:]
    if hh == 1 or ww == 1:
        img = F.pad(img, (0, int(ww == 1), 0, int(hh == 1)))
        hh, ww = img.shape[-2:]
    x, y = pts.split(1, -1)
    grid = torch.cat([2 * x / (ww - 1) - 1, 2 * y / (hh - 1) - 1], -1)
    return F.grid_sample(img, grid, align_corners=True)


def corr_lookup_ref(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """Plain version: levels (N, h * w, h_l, w_l) and (N, h, w, 2)
    coordinates -> (N, h, w, L (2r + 1)^2) in the pyramid's dtype."""
    n, h, w, _ = coords.shape
    # RAFT's window: delta[a, b] = (a - r, b - r), added to (x, y).
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)[None]
    outs = []
    for lv, level in enumerate(pyramid):
        img = level.float().reshape(n * h * w, 1, *level.shape[-2:])
        centre = coords.float().reshape(n * h * w, 1, 1, 2) / 2 ** lv
        outs.append(bilinear_sampler(img, centre + delta).reshape(n, h, w,
                                                                  -1))
    return torch.cat(outs, -1).to(pyramid[0].dtype)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """The plain version on CPU tensors, K9 on CUDA tensors."""
    if coords.device.type == "cpu":
        return corr_lookup_ref(pyramid, coords, radius)
    return corr_lookup_fn(pyramid, coords, radius)
