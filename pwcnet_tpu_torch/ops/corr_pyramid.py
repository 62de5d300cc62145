"""All-pairs correlation pyramid: RAFT's CorrBlock volume (port-only; the
JAX package has no all-pairs volume).

    level0[n, i, y, x] = sum_c f1[n, i, c] * f2[n, y, x, c] / sqrt(C)

for every pixel i of frame 1 (row-major over its (h, w) grid) and every
target pixel (y, x) of frame 2; level l is ``avg_pool2d(2, 2)`` of level
l - 1 over the target dimensions, floored, so (N, h * w, h >> l, w >> l).
Products, sums and pools are f32; each level is rounded once to the
features' dtype. On the GPU K8 (``csrc/corr_pyramid.cu``) computes it,
differentiable through ``CorrPyramidFunction`` (autograd of the plain
version).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.kernels.corr_pyramid_kernel import (
    check_levels, corr_pyramid_fn)


def corr_pyramid_ref(f1: torch.Tensor, f2: torch.Tensor,
                     levels: int = 4) -> List[torch.Tensor]:
    """Plain version: (N, h, w, C) x 2 -> ``levels`` tensors (N, h * w,
    h >> l, w >> l): a matmul over sqrt(C), then ``avg_pool2d``."""
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"features {tuple(f1.shape)} and {tuple(f2.shape)}: "
                         "two (N, h, w, C) of one shape expected")
    n, h, w, c = f1.shape
    check_levels(h, w, levels)
    a = f1.float().reshape(n, h * w, c)
    b = f2.float().reshape(n, h * w, c)
    lvl = (torch.matmul(a, b.transpose(1, 2)) * (1.0 / math.sqrt(c))
           ).reshape(n * h * w, 1, h, w)
    out = [lvl]
    for _ in range(levels - 1):
        lvl = F.avg_pool2d(lvl, 2, 2)
        out.append(lvl)
    return [t.reshape(n, h * w, *t.shape[-2:]).to(f1.dtype) for t in out]


def corr_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                 levels: int = 4) -> List[torch.Tensor]:
    """The plain version on CPU tensors, K8 on CUDA tensors."""
    if f1.device.type == "cpu":
        return corr_pyramid_ref(f1, f2, levels)
    return corr_pyramid_fn(f1, f2, levels)
