"""Fused bilinear warp + correlation (counterpart of the public part of
``pwcnet_tpu/ops/pallas/warp_corr_kernel.py``).

``warp_corr(f1, f2, flow)`` is ``cost_volume(f1, warp_bilinear(f2, flow))``
in one op: the plain version on CPU tensors, K6 (``csrc/warp_corr.cu``) on
CUDA tensors, differentiable in f1, f2 and the flow. The warped rows are
rounded to the features' dtype before the f32 correlation, as in the
composed path. Unlike the Pallas entry, nothing falls back: the CUDA
kernel tiles W and takes any width.

``fused_is_profitable`` decides, per pyramid level, whether the model fuses
there; its default threshold ``FUSED_MIN_PIXELS`` comes from the H100 (see
below), not from the TPU.

``warp_corr_prepadded`` is the spatially sharded form (K6p,
``warp_corr_fused_prepadded`` in the JAX package): the correlation of f1
with the warp of a halo-extended shard, ``cost_volume_prepadded(f1,
warp_ext_ref(...))``, differentiable through autograd of that plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from pwcnet_tpu_torch.ops.cost_volume import (cost_volume_prepadded_ref,
                                              cost_volume_ref)
from pwcnet_tpu_torch.ops.kernels.warp_corr_kernel import (
    warp_corr_fn, warp_corr_prepadded_fn)
from pwcnet_tpu_torch.ops.warp import warp_bilinear, warp_ext_ref

# The smallest level (H x W pixels) at which the model fuses by default:
# chip_smoke.py's k6_crossover times K6 against warp_bilinear + K1 per
# warped level of a 448x1024 pair and of the 8 x 384x448 train step (bf16,
# NVIDIA H100 80GB HBM3, 700.00 W). With both on the tensor cores as banded
# products, K6's forward still wins at every measured level, the smallest
# of which is 12 x 14 = 168 px (by 7.4-31x: the composed path's warp is
# plain torch); forward + backward, where the two paths differ only by
# K6 - K1, it loses by at most 1.7%. See PERF.md, section 6.
FUSED_MIN_PIXELS = 168


def fused_is_profitable(h: int, w: int,
                        min_pixels: Optional[int] = None) -> bool:
    """Whether a level of h x w pixels fuses: ``min_pixels`` overrides the
    port's default ``FUSED_MIN_PIXELS`` (0 fuses every warped level)."""
    if min_pixels is None:
        min_pixels = FUSED_MIN_PIXELS
    return h * w >= min_pixels


def warp_corr_ref(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                  max_displacement: int = 4) -> torch.Tensor:
    """Plain version: the composed ops."""
    return cost_volume_ref(f1, warp_bilinear(f2, flow), max_displacement)


def warp_corr(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor, *,
              max_displacement: int = 4) -> torch.Tensor:
    """The plain version on CPU tensors, K6 on CUDA tensors."""
    if f1.shape != f2.shape:
        raise ValueError(f"shape mismatch {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)}")
    if f1.device.type == "cpu":
        return warp_corr_ref(f1, f2, flow, max_displacement)
    return warp_corr_fn(f1, f2, flow.contiguous(), max_displacement)


def warp_corr_prepadded_ref(f1: torch.Tensor, f2e: torch.Tensor,
                            flow_e: torch.Tensor, row0: int, h_global: int,
                            halo: int, max_displacement: int = 4
                            ) -> torch.Tensor:
    """Plain version of K6p: f1 (N, t, W, C); f2e (N, t + 2*halo, W, C),
    global rows [row0 - halo, row0 + t + halo); flow_e (N, t + 2d, W, 2),
    rows [row0 - d, row0 + t + d) -> (N, t, W, (2d+1)^2)."""
    d = max_displacement
    return cost_volume_prepadded_ref(
        f1, warp_ext_ref(f2e, flow_e, row0, h_global, halo, d), d)


def warp_corr_prepadded(f1: torch.Tensor, f2e: torch.Tensor,
                        flow_e: torch.Tensor, *, row0: int, h_global: int,
                        halo: int, max_displacement: int = 4
                        ) -> torch.Tensor:
    """The plain version on CPU tensors, K6p on CUDA tensors."""
    d = max_displacement
    t = f1.shape[1]
    if f2e.shape[1] != t + 2 * halo or flow_e.shape[1] != t + 2 * d:
        raise ValueError(f"f2e {tuple(f2e.shape)} and flow_e "
                         f"{tuple(flow_e.shape)}: t + 2*halo = "
                         f"{t + 2 * halo} and t + 2d = {t + 2 * d} rows "
                         "expected")
    if f1.device.type == "cpu":
        return warp_corr_prepadded_ref(f1, f2e, flow_e, row0, h_global, halo,
                                       d)
    return warp_corr_prepadded_fn(f1, f2e, flow_e.contiguous(), row0,
                                  h_global, halo, d)
