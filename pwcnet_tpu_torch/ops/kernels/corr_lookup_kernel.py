"""Wrapper of the all-pairs pyramid lookup CUDA kernel (K9,
``csrc/corr_lookup.cu``) and its autograd Function.

A port-only kernel: the JAX package has no all-pairs volume. The plain
version is ``pwcnet_tpu_torch.ops.corr_lookup.corr_lookup_ref``
(``grid_sample``, as RAFT's CorrBlock samples); the Function's backward is
autograd of it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.kernels.build import load_library
from pwcnet_tpu_torch.ops.kernels.corr_pyramid_kernel import (MAX_LEVELS,
                                                              level_shapes)
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/corr_lookup.cu"
MAX_RADIUS = 4

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = trace.counters("launches.corr_lookup", ("corr_lookup",))

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load_library("corr_lookup").pwc_corr_lookup
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def corr_lookup_cuda(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                     radius: int = 4) -> torch.Tensor:
    """K9: the pyramid of ``corr_pyramid_cuda`` (level l (N, h * w, h >> l,
    w >> l)) and (N, h, w, 2) f32 coordinates (x, y) on one CUDA device ->
    (N, h, w, L (2r + 1)^2) in the pyramid's dtype. No autograd:
    ``corr_lookup_fn`` is the differentiable entry."""
    levels = len(pyramid)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels expected, got {levels}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in 1..{MAX_RADIUS}, got {radius}")
    if coords.dim() != 4 or coords.shape[-1] != 2 or min(coords.shape) < 1:
        raise ValueError(f"coords {tuple(coords.shape)}: (N, h, w, 2) "
                         "expected")
    n, h, w, _ = coords.shape
    dtype = pyramid[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"an f32 or bf16 pyramid expected, got {dtype}")
    want = level_shapes(n, h, w, levels)
    for lv, (t, s) in enumerate(zip(pyramid, want)):
        if tuple(t.shape) != s or t.dtype != dtype:
            raise ValueError(f"level {lv}: {tuple(t.shape)} {t.dtype}, {s} "
                             f"{dtype} expected")
        if not (t.is_cuda and t.device == coords.device):
            raise ValueError("K9 takes tensors on one CUDA device")
    levels_c = [t.contiguous() for t in pyramid]
    coords = coords.float().contiguous()
    ch = levels * (2 * radius + 1) ** 2
    out = torch.empty((n, h, w, ch), dtype=dtype, device=coords.device)
    ptrs = [t.data_ptr() for t in levels_c] + [0] * (MAX_LEVELS - levels)
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(*ptrs, coords.data_ptr(), out.data_ptr(), n, h, w,
                    levels, radius, int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["corr_lookup"] += 1
    return out


class CorrLookupFunction(torch.autograd.Function):
    """K9 forward; backward through autograd of ``corr_lookup_ref``."""

    @staticmethod
    def forward(ctx, coords, radius, *pyramid):
        ctx.radius = radius
        ctx.save_for_backward(coords, *pyramid)
        return corr_lookup_cuda(pyramid, coords, radius)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.corr_lookup import corr_lookup_ref
        coords, *pyramid = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[2:])
        grads = autograd_of(
            lambda c, *p: corr_lookup_ref(p, c, ctx.radius),
            [coords, *pyramid], g, needs)
        return (grads[0], None, *grads[1:])


def corr_lookup_fn(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """The differentiable pyramid lookup on CUDA tensors (K9)."""
    return CorrLookupFunction.apply(coords, radius, *pyramid)
