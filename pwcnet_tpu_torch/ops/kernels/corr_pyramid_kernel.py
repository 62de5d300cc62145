"""Wrapper of the all-pairs correlation pyramid CUDA kernel (K8,
``csrc/corr_pyramid.cu``) and its autograd Function.

A port-only kernel: the JAX package has no all-pairs volume. The plain
version is ``pwcnet_tpu_torch.ops.corr_pyramid.corr_pyramid_ref`` (a
matmul and ``avg_pool2d``); the Function's backward is autograd of it.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/corr_pyramid.cu"
MAX_LEVELS = 4

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = trace.counters("launches.corr_pyramid", ("corr_pyramid",))

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load_library("corr_pyramid").pwc_corr_pyramid
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def level_shapes(n: int, h: int, w: int, levels: int
                 ) -> List[Tuple[int, int, int, int]]:
    """The pyramid's levels: (n, h * w, h >> l, w >> l), as
    ``avg_pool2d(2, 2)`` floors them."""
    return [(n, h * w, h >> lv, w >> lv) for lv in range(levels)]


def check_levels(h: int, w: int, levels: int) -> None:
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be in 1..{MAX_LEVELS}, got {levels}")
    if (h >> (levels - 1)) < 1 or (w >> (levels - 1)) < 1:
        raise ValueError(f"a {h}x{w} grid has no level {levels - 1} "
                         f"(each level halves it, floored)")


def corr_pyramid_cuda(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4
                      ) -> List[torch.Tensor]:
    """K8: NHWC (N, h, w, C) features of both frames on one CUDA device ->
    the ``levels`` levels of their all-pairs correlation over sqrt(C), in
    the features' dtype. No autograd: ``corr_pyramid_fn`` is the
    differentiable entry."""
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError(f"K8 takes tensors on one CUDA device, got "
                         f"{f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"f32 or bf16 features of one type expected, got "
                        f"{f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape or min(f1.shape) < 1:
        raise ValueError(f"features {tuple(f1.shape)} and {tuple(f2.shape)}: "
                         "two non-empty (N, h, w, C) of one shape expected")
    n, h, w, c = f1.shape
    check_levels(h, w, levels)
    bf16 = f1.dtype == torch.bfloat16
    if bf16 and c % 8:
        raise ValueError(f"the bf16 K8 stages 8 channels at a time; C = {c}")
    f1, f2 = f1.contiguous(), f2.contiguous()
    if bf16:  # staged in 16-byte copies
        f1, f2 = aligned16(f1), aligned16(f2)
    outs = [torch.empty(s, dtype=f1.dtype, device=f1.device)
            for s in level_shapes(n, h, w, levels)]
    ptrs = [o.data_ptr() for o in outs] + [0] * (MAX_LEVELS - levels)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(f1.data_ptr(), f2.data_ptr(), *ptrs, n, h, w, c, levels,
                    int(bf16), stream)
    if err:
        raise RuntimeError(f"corr_pyramid kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["corr_pyramid"] += 1
    return outs


class CorrPyramidFunction(torch.autograd.Function):
    """K8 forward; backward through autograd of ``corr_pyramid_ref``."""

    @staticmethod
    def forward(ctx, f1, f2, levels):
        ctx.levels = levels
        ctx.save_for_backward(f1, f2)
        return tuple(corr_pyramid_cuda(f1, f2, levels))

    @staticmethod
    def backward(ctx, *grads):
        from pwcnet_tpu_torch.ops.corr_pyramid import corr_pyramid_ref

        def ref(a, b):
            return torch.cat([t.flatten() for t in
                              corr_pyramid_ref(a, b, ctx.levels)])
        g = torch.cat([t.flatten() for t in grads])
        df1, df2 = autograd_of(ref, ctx.saved_tensors, g,
                               ctx.needs_input_grad[:2])
        return df1, df2, None


def corr_pyramid_fn(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4
                    ) -> List[torch.Tensor]:
    """The differentiable all-pairs pyramid on CUDA tensors (K8)."""
    return list(CorrPyramidFunction.apply(f1, f2, levels))
