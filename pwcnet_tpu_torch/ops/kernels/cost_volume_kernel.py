"""Wrappers of the correlation CUDA kernels and their autograd Function.

Counterpart of ``pwcnet_tpu/ops/pallas/cost_volume_kernel.py``: the forward
``_corr_fwd_kernel`` (K1, ``csrc/cost_volume.cu``) and the backward
``_corr_bwd_f1_kernel`` / ``_corr_bwd_f2_kernel`` (K2, K3,
``csrc/cost_volume_bwd.cu``), tied together as ``_cost_volume_pallas``'s
``custom_vjp`` ties them. The plain version is
``pwcnet_tpu_torch.ops.cost_volume.cost_volume_ref`` (its gradients are
autograd's).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pwcnet_tpu_torch.ops.kernels.build import load_library

SOURCE = "pwcnet_tpu_torch/csrc/cost_volume.cu"
REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:116"
BWD_SOURCE = "pwcnet_tpu_torch/csrc/cost_volume_bwd.cu"
BWD_F1_REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:187"
BWD_F2_REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:203"
MAX_DISPLACEMENT = 4  # the kernels are built for 1 <= d <= 4

# Kernel launches in this process; each wrapper adds one per launch.
LAUNCHES = {"corr_fwd": 0, "corr_bwd_f1": 0, "corr_bwd_f2": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fwd_fn():
    fn = load_library("cost_volume").pwc_cost_volume_fwd
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _bwd_fn():
    fn = load_library("cost_volume_bwd").pwc_cost_volume_bwd
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_features(f1: torch.Tensor, f2: torch.Tensor, d: int) -> None:
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError("the correlation kernels take tensors on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"f32 or bf16 inputs of one type expected, got "
                        f"{f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape or min(f1.shape) < 1:
        raise ValueError(f"shapes {tuple(f1.shape)} and {tuple(f2.shape)}: "
                         "two equal non-empty (N, H, W, C) expected")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the correlation kernels need contiguous NHWC "
                         "inputs")
    if not 1 <= d <= MAX_DISPLACEMENT:
        raise ValueError(f"max_displacement must be in 1..{MAX_DISPLACEMENT},"
                         f" got {d}")


def cost_volume_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 4) -> torch.Tensor:
    """K1: (N, H, W, C) x 2 on one CUDA device -> (N, H, W, (2d+1)^2).
    No autograd: ``cost_volume_fn`` is the differentiable entry."""
    d = max_displacement
    _check_features(f1, f2, d)
    n, h, w, c = f1.shape
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=f1.dtype,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w,
                        c, d, int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"cost_volume kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["corr_fwd"] += 1
    return out


def _bwd_launch(g: torch.Tensor, feat: torch.Tensor, d: int,
                which: int) -> torch.Tensor:
    n, h, w, c = feat.shape
    out = torch.empty_like(feat)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_fn()(g.data_ptr(), feat.data_ptr(), out.data_ptr(), n, h,
                        w, c, d, which, int(feat.dtype == torch.bfloat16),
                        stream)
    if err:
        raise RuntimeError(f"cost_volume backward kernel launch failed: CUDA "
                           f"error {err}")
    return out


def cost_volume_bwd_cuda(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                         max_displacement: int = 4, need_f1: bool = True,
                         need_f2: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3: the gradients (df1, df2) of the correlation for the
    output gradient ``g`` (N, H, W, (2d+1)^2), in the inputs' dtype. A
    gradient not asked for is None and its kernel is not launched."""
    d = max_displacement
    _check_features(f1, f2, d)
    n, h, w, _ = f1.shape
    if tuple(g.shape) != (n, h, w, (2 * d + 1) ** 2) or g.device != f1.device:
        raise ValueError(f"gradient {tuple(g.shape)} on {g.device} does not "
                         f"match the features {tuple(f1.shape)} and d={d}")
    g = g.to(f1.dtype).contiguous()
    df1 = df2 = None
    if need_f1:
        df1 = _bwd_launch(g, f2, d, 1)
        LAUNCHES["corr_bwd_f1"] += 1
    if need_f2:
        df2 = _bwd_launch(g, f1, d, 2)
        LAUNCHES["corr_bwd_f2"] += 1
    return df1, df2


class CostVolumeFunction(torch.autograd.Function):
    """K1 forward, K2 and K3 backward (the residuals are the inputs)."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        ctx.d = max_displacement
        ctx.save_for_backward(f1, f2)
        return cost_volume_cuda(f1, f2, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        df1, df2 = cost_volume_bwd_cuda(g, f1, f2, ctx.d,
                                        ctx.needs_input_grad[0],
                                        ctx.needs_input_grad[1])
        return df1, df2, None


def cost_volume_fn(f1: torch.Tensor, f2: torch.Tensor,
                   max_displacement: int = 4) -> torch.Tensor:
    """The differentiable correlation on CUDA tensors (K1; K2, K3 when
    autograd asks for gradients)."""
    return CostVolumeFunction.apply(f1, f2, max_displacement)
