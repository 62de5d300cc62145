"""Wrappers of the correlation CUDA kernels and their autograd Function.

Counterpart of ``pwcnet_tpu/ops/pallas/cost_volume_kernel.py``: the forward
``_corr_fwd_kernel`` (K1, ``csrc/cost_volume.cu``; bf16 on the tensor cores
as banded products, whose plain model is
``pwcnet_tpu_torch.ops.cost_volume.corr_band_ref``) and the backward
``_corr_bwd_f1_kernel`` / ``_corr_bwd_f2_kernel`` (K2, K3,
``csrc/cost_volume_bwd.cu``; bf16 on the tensor cores as banded products on
one tile, whose plain models are
``pwcnet_tpu_torch.ops.cost_volume.corr_bwd_f1_band_ref`` and
``corr_bwd_band_ref``), tied together as
``_cost_volume_pallas``'s ``custom_vjp`` ties them. The plain version is
``pwcnet_tpu_torch.ops.cost_volume.cost_volume_ref`` (its gradients are
autograd's).

K1p, the same forward on an f2 that carries d real halo rows
(``_corr_forward_pallas(rows_prepadded=True)``, entry
``cost_volume_pallas_prepadded``), is the second entry of
``csrc/cost_volume.cu``. Its backward is autograd of the plain version
``cost_volume_prepadded_ref``, as ``_cv_pre_bwd`` differentiates the lax one.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library

SOURCE = "pwcnet_tpu_torch/csrc/cost_volume.cu"
REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:116"
BWD_SOURCE = "pwcnet_tpu_torch/csrc/cost_volume_bwd.cu"
BWD_F1_REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:187"
BWD_F2_REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:203"
PRE_REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:134"
MAX_DISPLACEMENT = 4  # the kernels are built for 1 <= d <= 4

# Kernel launches in this process; each wrapper adds one per launch.
LAUNCHES = {"corr_fwd": 0, "corr_bwd_f1": 0, "corr_bwd_f2": 0,
            "corr_fwd_prepadded": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fwd_fn():
    fn = load_library("cost_volume").pwc_cost_volume_fwd
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _fwd_pre_fn():
    fn = load_library("cost_volume").pwc_cost_volume_fwd_prepadded
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def band_plan(n: int, h: int, w: int, d: int = 4) -> Tuple[str, int]:
    """The bf16 K1's launch at a shape: its tile (rows x columns of output
    a block takes) and the number of blocks the dy values are split over."""
    fn = load_library("cost_volume").pwc_cost_volume_band_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    tile = _I()
    groups = fn(n, h, w, d, ctypes.byref(tile))
    return ("2x32", "1x32", "1x16")[tile.value], groups


def bwd_band_plan(which: int, n: int, h: int, w: int,
                  c: int) -> Tuple[str, int]:
    """The bf16 K2's (``which`` 1) or K3's (2) launch at a shape: its tile
    (rows x columns of output a block takes) and the channels of a block's
    slice."""
    fn = load_library("cost_volume_bwd").pwc_cost_volume_bwd_band_plan
    fn.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    tile = _I()
    qw = fn(which, n, h, w, c, ctypes.byref(tile))
    return ("2x32", "1x32", "1x16", "4x16")[tile.value], 32 * qw


def _bwd_fn():
    fn = load_library("cost_volume_bwd").pwc_cost_volume_bwd
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check_features(f1: torch.Tensor, f2: torch.Tensor, d: int,
                    f2_extra_rows: int = 0) -> None:
    """f1 (N, H, W, C) and f2 (N, H + f2_extra_rows, W, C), contiguous, of
    one type, on one CUDA device."""
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError("the correlation kernels take tensors on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"f32 or bf16 inputs of one type expected, got "
                        f"{f1.dtype} and {f2.dtype}")
    want = f1.shape[:1] + (f1.shape[1] + f2_extra_rows,) + f1.shape[2:]
    if f1.dim() != 4 or f2.shape != want or min(f1.shape) < 1:
        raise ValueError(f"shapes {tuple(f1.shape)} and {tuple(f2.shape)}: "
                         f"non-empty (N, H, W, C) and (N, H + "
                         f"{f2_extra_rows}, W, C) expected")
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
    if f1.dtype == torch.bfloat16:  # staged in 16- and 8-byte copies
        f1, f2 = aligned16(f1), aligned16(f2)
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


def cost_volume_prepadded_cuda(f1: torch.Tensor, f2e: torch.Tensor,
                               max_displacement: int = 4) -> torch.Tensor:
    """K1p: f1 (N, H, W, C) and f2e (N, H + 2d, W, C), rows [-d, H + d) of
    the shard, on one CUDA device -> (N, H, W, (2d+1)^2). No autograd:
    ``cost_volume_prepadded_fn`` is the differentiable entry."""
    d = max_displacement
    _check_features(f1, f2e, d, 2 * d)
    if f1.dtype == torch.bfloat16:
        f1, f2e = aligned16(f1), aligned16(f2e)
    n, h, w, c = f1.shape
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=f1.dtype,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_pre_fn()(f1.data_ptr(), f2e.data_ptr(), out.data_ptr(), n,
                            h, w, c, d, int(f1.dtype == torch.bfloat16),
                            stream)
    if err:
        raise RuntimeError(f"cost_volume_prepadded kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["corr_fwd_prepadded"] += 1
    return out


def _bwd_launch(g: torch.Tensor, feat: torch.Tensor, d: int,
                which: int) -> torch.Tensor:
    if feat.dtype == torch.bfloat16:  # staged in 16- and 8-byte copies
        feat = aligned16(feat)
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


def autograd_of(ref, inputs, grad, needs):
    """Gradients of ``ref(*inputs)`` for the output gradient ``grad``,
    through autograd of a plain version; None where ``needs`` is False."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(bool(need))
                for t, need in zip(inputs, needs)]
        wrt = [a for a in args if a.requires_grad]
        grads = list(torch.autograd.grad(ref(*args), wrt, grad)) \
            if wrt else []
    return [grads.pop(0) if need else None for need in needs]


class CostVolumePrepaddedFunction(torch.autograd.Function):
    """K1p forward; backward through autograd of the plain version."""

    @staticmethod
    def forward(ctx, f1, f2e, max_displacement):
        ctx.d = max_displacement
        ctx.save_for_backward(f1, f2e)
        return cost_volume_prepadded_cuda(f1, f2e, max_displacement)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.cost_volume import cost_volume_prepadded_ref
        df1, df2e = autograd_of(
            lambda a, b: cost_volume_prepadded_ref(a, b, ctx.d),
            ctx.saved_tensors, g, ctx.needs_input_grad[:2])
        return df1, df2e, None


def cost_volume_prepadded_fn(f1: torch.Tensor, f2e: torch.Tensor,
                             max_displacement: int = 4) -> torch.Tensor:
    """The differentiable halo-row correlation on CUDA tensors (K1p)."""
    return CostVolumePrepaddedFunction.apply(f1, f2e, max_displacement)
