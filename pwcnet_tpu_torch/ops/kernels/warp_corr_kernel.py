"""Wrapper of the fused warp + correlation CUDA kernel (K6) and its autograd
Function.

Counterpart of ``pwcnet_tpu/ops/pallas/warp_corr_kernel.py``: the forward
``_fused_kernel`` (``csrc/warp_corr.cu``, which gathers the bilinear corners
itself and takes (f1, f2, flow) directly), and the backward ``_wc_bwd``:
recompute the warped tensor, run the correlation backward kernels (K2, K3)
on it, and push the warped tensor's gradient to f2 and the flow through the
plain warp's autograd, as the JAX package leaves that part to XLA. The plain
version is ``pwcnet_tpu_torch.ops.warp_corr.warp_corr_ref``.

The bf16 kernel multiplies on the tensor cores as K1's banded products,
with the B tile blended from the corners in the kernel; ``band_plan`` gives
the tile and dy split a shape takes. The f32 kernel runs on the CUDA
cores, the correctness path.

K6p, the same kernel on a halo-extended shard (``_fused_forward(
rows_prepadded=True)``, entry ``warp_corr_fused_prepadded``), is the second
entry of ``csrc/warp_corr.cu``; it gathers the corners itself, with the
global masks and the halo-bound clamp of ``_warp_ext_corners``. Its
backward is autograd of the plain version ``warp_corr_prepadded_ref``, as
``_wc_pre_bwd`` differentiates the lax one.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import (
    _check_features, autograd_of, cost_volume_bwd_cuda)
from pwcnet_tpu_torch.ops.warp import warp_bilinear

SOURCE = "pwcnet_tpu_torch/csrc/warp_corr.cu"
REPLACES = "pwcnet_tpu/ops/pallas/warp_corr_kernel.py:97"
PRE_REPLACES = "pwcnet_tpu/ops/pallas/warp_corr_kernel.py:144"

# Kernel launches in this process; each wrapper adds one per launch.
LAUNCHES = {"warp_corr_fwd": 0, "warp_corr_fwd_prepadded": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int

Grads = Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
              Optional[torch.Tensor]]


def _fwd_fn():
    fn = load_library("warp_corr").pwc_warp_corr_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _fwd_pre_fn():
    fn = load_library("warp_corr").pwc_warp_corr_fwd_prepadded
    fn.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [_P]
    fn.restype = _I
    return fn


def band_plan(n: int, h: int, w: int, d: int = 4) -> Tuple[str, int]:
    """The bf16 K6's (and K6p's, at the shard's rows) launch at a shape: its
    tile (rows x columns of output a block takes) and the number of blocks
    the dy values are split over."""
    fn = load_library("warp_corr").pwc_warp_corr_band_plan
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    tile = _I()
    groups = fn(n, h, w, d, ctypes.byref(tile))
    return ("2x32", "1x32", "1x16", "4x16", "8x16")[tile.value], groups


def warp_corr_cuda(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                   max_displacement: int = 4) -> torch.Tensor:
    """K6: ``cost_volume(f1, warp_bilinear(f2, flow))`` for (N, H, W, C)
    features and an f32 (N, H, W, 2) flow in pixels, all on one CUDA
    device -> (N, H, W, (2d+1)^2). No autograd: ``warp_corr_fn`` is the
    differentiable entry."""
    d = max_displacement
    _check_features(f1, f2, d)
    if flow.device != f1.device or flow.dtype != torch.float32:
        raise TypeError(f"the flow must be f32 on {f1.device}, got "
                        f"{flow.dtype} on {flow.device}")
    n, h, w, c = f1.shape
    if tuple(flow.shape) != (n, h, w, 2) or not flow.is_contiguous():
        raise ValueError(f"flow {tuple(flow.shape)}: a contiguous "
                         f"{(n, h, w, 2)} expected")
    if f1.dtype == torch.bfloat16:  # staged and gathered in 16-byte copies
        f1, f2 = aligned16(f1), aligned16(f2)
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=f1.dtype,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(f1.data_ptr(), f2.data_ptr(), flow.data_ptr(),
                        out.data_ptr(), n, h, w, c, d,
                        int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"warp_corr kernel launch failed: CUDA error {err}")
    LAUNCHES["warp_corr_fwd"] += 1
    return out


def warp_corr_prepadded_cuda(f1: torch.Tensor, f2e: torch.Tensor,
                             flow_e: torch.Tensor, row0: int, h_global: int,
                             halo: int, max_displacement: int = 4
                             ) -> torch.Tensor:
    """K6p: ``warp_corr_prepadded_ref`` on one CUDA device. f1 (N, t, W, C);
    f2e (N, t + 2*halo, W, C), global rows [row0 - halo, row0 + t + halo);
    f32 flow_e (N, t + 2d, W, 2), rows [row0 - d, row0 + t + d) ->
    (N, t, W, (2d+1)^2). No autograd: ``warp_corr_prepadded_fn`` is the
    differentiable entry."""
    d = max_displacement
    _check_features(f1, f2e, d, 2 * halo)
    n, t, w, c = f1.shape
    if flow_e.device != f1.device or flow_e.dtype != torch.float32:
        raise TypeError(f"the flow must be f32 on {f1.device}, got "
                        f"{flow_e.dtype} on {flow_e.device}")
    if tuple(flow_e.shape) != (n, t + 2 * d, w, 2) \
            or not flow_e.is_contiguous():
        raise ValueError(f"flow {tuple(flow_e.shape)}: a contiguous "
                         f"{(n, t + 2 * d, w, 2)} expected")
    if not (0 <= row0 and row0 + t <= h_global and halo >= d):
        raise ValueError(f"row0={row0}, t={t}, h_global={h_global}, "
                         f"halo={halo}: a shard inside the image with "
                         "halo >= d expected")
    if f1.dtype == torch.bfloat16:
        f1, f2e = aligned16(f1), aligned16(f2e)
    out = torch.empty((n, t, w, (2 * d + 1) ** 2), dtype=f1.dtype,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_pre_fn()(f1.data_ptr(), f2e.data_ptr(), flow_e.data_ptr(),
                            out.data_ptr(), n, t, w, c, d, t + 2 * halo,
                            row0, h_global, halo,
                            int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"warp_corr_prepadded kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["warp_corr_fwd_prepadded"] += 1
    return out


def warp_corr_backward(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                       flow: torch.Tensor, max_displacement: int,
                       corr_bwd: Callable, needs: Sequence[bool]) -> Grads:
    """The fused op's backward, as ``_wc_bwd``: recompute the warped tensor,
    take (df1, dwarped) from ``corr_bwd`` (the correlation's backward:
    ``cost_volume_bwd_cuda`` on the card, ``cost_volume_bwd_ref`` for the
    plain version), then (df2, dflow) from autograd through the warp.
    ``needs`` says which of (df1, df2, dflow) to compute; the others are
    None."""
    need_f1, need_f2, need_flow = needs
    need_warped = need_f2 or need_flow
    with torch.enable_grad():
        f2_ = f2.detach().requires_grad_(need_f2)
        flow_ = flow.detach().requires_grad_(need_flow)
        warped = warp_bilinear(f2_, flow_)
    df1, dwarped = corr_bwd(g, f1, warped.detach(), max_displacement,
                            need_f1, need_warped)
    df2 = dflow = None
    if need_warped:
        wrt = [t for t, need in ((f2_, need_f2), (flow_, need_flow)) if need]
        grads = list(torch.autograd.grad(warped, wrt, dwarped))
        df2 = grads.pop(0) if need_f2 else None
        dflow = grads.pop(0) if need_flow else None
    return df1, df2, dflow


class WarpCorrFunction(torch.autograd.Function):
    """K6 forward; backward through K2, K3 and the warp's autograd (the
    residuals are the inputs)."""

    @staticmethod
    def forward(ctx, f1, f2, flow, max_displacement):
        ctx.d = max_displacement
        ctx.save_for_backward(f1, f2, flow)
        return warp_corr_cuda(f1, f2, flow, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2, flow = ctx.saved_tensors
        df1, df2, dflow = warp_corr_backward(
            g, f1, f2, flow, ctx.d, cost_volume_bwd_cuda,
            ctx.needs_input_grad[:3])
        return df1, df2, dflow, None


def warp_corr_fn(f1: torch.Tensor, f2: torch.Tensor, flow: torch.Tensor,
                 max_displacement: int = 4) -> torch.Tensor:
    """The differentiable fused op on CUDA tensors (K6; K2, K3 when autograd
    asks for gradients)."""
    return WarpCorrFunction.apply(f1, f2, flow, max_displacement)


class WarpCorrPrepaddedFunction(torch.autograd.Function):
    """K6p forward; backward through autograd of the plain version."""

    @staticmethod
    def forward(ctx, f1, f2e, flow_e, row0, h_global, halo, max_displacement):
        ctx.args = (row0, h_global, halo, max_displacement)
        ctx.save_for_backward(f1, f2e, flow_e)
        return warp_corr_prepadded_cuda(f1, f2e, flow_e, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.warp_corr import warp_corr_prepadded_ref
        grads = autograd_of(
            lambda a, b, f: warp_corr_prepadded_ref(a, b, f, *ctx.args),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return (*grads, None, None, None, None)


def warp_corr_prepadded_fn(f1: torch.Tensor, f2e: torch.Tensor,
                           flow_e: torch.Tensor, row0: int, h_global: int,
                           halo: int, max_displacement: int = 4
                           ) -> torch.Tensor:
    """The differentiable K6p on CUDA tensors."""
    return WarpCorrPrepaddedFunction.apply(f1, f2e, flow_e, row0, h_global,
                                           halo, max_displacement)
