"""Wrapper of the small-channel conv CUDA kernel (K7) and its autograd
Function.

Counterpart of ``pwcnet_tpu/ops/pallas/conv_kernel.py``: ``_kernel_folded``
(``csrc/conv_folded.cu``, a direct 3x3 conv on NHWC with XLA SAME padding,
the bias and the optional LeakyReLU fused, f32 sums; bf16 on the tensor
cores through ``csrc/conv3x3_mma.cuh``) and ``_conv_bwd``,
whose backward is autograd of the plain version
``pwcnet_tpu_torch.ops.conv_folded.conv_ref``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pwcnet_tpu_torch.ops.conv import _same_pads
from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/conv_folded.cu"
REPLACES = "pwcnet_tpu/ops/pallas/conv_kernel.py:148"
MAX_WEIGHTS = 12288  # 9 * Ci * Co, the kernel's shared-memory weight table

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = {"conv_folded": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fwd_fn():
    fn = load_library("conv_folded").pwc_conv_folded_fwd
    fn.argtypes = [_P] * 4 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
    fn.restype = _I
    return fn


def conv_folded_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     stride: int = 1, slope: Optional[float] = None
                     ) -> torch.Tensor:
    """K7: NHWC ``x`` (N, H, W, Ci), HWIO ``w`` (3, 3, Ci, Co), ``b`` (Co,)
    on one CUDA device -> (N, ceil(H/s), ceil(W/s), Co) in x's dtype. No
    autograd: ``conv_folded_fn`` is the differentiable entry."""
    if not (x.is_cuda and w.device == x.device and b.device == x.device):
        raise ValueError(f"K7 takes tensors on one CUDA device, got "
                         f"{x.device}, {w.device} and {b.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 input expected, got {x.dtype}")
    if x.dim() != 4 or min(x.shape) < 1 or not x.is_contiguous():
        raise ValueError(f"x {tuple(x.shape)}: a contiguous non-empty "
                         "(N, H, W, C) expected")
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    if tuple(w.shape) != (3, 3, ci, co) or tuple(b.shape) != (co,):
        raise ValueError(f"w {tuple(w.shape)}, b {tuple(b.shape)}: (3, 3, "
                         f"{ci}, Co) and (Co,) expected")
    if 9 * ci * co > MAX_WEIGHTS or stride not in (1, 2):
        raise ValueError(f"K7 takes 9 * Ci * Co <= {MAX_WEIGHTS} and stride "
                         f"1 or 2, got Ci={ci}, Co={co}, stride={stride}")
    if x.dtype == torch.bfloat16:  # the tile stages x in 16-byte copies
        x = aligned16(x)
    ho, wo = -(-h // stride), -(-wd // stride)
    pt, pl = _same_pads(h, 3, stride, 1)[0], _same_pads(wd, 3, stride, 1)[0]
    wf = w.detach().to(x.dtype).float().contiguous()
    bf = b.detach().float().contiguous()
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_fn()(x.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                        out.data_ptr(), n, h, wd, ci, ho, wo, co, stride, pt,
                        pl, 0.0 if slope is None else float(slope),
                        int(slope is not None),
                        int(x.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"conv_folded kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["conv_folded"] += 1
    return out


class ConvFoldedFunction(torch.autograd.Function):
    """K7 forward; backward through autograd of ``conv_ref``."""

    @staticmethod
    def forward(ctx, x, w, b, stride, slope):
        ctx.args = (stride, slope)
        ctx.save_for_backward(x, w, b)
        return conv_folded_cuda(x, w, b, stride, slope)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.conv_folded import conv_ref
        stride, slope = ctx.args
        grads = autograd_of(
            lambda a, ww, bb: conv_ref(a, ww, bb, stride=stride, slope=slope),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return (*grads, None, None)


def conv_folded_fn(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int = 1, slope: Optional[float] = None
                   ) -> torch.Tensor:
    """The differentiable K7 on CUDA tensors (NHWC in and out)."""
    return ConvFoldedFunction.apply(x, w, b, stride, slope)
