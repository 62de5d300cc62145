"""Wrapper of the correlation-forward CUDA kernel (``csrc/cost_volume.cu``).

Counterpart of ``pwcnet_tpu/ops/pallas/cost_volume_kernel.py``
(``_corr_fwd_kernel``). The plain version is
``pwcnet_tpu_torch.ops.cost_volume.cost_volume_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch.ops.kernels.build import load_library

SOURCE = "pwcnet_tpu_torch/csrc/cost_volume.cu"
REPLACES = "pwcnet_tpu/ops/pallas/cost_volume_kernel.py:116"
MAX_DISPLACEMENT = 4  # the kernel is built for 1 <= d <= 4

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load_library("cost_volume").pwc_cost_volume_fwd
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def cost_volume_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 4) -> torch.Tensor:
    """(N, H, W, C) x 2 on one CUDA device -> (N, H, W, (2d+1)^2)."""
    global LAUNCHES
    d = max_displacement
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError("cost_volume_cuda takes two tensors on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype not in (torch.float32, torch.bfloat16) or f2.dtype != f1.dtype:
        raise TypeError(f"f32 or bf16 inputs of one type expected, got "
                        f"{f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape or min(f1.shape) < 1:
        raise ValueError(f"shapes {tuple(f1.shape)} and {tuple(f2.shape)}: "
                         "two equal non-empty (N, H, W, C) expected")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost_volume_cuda needs contiguous NHWC inputs")
    if not 1 <= d <= MAX_DISPLACEMENT:
        raise ValueError(f"max_displacement must be in 1..{MAX_DISPLACEMENT},"
                         f" got {d}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise NotImplementedError("the correlation kernel has no backward "
                                  "yet: call it under torch.no_grad()")
    n, h, w, c = f1.shape
    out = torch.empty((n, h, w, (2 * d + 1) ** 2), dtype=f1.dtype,
                      device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), n, h, w, c,
                    d, int(f1.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"cost_volume kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
