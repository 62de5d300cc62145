"""The norms of published RAFT's BasicEncoders, with the ReLU after each and
a residual block's join (port-only; the JAX package has no published
RAFT).

A norm is ``INSTANCE`` (instance norm, eps 1e-5, no affine: the mean and
biased variance over H, W of each image and channel) or ``(mul, add)``, the
f32 (C,) terms of a batch norm in its eval form. On an (N, C, H, W) tensor
of the model's dtype, in f32, rounded once to that dtype:

- instance norm: ``(x - mean) * rsqrt(var + eps)``;
- batch norm: ``x * mul + add``.

``encoder_norm(x, norm)`` is ``relu(norm(x))``; with ``skip`` it is a
block's end, ``relu(s + relu(norm(x)))``, where ``s`` is ``skip``
normalized by ``skip_norm`` (the down path's norm) or ``skip`` itself.
CUDA tensors take K10 (``csrc/encoder_norm.cu``), in any layout (made
channels-last first): at most two launches a norm, differentiable through
``EncoderNormFunction`` (autograd of the plain version). CPU tensors take
the plain version, the torch ops one after another.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.kernels.encoder_norm_kernel import (
    INSTANCE, Norm, encoder_norm_fn)  # INSTANCE, Norm: re-exported

NORM_EPS = 1e-5  # torch's InstanceNorm2d and BatchNorm2d default


def norm_ref(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    """The norm alone, in f32, rounded to ``x``'s dtype (plain version)."""
    xf = x.float()
    if isinstance(norm, str):
        var, mean = torch.var_mean(xf, (2, 3), correction=0, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + NORM_EPS)).to(x.dtype)
    mul, add = norm
    return (xf * mul[:, None, None] + add[:, None, None]).to(x.dtype)


def encoder_norm_ref(x: torch.Tensor, norm: Norm,
                     skip: Optional[torch.Tensor] = None,
                     skip_norm: Optional[Norm] = None) -> torch.Tensor:
    """Plain version: the norm, the ReLU and the join as separate ops."""
    y = F.relu(norm_ref(x, norm))
    if skip is None:
        return y
    if skip_norm is not None:
        skip = norm_ref(skip, skip_norm)
    return F.relu(skip + y)


def encoder_norm(x: torch.Tensor, norm: Norm,
                 skip: Optional[torch.Tensor] = None,
                 skip_norm: Optional[Norm] = None) -> torch.Tensor:
    """The plain version on CPU tensors, K10 on CUDA tensors."""
    if x.device.type == "cpu":
        return encoder_norm_ref(x, norm, skip, skip_norm)
    cl = torch.channels_last
    if skip is not None:
        skip = skip.contiguous(memory_format=cl)
    return encoder_norm_fn(x.contiguous(memory_format=cl), norm, skip,
                           skip_norm)


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The bf16 step at |v| (f32), at least that of 2**-8."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -8))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def bf16_tolerance(x: torch.Tensor, norm: Norm,
                   skip: Optional[torch.Tensor] = None,
                   skip_norm: Optional[Norm] = None) -> torch.Tensor:
    """How far K10's bf16 instance norm may be from the plain version, per
    value (f32): its statistics differ from ``var_mean``'s by f32 rounding,
    so each rounding to bf16 may land one step away. A value is held to one
    bf16 step of each rounded term it is made from: the norm's value, the
    normalized skip's, their sum (values under 2**-8 to the step of 2**-8:
    there the f32 error of a mean several deviations off zero is that
    size)."""
    y = norm_ref(x, norm).float()
    tol = _bf16_step(y)
    if skip is not None:
        s = (skip if skip_norm is None else norm_ref(skip, skip_norm)).float()
        tol = tol + _bf16_step(s) + _bf16_step(s.abs() + y.abs())
    return tol
