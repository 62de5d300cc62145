"""Wrapper of the encoder norm CUDA kernels (K10, ``csrc/encoder_norm.cu``)
and their autograd Function.

A port-only kernel: the JAX package has no published RAFT. The plain
version is ``pwcnet_tpu_torch.ops.encoder_norm.encoder_norm_ref`` (the
norm, the ReLU and a residual block's join as separate torch ops); the
Function's backward is autograd of it.

A norm is ``INSTANCE`` (instance norm: the statistics launch makes its
terms) or a pair ``(mul, add)`` of f32 (C,) terms (batch norm in its eval
form). Each call is at most two launches on the current stream: the
statistics (instance norm only; one launch for the block's two inputs
where both are normalized) and the apply, which also takes the block's
second input where it joins.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/encoder_norm.cu"
INSTANCE = "instance"
MAX_C = 2048
MAX_HW = 1 << 24
MAX_CHUNKS = 64    # chunks of an image the statistics launch may split into

Norm = Union[str, Tuple[torch.Tensor, torch.Tensor]]

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = trace.counters("launches.encoder_norm", ("stats", "apply"))

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = load_library("encoder_norm")
    lib.pwc_encoder_norm_stats.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.pwc_encoder_norm_stats.restype = _I
    lib.pwc_encoder_norm_apply.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.pwc_encoder_norm_apply.restype = _I
    return lib


def _check_input(name: str, t: torch.Tensor) -> None:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: an f32 or bf16 tensor expected, got "
                        f"{t.dtype}")
    if t.dim() != 4 or min(t.shape) < 1:
        raise ValueError(f"{name} {tuple(t.shape)}: a non-empty (N, C, H, "
                         "W) tensor expected")
    n, c, h, w = t.shape
    if c % 8 or c > MAX_C:
        raise ValueError(f"{name}: C = {c}; K10 takes a multiple of 8 up to "
                         f"{MAX_C}")
    if h * w > MAX_HW or n > 65535:
        raise ValueError(f"{name} {tuple(t.shape)}: at most 65535 images of "
                         f"{MAX_HW} pixels")


def _check_norm(name: str, norm: Norm, c: int) -> None:
    if isinstance(norm, str):
        if norm != INSTANCE:
            raise ValueError(f"{name}: unknown norm {norm!r}")
        return
    if len(norm) != 2 or any(t.dtype != torch.float32 or t.shape != (c,)
                             or not t.is_contiguous() for t in norm):
        raise ValueError(f"{name}: (mul, add), contiguous f32 ({c},), "
                         "expected")


def _stats(xs, stream: int) -> Tuple[torch.Tensor, list]:
    """One statistics launch over one or two tensors of one shape: a
    scratch tensor holding their (N, C) (mean, rstd), and the pointer of
    each one's."""
    n, c, h, w = xs[0].shape
    m = n * len(xs)
    scratch = torch.empty(m * c * 2 * (1 + MAX_CHUNKS) + m,
                          dtype=torch.float32, device=xs[0].device)
    err = _lib().pwc_encoder_norm_stats(
        xs[0].data_ptr(), xs[1].data_ptr() if len(xs) > 1 else 0,
        scratch[m * c * 2:].data_ptr(), scratch[-m:].data_ptr(),
        scratch.data_ptr(), n, h * w, c, int(xs[0].dtype == torch.bfloat16),
        MAX_CHUNKS, stream)
    if err:
        raise RuntimeError(f"encoder_norm stats launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["stats"] += 1
    return scratch, [scratch[i * n * c * 2:].data_ptr()
                     for i in range(len(xs))]


def _pointers(norm: Optional[Norm], stats) -> list:
    """The apply's (stats, mul, add) pointers of one input's norm; ``stats``
    yields the statistics launch's, in order."""
    if norm is None:
        return [0, 0, 0]
    if isinstance(norm, str):
        return [next(stats), 0, 0]
    return [0, norm[0].data_ptr(), norm[1].data_ptr()]


def encoder_norm_cuda(x: torch.Tensor, norm: Norm,
                      skip: Optional[torch.Tensor] = None,
                      skip_norm: Optional[Norm] = None) -> torch.Tensor:
    """K10: ``relu(norm(x))``, or with ``skip`` ``relu(s + relu(norm(x)))``,
    ``s`` the skip normalized by ``skip_norm`` (None: as it is), on
    channels-last (N, C, H, W) CUDA tensors of one type and shape; the
    result channels-last in that type. No autograd: ``encoder_norm_fn`` is
    the differentiable entry."""
    _check_input("x", x)
    _check_norm("norm", norm, x.shape[1])
    if skip is None and skip_norm is not None:
        raise ValueError("skip_norm without a skip")
    if skip is not None:
        _check_input("skip", skip)
        if skip.shape != x.shape or skip.dtype != x.dtype:
            raise ValueError(f"skip {tuple(skip.shape)} {skip.dtype} does "
                             f"not match x {tuple(x.shape)} {x.dtype}")
        if skip_norm is not None:
            _check_norm("skip_norm", skip_norm, x.shape[1])
    tensors = [x] + ([] if skip is None else [skip]) + (
        [] if isinstance(norm, str) else list(norm)) + (
        [] if skip_norm is None or isinstance(skip_norm, str)
        else list(skip_norm))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("K10 takes tensors on one CUDA device")
    cl = torch.channels_last
    if not all(t.is_contiguous(memory_format=cl) for t in (x, skip)
               if t is not None):
        raise ValueError("K10 takes channels-last tensors")
    n, c, h, w = x.shape
    x = aligned16(x)
    skip = None if skip is None else aligned16(skip)
    out = torch.empty_like(x, memory_format=cl)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        # Instance norm's statistics: one launch for both inputs.
        inst = [t for t, nm in ((x, norm), (skip, skip_norm))
                if isinstance(nm, str)]
        _scratch, ptrs = _stats(inst, stream) if inst else (None, [])
        ptrs = iter(ptrs)
        tx, ts = _pointers(norm, ptrs), _pointers(skip_norm, ptrs)
        err = _lib().pwc_encoder_norm_apply(
            x.data_ptr(), *tx, 0 if skip is None else skip.data_ptr(), *ts,
            out.data_ptr(), n, h * w, c, int(x.dtype == torch.bfloat16),
            stream)
    if err:
        raise RuntimeError(f"encoder_norm apply launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["apply"] += 1
    return out


def _unpack(layout, tensors):
    """(x, norm, skip, skip_norm) from the Function's flat inputs."""
    it = iter(tensors)
    x = next(it)
    norm = INSTANCE if layout[0] else (next(it), next(it))
    skip = next(it) if layout[1] else None
    skip_norm = None
    if layout[2] is not None:
        skip_norm = INSTANCE if layout[2] else (next(it), next(it))
    return x, norm, skip, skip_norm


class EncoderNormFunction(torch.autograd.Function):
    """K10 forward; backward through autograd of ``encoder_norm_ref``.
    ``layout``: (norm is instance, has a skip, skip_norm is instance or
    None); the tensors follow it (x, mul, add, skip, mul, add)."""

    @staticmethod
    def forward(ctx, layout, *tensors):
        ctx.layout = layout
        ctx.save_for_backward(*tensors)
        return encoder_norm_cuda(*_unpack(layout, tensors))

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.encoder_norm import encoder_norm_ref
        grads = autograd_of(
            lambda *t: encoder_norm_ref(*_unpack(ctx.layout, t)),
            ctx.saved_tensors, g, ctx.needs_input_grad[1:])
        return (None, *grads)


def encoder_norm_fn(x: torch.Tensor, norm: Norm,
                    skip: Optional[torch.Tensor] = None,
                    skip_norm: Optional[Norm] = None) -> torch.Tensor:
    """The differentiable encoder norm on CUDA tensors (K10)."""
    def flat(nm):
        return [] if nm is None or isinstance(nm, str) else list(nm)
    layout = (isinstance(norm, str), skip is not None,
              None if skip_norm is None else isinstance(skip_norm, str))
    tensors = [x, *flat(norm)] + ([] if skip is None else [skip]) + \
        flat(skip_norm)
    return EncoderNormFunction.apply(layout, *tensors)
