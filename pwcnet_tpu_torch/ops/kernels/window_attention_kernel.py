"""Wrapper of GMFlow's window attention CUDA kernel (K12,
``csrc/window_attention.cu``) and its autograd Function.

A port-only kernel: the JAX package has no attention. The plain version is
``pwcnet_tpu_torch.ops.window_attention.window_attention_ref``; the
Function's backward is autograd of it. One launch a call, holding every
image and every window, on the current stream; ``LAUNCHES`` counts the
calls by kind: ``window`` (unshifted windows), ``shifted`` (Swin's shifted
windows) and ``global`` (one window over the whole grid).
"""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.kernels.build import load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/window_attention.cu"
DIM = 128           # q's and k's channels (GMFlow's one head)
VALUE_WIDTHS = (128, 2)

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = trace.counters("launches.window_attention",
                          ("window", "shifted", "global"))

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = load_library("window_attention")
    lib.pwc_window_attention.argtypes = ([_P] * 4 + [_I] * 8 + [_L] * 8
                                         + [_I, _P])
    lib.pwc_window_attention.restype = _I
    return lib


def check_windows(h: int, w: int, splits: int, shifted: bool) -> None:
    """Raise unless ``splits`` windows a side tile the (h, w) grid (and,
    shifted, each window is 2 x 2 tokens or more, with more than one)."""
    if splits < 1 or h % splits or w % splits:
        raise ValueError(f"{splits} x {splits} windows do not tile a "
                         f"{h} x {w} grid")
    if shifted and (splits == 1 or h // splits < 2 or w // splits < 2):
        raise ValueError(f"shifted windows need splits > 1 and windows of "
                         f"2 x 2 tokens or more; got {splits} splits of a "
                         f"{h} x {w} grid")


def _pixels(name: str, t: torch.Tensor, width: int, dtype: torch.dtype,
            align: int) -> torch.Tensor:
    """``t`` as the kernel reads it: (n, H, W, width) of ``dtype``, unit
    channel stride, pixel (y, x) at (y W + x) times the token pitch, pitch
    and image stride multiples of ``align`` elements and the start aligned
    to ``align`` elements; else a contiguous copy."""
    if t.dim() != 4 or t.shape[-1] != width:
        raise ValueError(f"{name} {tuple(t.shape)}: (n, H, W, {width}) "
                         "expected")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    n, h, w, _ = t.shape
    ld = t.stride(2)
    ok = (t.stride(3) == 1 and ld >= width and t.stride(1) == w * ld
          and ld % align == 0 and (n == 1 or t.stride(0) % align == 0)
          and t.data_ptr() % (align * t.element_size()) == 0)
    return t if ok else t.contiguous()


def _image_stride(t: torch.Tensor) -> int:
    """The stride between images, 0 for one image (never read)."""
    return t.stride(0) if t.shape[0] > 1 else 0


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          splits: int, shifted: bool = False,
                          kv_offset: int = 0) -> torch.Tensor:
    """K12: (bq, H, W, 128) queries, (bk, H, W, 128) keys, (bk, H, W, vw)
    values (vw 128 or 2) on one CUDA device -> the (bq, H, W, vw) attention
    of each query over its window's keys (``window_attention_ref``). q and
    k are bf16 or f32; v is q's dtype at vw = 128 and f32 at vw = 2. No
    autograd: ``window_attention_fn`` is the differentiable entry."""
    dev = q.device
    if not (dev.type == "cuda" and k.device == dev and v.device == dev):
        raise ValueError(f"K12 takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 expected, got {q.dtype}")
    vw = v.shape[-1]
    if vw not in VALUE_WIDTHS:
        raise ValueError(f"values of width {vw}: 128 or 2 expected")
    bf16 = q.dtype == torch.bfloat16
    vdtype = q.dtype if vw == DIM else torch.float32
    q = _pixels("q", q, DIM, q.dtype, 8 if bf16 else 1)
    k = _pixels("k", k, DIM, q.dtype, 8 if bf16 else 1)
    v = _pixels("v", v, vw, vdtype, 8 if vdtype == torch.bfloat16
                else (2 if bf16 else 1))
    bq, h, w, _ = q.shape
    bk = k.shape[0]
    if tuple(k.shape[1:3]) != (h, w) or tuple(v.shape[:3]) != (bk, h, w):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: one grid expected, k and v "
                         "of one batch")
    check_windows(h, w, splits, shifted)
    out = torch.empty((bq, h, w, vw), dtype=vdtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pwc_window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bq, bk,
            h, w, splits, int(shifted), kv_offset % bk, vw, q.stride(2),
            k.stride(2), v.stride(2), vw, _image_stride(q),
            _image_stride(k), _image_stride(v), h * w * vw, int(bf16),
            stream)
    if err:
        raise RuntimeError(f"window attention launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["global" if splits == 1 else
             "shifted" if shifted else "window"] += 1
    return out


class WindowAttentionFunction(torch.autograd.Function):
    """K12 forward; backward through autograd of
    ``window_attention_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, splits, shifted, kv_offset):
        ctx.args = (splits, shifted, kv_offset)
        ctx.save_for_backward(q, k, v)
        return window_attention_cuda(q, k, v, splits, shifted, kv_offset)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.window_attention import (
            window_attention_ref)
        grads = autograd_of(
            lambda q, k, v: window_attention_ref(q, k, v, *ctx.args),
            ctx.saved_tensors, g, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def window_attention_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        splits: int, shifted: bool = False,
                        kv_offset: int = 0) -> torch.Tensor:
    """The differentiable window attention on CUDA tensors (K12)."""
    return WindowAttentionFunction.apply(q, k, v, splits, shifted, kv_offset)
