"""The fused stem (pyramid levels 1-2): CUDA kernel wrappers, their
autograd Function, and the plain version.

Counterpart of ``pwcnet_tpu/ops/pallas/stem_kernel.py`` (``_stem_kernel``,
``_stem_bwd_kernel``, ``stem_ref``). Four 3x3 convs, each + bias +
LeakyReLU 0.1, with XLA SAME padding: 3->c1 stride 2, c1->c1, c1->c2
stride 2, c2->c2. The kernels (``csrc/stem.cu``: forward K4, recompute
backward K5) are built for c1 = 16, c2 = 32, the model's widths.

``params`` is ``((w1, b1), ..., (w4, b4))`` with OIHW weights, as the port's
``StemConvs`` holds them; both versions round them to the working dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from pwcnet_tpu_torch.ops.conv import conv_same, leaky_relu
from pwcnet_tpu_torch.ops.kernels.build import load_library

SOURCE = "pwcnet_tpu_torch/csrc/stem.cu"
REPLACES = "pwcnet_tpu/ops/pallas/stem_kernel.py:98"
BWD_REPLACES = "pwcnet_tpu/ops/pallas/stem_kernel.py:401"
C1, C2 = 16, 32
_WANT = [(C1, 3), (C1, C1), (C2, C1), (C2, C2)]  # (out, in) channels

# Kernel launches in this process; each wrapper adds one per launch.
LAUNCHES = {"stem_fwd": 0, "stem_bwd": 0}

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]
_P = ctypes.c_void_p
_I = ctypes.c_int


def stem_ref(im: torch.Tensor, params: Params) -> torch.Tensor:
    """Plain version: (N, H, W, 3) -> (N, H/4, W/4, c2), NHWC in and out.
    Each conv's output is rounded to the working dtype, as ``conv_ref``
    (``pwcnet_tpu/ops/pallas/conv_kernel.py``) does."""
    x = im.permute(0, 3, 1, 2)
    for (w, b), stride in zip(params, (2, 1, 2, 1)):
        x = leaky_relu(conv_same(x, w, b, stride=stride))
    return x.permute(0, 2, 3, 1)


def _lib():
    lib = load_library("stem")
    lib.pwc_stem_fwd.argtypes = [_P] * 10 + [_I, _I, _I, _I, _P]
    lib.pwc_stem_fwd.restype = _I
    lib.pwc_stem_bwd.argtypes = [_P] * 18 + [_I, _I, _I, _I, _P]
    lib.pwc_stem_bwd.restype = _I
    for name in ("pwc_stem_bwd_grad_size", "pwc_stem_bwd_block_size"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    lib.pwc_stem_bwd_tiles.argtypes = [_I, _I, _I]
    lib.pwc_stem_bwd_tiles.restype = _I
    return lib


def _check(im: torch.Tensor, params: Params) -> None:
    if not im.is_cuda:
        raise ValueError(f"the stem kernels take a CUDA tensor, got "
                         f"{im.device}")
    if im.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 image expected, got {im.dtype}")
    if not im.is_contiguous():
        raise ValueError("the stem kernels need a contiguous NHWC image")
    n, h, w, cin = im.shape
    if cin != 3 or h % 4 or w % 4 or n < 1 or h < 4 or w < 4:
        raise ValueError(f"image shape {tuple(im.shape)}: (N, H, W, 3) with "
                         "H, W divisible by 4 expected")
    got = [tuple(wt.shape) for wt, _ in params]
    if got != [(co, ci, 3, 3) for co, ci in _WANT]:
        raise ValueError(f"stem weights {got}: OIHW {_WANT} x 3x3 expected")


def _hwio(params: Params, im: torch.Tensor):
    """f32 HWIO weights and f32 biases holding values rounded to the
    working dtype, as the kernels take them."""
    args = []
    for wt, b in params:
        args.append(wt.detach().to(im.device, im.dtype).float()
                    .permute(2, 3, 1, 0).contiguous())
        args.append(b.detach().to(im.device, im.dtype).float().contiguous())
    return args


def stem_cuda(im: torch.Tensor, params: Params) -> torch.Tensor:
    """K4: (N, H, W, 3) CUDA tensor, H and W divisible by 4 ->
    (N, H/4, W/4, 32) in the image's dtype. No autograd: ``stem_fn`` is the
    differentiable entry."""
    _check(im, params)
    n, h, w, _ = im.shape
    args = _hwio(params, im)
    out = torch.empty((n, h // 4, w // 4, C2), dtype=im.dtype,
                      device=im.device)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pwc_stem_fwd(
            im.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(), n,
            h, w, int(im.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    LAUNCHES["stem_fwd"] += 1
    return out


def stem_bwd_cuda(im: torch.Tensor, params: Params, grad: torch.Tensor,
                  need_im: bool = True):
    """K5: the gradients of ``stem_cuda(im, params)`` for the output
    gradient ``grad`` (N, H/4, W/4, 32). Returns ``(d_im, ((dw1, db1), ...,
    (dw4, db4)))``: d_im in the image's dtype (None unless ``need_im``), the
    weight and bias gradients as f32 OIHW / (C,) tensors holding values
    rounded to the image's dtype (the gradient of the f32 parameters through
    their cast to the working dtype)."""
    _check(im, params)
    n, h, w, _ = im.shape
    if (tuple(grad.shape) != (n, h // 4, w // 4, C2)
            or grad.device != im.device):
        raise ValueError(f"gradient {tuple(grad.shape)} on {grad.device} "
                         f"does not match the image {tuple(im.shape)}")
    grad = grad.to(im.dtype).contiguous()
    args = _hwio(params, im)
    # [ky][kx][co][ci] for the transposed convs.
    wts = [wt.detach().to(im.device, im.dtype).float().permute(2, 3, 0, 1)
           .contiguous() for wt, _ in params]
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=im.device)
    tiles = lib.pwc_stem_bwd_tiles(n, h, w)
    partials = torch.empty((tiles, lib.pwc_stem_bwd_grad_size()), **f32)
    grads = torch.empty((lib.pwc_stem_bwd_grad_size(),), **f32)
    blocks = d_im = None
    if need_im:
        blocks = torch.empty((tiles, lib.pwc_stem_bwd_block_size()), **f32)
        d_im = torch.empty_like(im)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pwc_stem_bwd(
            im.data_ptr(), grad.data_ptr(), *[a.data_ptr() for a in args],
            *[t.data_ptr() for t in wts], partials.data_ptr(),
            grads.data_ptr(), None if blocks is None else blocks.data_ptr(),
            None if d_im is None else d_im.data_ptr(), n, h, w,
            int(im.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"stem backward kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["stem_bwd"] += 1
    out, i = [], 0
    for (wt, b) in params:
        co, ci = wt.shape[:2]
        dw = grads[i:i + 9 * ci * co].view(3, 3, ci, co).permute(3, 2, 0, 1)
        i += 9 * ci * co
        db = grads[i:i + co]
        i += co
        out.append((dw.to(im.dtype).float().contiguous(),
                    db.to(im.dtype).float()))
    return d_im, tuple(out)


class StemFunction(torch.autograd.Function):
    """K4 forward, K5 backward; the residuals are the image and weights."""

    @staticmethod
    def forward(ctx, im, *flat):
        params = list(zip(flat[0::2], flat[1::2]))
        ctx.save_for_backward(im, *flat)
        return stem_cuda(im, params)

    @staticmethod
    def backward(ctx, grad):
        im, *flat = ctx.saved_tensors
        params = list(zip(flat[0::2], flat[1::2]))
        d_im, dparams = stem_bwd_cuda(im, params, grad,
                                      need_im=ctx.needs_input_grad[0])
        return (d_im, *[t.to(p.dtype) for pair, ps in zip(dparams, params)
                        for t, p in zip(pair, ps)])


def stem_fn(im: torch.Tensor, params: Params) -> torch.Tensor:
    """The differentiable fused stem on a CUDA image (K4; K5 when autograd
    asks for gradients)."""
    return StemFunction.apply(im, *[t for pair in params for t in pair])


def stem(im: torch.Tensor, params: Params) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernels on a CUDA tensor."""
    if im.device.type == "cpu":
        return stem_ref(im, params)
    return stem_fn(im, params)
