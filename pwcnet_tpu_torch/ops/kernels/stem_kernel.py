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

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.conv import _same_pads, conv_same, leaky_relu
from pwcnet_tpu_torch.ops.kernels.build import aligned16, load_library

SOURCE = "pwcnet_tpu_torch/csrc/stem.cu"
REPLACES = "pwcnet_tpu/ops/pallas/stem_kernel.py:98"
BWD_REPLACES = "pwcnet_tpu/ops/pallas/stem_kernel.py:401"
C1, C2 = 16, 32
_WANT = [(C1, 3), (C1, C1), (C2, C1), (C2, C2)]  # (out, in) channels

# Kernel launches in this process; each wrapper adds one per launch.
LAUNCHES = trace.counters("launches.stem", ("stem_fwd", "stem_bwd"))

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


def conv_t2_ref(p: torch.Tensor, w: torch.Tensor, in_hw) -> torch.Tensor:
    """The input gradient of a stride-2 3x3 SAME conv from the gradient
    ``p`` (N, Ho, Wo, Co) at its output, NHWC, ``w`` HWIO (3, 3, Ci, Co), as
    the bf16 K5 computes it: split by output parity, output row j taking
    the taps ky with j + pt - ky even (one or two) at p row (j + pt - ky) /
    2, columns likewise, with XLA's SAME pads (pt, pl) of the conv."""
    n, ho, wo, _ = p.shape
    h, wd = in_hw
    pt, pl = _same_pads(h, 3, 2, 1)[0], _same_pads(wd, 3, 2, 1)[0]
    out = p.new_zeros((n, h, wd, w.shape[2]))
    for qy in (0, 1):
        rows = torch.arange(qy, h, 2, device=p.device)
        for qx in (0, 1):
            cols = torch.arange(qx, wd, 2, device=p.device)
            acc = out[:, qy::2, qx::2]
            for ky in range((qy + pt) % 2, 3, 2):
                oy = torch.div(rows + pt - ky, 2, rounding_mode="floor")
                my = ((oy >= 0) & (oy < ho)).to(p.dtype)
                for kx in range((qx + pl) % 2, 3, 2):
                    ox = torch.div(cols + pl - kx, 2, rounding_mode="floor")
                    mx = ((ox >= 0) & (ox < wo)).to(p.dtype)
                    tap = p[:, oy.clamp(0, ho - 1)][:, :, ox.clamp(0, wo - 1)]
                    tap = tap * my[:, None, None] * mx[None, :, None]
                    acc += tap @ w[ky, kx].transpose(0, 1).to(p.dtype)
    return out


def stem_bwd_bf16_ref(im: torch.Tensor, params: Params, grad: torch.Tensor,
                      need_im: bool = True):
    """The bf16 K5's arithmetic in plain torch, returned as
    ``stem_bwd_cuda`` returns it: every operand of a product is a value of
    the working dtype (the image, the weights, y_l as the forward rounds
    them, p_l rounded before it enters a product) and every sum is f32.
    Differs from autograd through ``stem_ref`` in bf16 in where it rounds,
    not in what it computes."""
    dt = im.dtype

    def rnd(t):
        return t.to(dt).float()

    ws = [(rnd(w), rnd(b)) for w, b in params]
    strides = (2, 1, 2, 1)
    ys = [im.float().permute(0, 3, 1, 2)]  # NCHW: conv l's input
    for (w, b), s in zip(ws[:3], strides):
        ys.append(rnd(leaky_relu(conv_same(ys[-1], w, b, stride=s))))
    z4 = conv_same(ys[3], *ws[3], stride=1)
    p = rnd(grad.float().permute(0, 3, 1, 2)
            * torch.where(z4 > 0, 1.0, 0.1))
    d_im, out = None, []
    for layer in (3, 2, 1, 0):
        x, (w, _) = ys[layer], ws[layer]
        a = x.clone().requires_grad_()
        wg = w.clone().requires_grad_()
        dx, dw = torch.autograd.grad(
            conv_same(a, wg, None, stride=strides[layer]), (a, wg), p)
        out.append((rnd(dw), rnd(p.sum((0, 2, 3)))))
        if strides[layer] == 2:
            dx = conv_t2_ref(p.permute(0, 2, 3, 1), w.permute(2, 3, 1, 0),
                             x.shape[2:]).permute(0, 3, 1, 2)
        if layer:
            p = rnd(dx * torch.where(x > 0, 1.0, 0.1))
        elif need_im:
            d_im = dx.permute(0, 2, 3, 1).to(dt)
    return d_im, tuple(out[::-1])


# How far the bf16 K5 may sit from stem_bwd_bf16_ref, max|a - b| / max|b|,
# for d_im and for each weight or bias gradient. The two differ only in the
# order of f32 sums, which now and then moves a value across a bf16
# rounding step or a LeakyReLU threshold; at chip_smoke.py's shapes an H100
# reads up to 6.5e-2 on d_im and 6.8e-3 on the others. A weight-gradient
# split that lost tiles would be off by tenths.
BF16_MODEL_TOL = (0.1, 1.5e-2)


def _lib():
    lib = load_library("stem")
    lib.pwc_stem_fwd.argtypes = [_P] * 10 + [_I, _I, _I, _P]
    lib.pwc_stem_fwd.restype = _I
    lib.pwc_stem_fwd_bf16.argtypes = [_P] * 5 + [_I, _I, _I, _P]
    lib.pwc_stem_fwd_bf16.restype = _I
    lib.pwc_stem_bwd.argtypes = [_P] * 18 + [_I, _I, _I, _P]
    lib.pwc_stem_bwd.restype = _I
    lib.pwc_stem_bwd_bf16.argtypes = [_P] * 7 + [_I, _I, _I, _P]
    lib.pwc_stem_bwd_bf16.restype = _I
    for name in ("pwc_stem_bwd_grad_size", "pwc_stem_bwd_block_size",
                 "pwc_stem_bwd_bf16_partials"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    lib.pwc_stem_bwd_tiles.argtypes = [_I, _I, _I]
    lib.pwc_stem_bwd_tiles.restype = _I
    for name in ("pwc_stem_fwd_bf16_scratch", "pwc_stem_bwd_bf16_scratch"):
        getattr(lib, name).argtypes = [_I, _I, _I]
        getattr(lib, name).restype = ctypes.c_longlong
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
    working dtype, as the f32 kernels take them."""
    args = []
    for wt, b in params:
        args.append(wt.detach().to(im.device, im.dtype).float()
                    .permute(2, 3, 1, 0).contiguous())
        args.append(b.detach().to(im.device, im.dtype).float().contiguous())
    return args


def _flat(params: Params, im: torch.Tensor) -> torch.Tensor:
    """Every weight (OIHW) and bias in one f32 buffer, laid out as the
    kernels' gradients; the bf16 kernels pack and round it."""
    return torch.cat([t.detach().to(im.device).reshape(-1).float()
                      for pair in params for t in pair])


def stem_cuda(im: torch.Tensor, params: Params) -> torch.Tensor:
    """K4: (N, H, W, 3) CUDA tensor, H and W divisible by 4 ->
    (N, H/4, W/4, 32) in the image's dtype. bf16 runs the four convs layer
    by layer on the tensor cores (5 launches), f32 the fused CUDA-core
    kernel. No autograd: ``stem_fn`` is the differentiable entry."""
    _check(im, params)
    n, h, w, _ = im.shape
    lib = _lib()
    out = torch.empty((n, h // 4, w // 4, C2), dtype=im.dtype,
                      device=im.device)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream().cuda_stream
        if im.dtype == torch.bfloat16:
            flat = _flat(params, im)
            packed = torch.empty_like(flat)
            scratch = torch.empty((lib.pwc_stem_fwd_bf16_scratch(n, h, w),),
                                  dtype=im.dtype, device=im.device)
            err = lib.pwc_stem_fwd_bf16(
                im.data_ptr(), flat.data_ptr(), packed.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), n, h, w, stream)
        else:
            args = _hwio(params, im)
            err = lib.pwc_stem_fwd(
                im.data_ptr(), *[a.data_ptr() for a in args], out.data_ptr(),
                n, h, w, stream)
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
    their cast to the working dtype). bf16 runs the layer-by-layer kernels
    on the tensor cores, f32 the fused recompute kernel."""
    _check(im, params)
    n, h, w, _ = im.shape
    if (tuple(grad.shape) != (n, h // 4, w // 4, C2)
            or grad.device != im.device):
        raise ValueError(f"gradient {tuple(grad.shape)} on {grad.device} "
                         f"does not match the image {tuple(im.shape)}")
    grad = aligned16(grad.to(im.dtype).contiguous())
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=im.device)
    grads = torch.empty((lib.pwc_stem_bwd_grad_size(),), **f32)
    d_im = torch.empty_like(im) if need_im else None
    dim_ptr = None if d_im is None else d_im.data_ptr()
    bf16 = im.dtype == torch.bfloat16
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:  # the kernels write grads OIHW, rounded
            flat = _flat(params, im)
            scratch = torch.empty(
                (lib.pwc_stem_bwd_bf16_scratch(n, h, w),), dtype=im.dtype,
                device=im.device)
            partials = torch.empty((lib.pwc_stem_bwd_bf16_partials(),), **f32)
            err = lib.pwc_stem_bwd_bf16(
                im.data_ptr(), grad.data_ptr(), flat.data_ptr(),
                scratch.data_ptr(), partials.data_ptr(), grads.data_ptr(),
                dim_ptr, n, h, w, stream)
        else:
            args = _hwio(params, im)
            # [ky][kx][co][ci] for the transposed convs.
            wts = [wt.detach().to(im.device, im.dtype).float()
                   .permute(2, 3, 0, 1).contiguous() for wt, _ in params]
            tiles = lib.pwc_stem_bwd_tiles(n, h, w)
            partials = torch.empty((tiles, lib.pwc_stem_bwd_grad_size()),
                                   **f32)
            blocks = None
            if need_im:
                blocks = torch.empty(
                    (tiles, lib.pwc_stem_bwd_block_size()), **f32)
            err = lib.pwc_stem_bwd(
                im.data_ptr(), grad.data_ptr(), *[a.data_ptr() for a in args],
                *[t.data_ptr() for t in wts], partials.data_ptr(),
                grads.data_ptr(),
                None if blocks is None else blocks.data_ptr(), dim_ptr, n, h,
                w, stream)
    if err:
        raise RuntimeError(f"stem backward kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["stem_bwd"] += 1
    out, i = [], 0
    for (wt, b) in params:
        co, ci = wt.shape[:2]
        dw = grads[i:i + 9 * ci * co]
        i += 9 * ci * co
        db = grads[i:i + co]
        i += co
        if bf16:  # OIHW and rounded already
            out.append((dw.view(co, ci, 3, 3), db))
        else:
            out.append((dw.view(3, 3, ci, co).permute(3, 2, 0, 1)
                        .contiguous(), db))
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
