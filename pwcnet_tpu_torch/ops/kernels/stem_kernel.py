"""The fused stem (pyramid levels 1-2): CUDA kernel wrapper and plain version.

Counterpart of ``pwcnet_tpu/ops/pallas/stem_kernel.py`` (``_stem_kernel``,
``stem_ref``). Four 3x3 convs, each + bias + LeakyReLU 0.1, with XLA SAME
padding: 3->c1 stride 2, c1->c1, c1->c2 stride 2, c2->c2. The kernel
(``csrc/stem.cu``) is built for c1 = 16, c2 = 32, the model's widths.

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
C1, C2 = 16, 32

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = 0

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


def _fn():
    fn = load_library("stem").pwc_stem_fwd
    fn.argtypes = [_P] * 10 + [_I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def stem_cuda(im: torch.Tensor, params: Params) -> torch.Tensor:
    """Fused kernel: (N, H, W, 3) CUDA tensor, H and W divisible by 4 ->
    (N, H/4, W/4, 32) in the image's dtype."""
    global LAUNCHES
    if not im.is_cuda:
        raise ValueError(f"stem_cuda takes a CUDA tensor, got {im.device}")
    if im.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 image expected, got {im.dtype}")
    if not im.is_contiguous():
        raise ValueError("stem_cuda needs a contiguous NHWC image")
    n, h, w, cin = im.shape
    if cin != 3 or h % 4 or w % 4 or n < 1 or h < 4 or w < 4:
        raise ValueError(f"image shape {tuple(im.shape)}: (N, H, W, 3) with "
                         "H, W divisible by 4 expected")
    want = [(C1, 3), (C1, C1), (C2, C1), (C2, C2)]
    got = [tuple(wt.shape) for wt, _ in params]
    if got != [(co, ci, 3, 3) for co, ci in want]:
        raise ValueError(f"stem weights {got}: OIHW {want} x 3x3 expected")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (im, *[t for p in params for t in p])):
        raise NotImplementedError("the stem kernel has no backward yet: "
                                  "call it under torch.no_grad()")
    # HWIO f32 holding values rounded to the working dtype.
    args = []
    for wt, b in params:
        args.append(wt.to(im.device, im.dtype).float()
                    .permute(2, 3, 1, 0).contiguous())
        args.append(b.to(im.device, im.dtype).float().contiguous())
    out = torch.empty((n, h // 4, w // 4, C2), dtype=im.dtype,
                      device=im.device)
    with torch.cuda.device(im.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(im.data_ptr(), *[a.data_ptr() for a in args],
                    out.data_ptr(), n, h, w, int(im.dtype == torch.bfloat16),
                    stream)
    if err:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def stem(im: torch.Tensor, params: Params) -> torch.Tensor:
    """The plain version on a CPU tensor, the kernel on a CUDA tensor."""
    if im.device.type == "cpu":
        return stem_ref(im, params)
    return stem_cuda(im, params)
