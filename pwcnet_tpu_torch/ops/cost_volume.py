"""Local cost volume (correlation layer).

Counterpart of ``pwcnet_tpu/ops/cost_volume.py``:

    out[n, y, x, k] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y+dy, x+dx, c]

for (dy, dx) in [-d, d]^2, zero outside the image, channel
``k = (dy + d) * (2d + 1) + (dx + d)``. Products and sums are f32; the
output has the input dtype. Both versions are differentiable: the plain one
through autograd, the kernel through ``CostVolumeFunction`` (K2, K3).

``cost_volume_prepadded`` is the same correlation where f2 arrives with d
real rows above and below (the halo rows of the spatially sharded path,
``parallel/halo.py``) in place of the zero padding: K1p on the card, whose
backward is autograd of the plain version, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import (
    cost_volume_fn, cost_volume_prepadded_fn)


def cost_volume_ref(f1: torch.Tensor, f2: torch.Tensor,
                    max_displacement: int = 4) -> torch.Tensor:
    """Plain version: pad, (2d+1)^2 shifted products, f32 mean over C."""
    if f1.shape != f2.shape:
        raise ValueError(f"shape mismatch {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)}")
    _, h, w, _ = f1.shape
    d = max_displacement
    f1f = f1.float()
    f2p = F.pad(f2.float(), (0, 0, d, d, d, d))
    outs = [(f1f * f2p[:, dy:dy + h, dx:dx + w]).mean(-1)
            for dy in range(2 * d + 1) for dx in range(2 * d + 1)]
    return torch.stack(outs, -1).to(f1.dtype)


# The bf16 K1's tiling: m16 tiles of f1 pixels, each multiplied with a
# window of f2 pixels 4 to the left and 4 to the right of it (three n8 tiles).
BAND_M = 16
BAND_N = BAND_M + 8


def corr_band_ref(f1: torch.Tensor, f2: torch.Tensor,
                  max_displacement: int = 4,
                  prepadded: bool = False) -> torch.Tensor:
    """The bf16 K1's arithmetic (``csrc/cost_volume.cu``) in plain torch,
    for the tests: the correlation as banded products. For each output row
    y, each m-tile of 16 pixels x0..x0+15 (x0 a multiple of 16; past W
    zeros) and each dy, the 16 x C block of f1 times the 24 pixels
    x0-4..x0+19 of f2's row y+dy (zeros outside the image), with C
    zero-padded to a multiple of 16, gives 16 x 24 sums, of which the
    diagonals j = i + 4 + dx, |dx| <= d, are the taps. Sums in f32, then
    divided by C and rounded once to the inputs' dtype. With ``prepadded``,
    f2 carries d real rows above and below (K1p). Nothing on the main path
    calls it."""
    d = max_displacement
    if not 1 <= d <= 4:
        raise ValueError(f"the band covers 1 <= d <= 4, got {d}")
    n, h, w, c = f1.shape
    rows = 2 * d if prepadded else 0
    if tuple(f2.shape) != (n, h + rows, w, c):
        raise ValueError(f"f2 {tuple(f2.shape)}: {(n, h + rows, w, c)} "
                         "expected")
    tiles = -(-w // BAND_M)
    wp, cp = tiles * BAND_M, -(-c // 16) * 16
    s = 2 * d + 1
    a = F.pad(f1.float(), (0, cp - c, 0, wp - w)).view(n, h, tiles, BAND_M,
                                                        cp)
    pad_rows = 0 if prepadded else d
    b = F.pad(f2.float(), (0, cp - c, 4, wp - w + 4, pad_rows, pad_rows))
    win = b.unfold(2, BAND_N, BAND_M)  # (n, h + 2d, tiles, cp, 24)
    i = torch.arange(BAND_M, device=f1.device)[:, None]
    j = i + 4 + torch.arange(-d, d + 1, device=f1.device)[None, :]
    taps = []
    for dy in range(s):
        sums = torch.einsum("nhtic,nhtcj->nhtij", a, win[:, dy:dy + h])
        taps.append(sums[..., i, j])  # (n, h, tiles, 16, 2d + 1)
    out = torch.stack(taps, -2).reshape(n, h, wp, s * s)[:, :, :w]
    return (out / c).to(f1.dtype)


def cost_volume_bwd_ref(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                        max_displacement: int = 4, need_f1: bool = True,
                        need_f2: bool = True):
    """Plain version of K2 and K3, with ``cost_volume_bwd_cuda``'s
    signature: (df1, df2) from autograd through ``cost_volume_ref``, None
    for a gradient not asked for."""
    with torch.enable_grad():
        a = f1.detach().requires_grad_(need_f1)
        b = f2.detach().requires_grad_(need_f2)
        wrt = [t for t in (a, b) if t.requires_grad]
        grads = list(torch.autograd.grad(
            cost_volume_ref(a, b, max_displacement), wrt, g)) if wrt else []
    return (grads.pop(0) if need_f1 else None,
            grads.pop(0) if need_f2 else None)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, *,
                max_displacement: int = 4) -> torch.Tensor:
    """The plain version on CPU tensors, the CUDA kernels on CUDA tensors."""
    if f1.device.type == "cpu":
        return cost_volume_ref(f1, f2, max_displacement)
    return cost_volume_fn(f1, f2, max_displacement)


def cost_volume_prepadded_ref(f1: torch.Tensor, f2e: torch.Tensor,
                              max_displacement: int = 4) -> torch.Tensor:
    """Plain version of K1p: f1 (N, H, W, C), f2e (N, H + 2d, W, C) covering
    rows [-d, H + d); zero padding in W only (JAX
    ``cost_volume_prepadded_lax``)."""
    n, h, w, _ = f1.shape
    d = max_displacement
    if f2e.shape[1] != h + 2 * d:
        raise ValueError(f"f2e must have H + 2d = {h + 2 * d} rows, got "
                         f"{f2e.shape[1]}")
    f1f = f1.float()
    f2p = F.pad(f2e.float(), (0, 0, d, d))
    outs = [(f1f * f2p[:, dy:dy + h, dx:dx + w]).mean(-1)
            for dy in range(2 * d + 1) for dx in range(2 * d + 1)]
    return torch.stack(outs, -1).to(f1.dtype)


def cost_volume_prepadded(f1: torch.Tensor, f2e: torch.Tensor, *,
                          max_displacement: int = 4) -> torch.Tensor:
    """The plain version on CPU tensors, K1p on CUDA tensors."""
    if f1.device.type == "cpu":
        return cost_volume_prepadded_ref(f1, f2e, max_displacement)
    return cost_volume_prepadded_fn(f1, f2e, max_displacement)
