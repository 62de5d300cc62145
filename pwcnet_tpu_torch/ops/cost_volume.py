"""Local cost volume (correlation layer).

Counterpart of ``pwcnet_tpu/ops/cost_volume.py``:

    out[n, y, x, k] = (1/C) * sum_c f1[n, y, x, c] * f2[n, y+dy, x+dx, c]

for (dy, dx) in [-d, d]^2, zero outside the image, channel
``k = (dy + d) * (2d + 1) + (dx + d)``. Products and sums are f32; the
output has the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import cost_volume_cuda


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


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, *,
                max_displacement: int = 4) -> torch.Tensor:
    """The plain version on CPU tensors, the CUDA kernel on CUDA tensors."""
    if f1.device.type == "cpu":
        return cost_volume_ref(f1, f2, max_displacement)
    return cost_volume_cuda(f1, f2, max_displacement)
