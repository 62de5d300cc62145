"""Bilinear resize with an explicit corner-alignment convention.

Counterpart of ``pwcnet_tpu/ops/resize.py``. Layout is NHWC at the public
boundary, like the JAX package.

- ``half_pixel`` (default): source coord = (i + 0.5) * scale - 0.5,
  edge-clamped, i.e. ``F.interpolate(align_corners=False)``. For
  *upsampling* this equals ``jax.image.resize(method="bilinear")``; the
  model only ever upsamples (flows between levels, the finest flow to full
  resolution). Downsampling raises, because ``jax.image.resize``
  antialiases there and ``F.interpolate`` does not.
- ``align_corners``: source coord = i * (in - 1) / (out - 1).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

RESIZE_MODES = ("half_pixel", "align_corners")


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int],
                    mode: str = "half_pixel") -> torch.Tensor:
    """Bilinear-resize (N, H, W, C) -> (N, hw[0], hw[1], C), computed in f32
    and returned in the input dtype."""
    if mode not in RESIZE_MODES:
        raise ValueError(f"resize mode must be one of {RESIZE_MODES}, "
                         f"got {mode!r}")
    _, h, w, _ = x.shape
    ho, wo = hw
    if (ho, wo) == (h, w):
        return x
    if mode == "half_pixel" and (ho < h or wo < w):
        raise ValueError(f"half_pixel resize only upsamples; got {(h, w)} "
                         f"-> {(ho, wo)}")
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(ho, wo),
                      mode="bilinear", align_corners=(mode == "align_corners"))
    return y.permute(0, 2, 3, 1).to(x.dtype)
