"""The port's own parameter init, equal in law to the JAX package's flax
defaults: ``lecun_normal`` kernels (truncated normal, std
``sqrt(1/fan_in) / 0.87962566``, cut at two std) and zero biases. The draws
come from a ``torch.Generator``, so they differ from ``jax.random``'s; load
the JAX model's weights with ``compat.flax_weights`` to compare the two.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pwcnet_tpu_torch.models.layers import Conv

# Std of a standard normal truncated to [-2, 2] (flax variance_scaling).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In place, for an OIHW weight (fan_in = I * H * W)."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv of ``model`` in module order."""
    for m in model.modules():
        if isinstance(m, Conv):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
