"""Load the JAX model's flax parameters into the port.

``params`` is the nested dict of numpy arrays that
``jax.device_get(variables)["params"]`` gives for ``pwcnet_tpu``'s
``PWCNet`` (with the fused stem, the default). Kernels are HWIO there and
OIHW here. A missing key, an unused key or a wrong shape raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# Flax path (joined with "/") -> the port's state_dict key prefix.
_RULES: Tuple[Tuple[str, str], ...] = (
    (r"^FeaturePyramidExtractor_0/StemConvs_0/(conv\d)_(kernel|bias)$",
     r"pyramid.stem.\1/\2"),
    (r"^FeaturePyramidExtractor_0/ConvBlock_(\d+)/Conv_0/(kernel|bias)$",
     r"pyramid.blocks.\1.conv/\2"),
    (r"^estimator_l(\d+)/ConvStack_0/ConvBlock_(\d+)/Conv_0/(kernel|bias)$",
     r"estimators.l\1.stack.blocks.\2.conv/\3"),
    (r"^estimator_l(\d+)/Conv_0/(kernel|bias)$", r"estimators.l\1.flow/\2"),
    (r"^context/ConvBlock_(\d+)/Conv_0/(kernel|bias)$",
     r"context.blocks.\1.conv/\2"),
    (r"^context/Conv_0/(kernel|bias)$", r"context.flow/\1"),
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def torch_key(flax_path: str) -> str:
    """The port's state_dict key for a flax parameter path."""
    for pat, rep in _RULES:
        if re.match(pat, flax_path):
            module, leaf = re.sub(pat, rep, flax_path).split("/")
            return f"{module}.{'weight' if leaf == 'kernel' else 'bias'}"
    raise KeyError(f"no port parameter for flax parameter {flax_path!r}")


@torch.no_grad()
def load_flax_params(model: nn.Module, params: Mapping) -> None:
    """Fill ``model`` (a port ``PWCNet``) from flax ``params`` in place."""
    state = model.state_dict()
    filled = set()
    for path, value in _flatten(params).items():
        key = torch_key(path)
        if key not in state:
            raise KeyError(f"flax parameter {path!r} maps to {key!r}, which "
                           "the port's model does not have")
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{path!r}: shape {value.shape} (as OIHW) does "
                             f"not match {key!r} {tuple(state[key].shape)}")
        state[key].copy_(torch.tensor(value))
        filled.add(key)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"flax params lack {len(missing)} port parameters, "
                       f"e.g. {missing[:4]}")
