"""Load the JAX models' flax parameters into the port.

``params`` is the nested dict of arrays that
``jax.device_get(variables)["params"]`` gives for ``pwcnet_tpu``'s
``PWCNet`` or ``RAFT`` (numpy arrays, or torch tensors as
``read_flax_npz`` gives them). Kernels are HWIO there and OIHW here, square
or not; a GroupNorm's ``scale`` and ``bias`` fill its block's
``norm.weight`` and ``norm.bias``. A PWC-Net tree in either layout of the
pyramid's first two levels loads: the fused one (``StemConvs_0``, the
default) and the plain one (``ConvBlock_0..3``, e.g. from a model with
``min_level=1`` or ``use_norm``); ``remap_stem_params`` converts between
them. A missing key, an unused key
or a wrong shape raises.

``read_flax_npz`` reads a checkpoint flattened to an ``.npz`` of
``params/<flax path>`` keys, such as ``runs/raft-synthetic/
params_step20000_bf16.npz`` (bf16 stored as raw 2-byte records, ``|V2``) or
``runs/synthetic-proof/params_step125000_bf16.npz`` (bf16 stored as
``uint16`` views). ``load_flax_params`` refuses a value that is not
floating point.
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
    (r"^FeaturePyramidExtractor_0/ConvBlock_(\d+)/GroupNorm_0/"
     r"(scale|bias)$", r"pyramid.blocks.\1.norm/\2"),
    (r"^estimator_l(\d+)/ConvStack_0/ConvBlock_(\d+)/Conv_0/(kernel|bias)$",
     r"estimators.l\1.stack.blocks.\2.conv/\3"),
    (r"^estimator_l(\d+)/ConvStack_0/ConvBlock_(\d+)/GroupNorm_0/"
     r"(scale|bias)$", r"estimators.l\1.stack.blocks.\2.norm/\3"),
    (r"^estimator_l(\d+)/Conv_0/(kernel|bias)$", r"estimators.l\1.flow/\2"),
    (r"^context/ConvBlock_(\d+)/Conv_0/(kernel|bias)$",
     r"context.blocks.\1.conv/\2"),
    (r"^context/Conv_0/(kernel|bias)$", r"context.flow/\1"),
    # RAFT.
    (r"^(fnet|cnet)/Conv_(\d)/(kernel|bias)$", r"\1.conv\2/\3"),
    (r"^(fnet|cnet)/ResBlock_(\d)/Conv_(\d)/(kernel|bias)$",
     r"\1.blocks.\2.conv\3/\4"),
    (r"^SepConvGRU_0/Conv_(\d)/(kernel|bias)$", r"gru.convs.\1/\2"),
    (r"^MotionEncoder_0/Conv_(\d)/(kernel|bias)$", r"menc.convs.\1/\2"),
    (r"^((?:flow|mask)_head_\d)/(kernel|bias)$", r"\1/\2"),
)


def remap_stem_params(extractor_params: Mapping, to_fused: bool) -> dict:
    """Convert a ``FeaturePyramidExtractor`` parameter subtree between the
    plain layout (``ConvBlock_0..``) and the fused one (``StemConvs_0`` +
    ``ConvBlock_0..``), as ``pwcnet_tpu/train/checkpoint.py`` does: the four
    stem convs map 1:1 (``StemConvs_0/conv{i}_kernel`` <->
    ``ConvBlock_{i-1}/Conv_0/kernel``, biases likewise) and the remaining
    ConvBlocks shift their index by 4."""
    src = dict(extractor_params)
    out: dict = {}
    if to_fused:
        stem = {}
        for i in range(4):
            blk = src.pop(f"ConvBlock_{i}")["Conv_0"]
            stem[f"conv{i + 1}_kernel"] = blk["kernel"]
            stem[f"conv{i + 1}_bias"] = blk["bias"]
        out["StemConvs_0"] = stem
        shift = -4
    else:
        stem = src.pop("StemConvs_0")
        for i in range(4):
            out[f"ConvBlock_{i}"] = {"Conv_0": {
                "kernel": stem[f"conv{i + 1}_kernel"],
                "bias": stem[f"conv{i + 1}_bias"]}}
        shift = 4
    for k, v in src.items():
        if k.startswith("ConvBlock_"):
            out[f"ConvBlock_{int(k.split('_')[1]) + shift}"] = v
        else:
            out[k] = v
    return out


def _to_model_layout(model: nn.Module, params: Mapping) -> Mapping:
    """``params`` with its pyramid in the layout ``model`` has."""
    fpe = params.get("FeaturePyramidExtractor_0")
    if fpe is None:
        return params
    fused = getattr(model.pyramid, "stem", None) is not None
    if fused == ("StemConvs_0" in fpe):
        return params
    return {**params, "FeaturePyramidExtractor_0":
            remap_stem_params(fpe, to_fused=fused)}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v if torch.is_tensor(v) else np.asarray(v)
    return out


def read_flax_npz(path: str) -> dict:
    """The nested ``params`` tree of an ``.npz`` whose keys are
    ``params/<flax path>``, as torch tensors. Every 2-byte array that is
    not a float16 one (raw ``|V2`` records, ``<u2`` or ``<i2``: the ways
    numpy stores bf16 without a bf16 type) is read as bf16: its bits viewed
    as ``int16``, then as ``torch.bfloat16``. A flax params tree holds no
    integers, so this rule cannot misread a real parameter."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] != "params":
                raise KeyError(f"{path}: key {key!r} is not under params/")
            a = z[key]
            if a.dtype.kind in "Vui" and a.dtype.itemsize == 2:
                t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                     ).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            node = tree
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return tree


# Flax leaf name -> the port's parameter name.
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def torch_key(flax_path: str) -> str:
    """The port's state_dict key for a flax parameter path: a conv's
    ``kernel`` and a GroupNorm's ``scale`` become ``weight``, ``bias``
    stays ``bias``. A path no rule takes, any other leaf among them,
    raises ``KeyError``."""
    for pat, rep in _RULES:
        if re.match(pat, flax_path):
            module, leaf = re.sub(pat, rep, flax_path).split("/")
            return f"{module}.{_LEAVES[leaf]}"
    raise KeyError(f"no port parameter for flax parameter {flax_path!r}")


@torch.no_grad()
def load_flax_params(model: nn.Module, params: Mapping) -> None:
    """Fill ``model`` (a port ``PWCNet`` or ``RAFT``) from flax ``params``
    in place. A value that is not floating point raises ``TypeError``."""
    state = model.state_dict()
    filled = set()
    for path, value in _flatten(_to_model_layout(model, params)).items():
        key = torch_key(path)
        if key not in state:
            raise KeyError(f"flax parameter {path!r} maps to {key!r}, which "
                           "the port's model does not have")
        value = value if torch.is_tensor(value) else torch.tensor(value)
        if not value.is_floating_point():
            raise TypeError(f"flax parameter {path!r} has dtype "
                            f"{value.dtype}, not a floating-point one (bf16 "
                            "bits stored as integers: read the .npz with "
                            "read_flax_npz)")
        if value.ndim == 4:
            value = value.permute(3, 2, 0, 1)  # HWIO -> OIHW
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{path!r}: shape {tuple(value.shape)} (as "
                             f"OIHW) does not match {key!r} "
                             f"{tuple(state[key].shape)}")
        state[key].copy_(value)
        filled.add(key)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"flax params lack {len(missing)} port parameters, "
                       f"e.g. {missing[:4]}")
