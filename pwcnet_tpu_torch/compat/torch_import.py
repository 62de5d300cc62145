"""Load a reference PWC-Net ``.pth`` state dict into the port's ``PWCNet``
(counterpart of ``pwcnet_tpu/compat/torch_import.py``).

The reference is a PyTorch model too, OIHW like the port, so a conv's
weight and bias are copied as they are. Which conv goes where follows the
JAX importer:

- ``module.`` (DataParallel) prefixes are stripped and BatchNorm
  bookkeeping (``running_mean``, ``running_var``, ``num_batches_tracked``)
  is ignored;
- keys fall into three groups by substring: the feature pyramid
  (``pyramid`` or ``extractor``), the flow estimators (``estimator``) and
  the context network (``context``); any other key is an error;
- within a group, each conv is a (4-D weight, bias) pair, taken in the
  state dict's insertion order, which for the reference's
  ``nn.Sequential`` / ``ModuleList`` construction is execution order;
  1-D weights (a norm's affine) are skipped;
- estimators are told apart by the ModuleList index in their keys
  (``estimators.<i>``), ordered coarse-first (the reference's) or
  fine-first.

The destination slots are the port's convs in execution order: the stem's
``conv1..4`` and then the pyramid's ``ConvBlock``s (with ``use_norm`` or
``min_level < 2`` the pyramid has no stem, and its blocks take the same
convs), each estimator's stack and flow conv, the context's convs and flow
conv. Every unmatched key, count mismatch and shape mismatch is reported in
one ``ValueError``, and nothing is copied unless every conv fits. A GroupNorm
of a ``use_norm`` model has no counterpart in a reference state dict (the
reference's ``--batch_norm`` is BatchNorm2d), so its parameters keep the
values the model has.

``import_torch_checkpoint`` reads a file with ``torch.load(...,
weights_only=True)`` and unwraps a ``state_dict``, ``model`` or
``model_state_dict`` entry. A ``step_<n>.pt`` of the port's own
``CheckpointManager`` is refused: its directory is what the port's
``--ckpt`` takes.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

__all__ = ["import_torch_state_dict", "import_torch_checkpoint"]

_IGNORED = ("num_batches_tracked", "running_mean", "running_var")
_GROUP_PATTERNS = {
    "pyramid": ("pyramid", "extractor"),
    "estimators": ("estimator",),
    "context": ("context",),
}
# The entries of a port TrainState.state_dict (train/state.py).
_PORT_STATE_KEYS = {"step", "model", "optimizer", "scheduler"}

Pair = Tuple[str, torch.Tensor, torch.Tensor]


def _conv_pairs(items: List[Tuple[str, torch.Tensor]]) -> List[Pair]:
    """Ordered (prefix, weight, bias) of the convs among (key, value)
    items: a prefix with a 4-D weight; a missing bias is zeros."""
    by_prefix: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in items:
        if not key.endswith((".weight", ".bias")) or val.ndim not in (1, 4):
            continue
        prefix, _, kind = key.rpartition(".")
        by_prefix.setdefault(prefix, {})[kind] = val
    out = []
    for prefix, entry in by_prefix.items():
        w = entry.get("weight")
        if w is None or w.ndim != 4:
            continue
        out.append((prefix, w, entry.get("bias", torch.zeros(w.shape[0]))))
    return out


def _convs(blocks, *last) -> List[nn.Module]:
    return [b.conv for b in blocks] + list(last)


def _pyramid_convs(model: nn.Module) -> List[nn.Module]:
    """The pyramid's convs in execution order: the stem's conv1..4 (when
    the model has the stem), then its ConvBlocks."""
    pyr = model.pyramid
    stem = [] if pyr.stem is None else [
        pyr.stem.conv1, pyr.stem.conv2, pyr.stem.conv3, pyr.stem.conv4]
    return stem + _convs(pyr.blocks)


@torch.no_grad()
def import_torch_state_dict(state_dict: Mapping, model: nn.Module, *,
                            estimator_order: str = "coarse_first"
                            ) -> Dict[str, str]:
    """Fill the port ``PWCNet`` ``model`` in place from a reference torch
    ``state_dict``; returns {port parameter key: source key}.

    ``estimator_order``: ``"coarse_first"`` (the reference's registration
    order) or ``"fine_first"`` for forks that build estimators finest
    first. Raises ``ValueError`` listing every unmatched source key, count
    mismatch and shape mismatch at once; then nothing has been copied.
    """
    if estimator_order not in ("coarse_first", "fine_first"):
        raise ValueError(f"estimator_order={estimator_order!r}")
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {
        g: [] for g in _GROUP_PATTERNS}
    errors = []
    for key, val in state_dict.items():
        key = key.removeprefix("module.")
        if any(tok in key for tok in _IGNORED):
            continue
        val = torch.as_tensor(val).detach().to("cpu", torch.float32)
        for group, pats in _GROUP_PATTERNS.items():
            if any(p in key for p in pats):
                groups[group].append((key, val))
                break
        else:
            errors.append(f"unmatched source key: {key}")

    est_by_idx: Dict[int, List[Tuple[str, torch.Tensor]]] = {}
    for key, val in groups["estimators"]:
        m = re.search(r"estimators?\.(\d+)", key)
        est_by_idx.setdefault(int(m.group(1)) if m else 0, []).append(
            (key, val))
    levels = [model.num_levels - i for i in range(model.output_level + 1)]
    if estimator_order == "fine_first":
        levels = levels[::-1]

    # (what, destination convs, source pairs), in execution order.
    plan = [("feature pyramid", _pyramid_convs(model),
             _conv_pairs(groups["pyramid"]))]
    for pos, idx in enumerate(sorted(est_by_idx)):
        if pos >= len(levels):
            errors.append(f"estimator index {idx}: more estimators than "
                          f"decoder levels {levels}")
            continue
        est = model.estimators[f"l{levels[pos]}"]
        plan.append((f"estimator_l{levels[pos]}",
                     _convs(est.stack.blocks, est.flow),
                     _conv_pairs(est_by_idx[idx])))
    if len(est_by_idx) < len(levels):
        errors.append(f"only {len(est_by_idx)} estimators in the state dict "
                      f"for levels {levels}")
    plan.append(("context", _convs(model.context.blocks, model.context.flow),
                 _conv_pairs(groups["context"])))

    names = {m: n for n, m in model.named_modules()}
    copies = []
    for what, convs, pairs in plan:
        if len(pairs) != len(convs):
            errors.append(f"{what}: {len(pairs)} source convs for "
                          f"{len(convs)} destination convs")
            continue
        for conv, (prefix, w, b) in zip(convs, pairs):
            for src, param in ((w, conv.weight), (b, conv.bias)):
                if tuple(src.shape) != tuple(param.shape):
                    errors.append(f"{prefix}: {tuple(src.shape)} -> "
                                  f"{names[conv]} expects "
                                  f"{tuple(param.shape)}")
            copies.append((conv, prefix, w, b))
    if errors:
        raise ValueError("torch import failed:\n  " + "\n  ".join(errors))
    filled = {}
    for conv, prefix, w, b in copies:
        conv.weight.copy_(w)
        conv.bias.copy_(b)
        dst = names[conv]
        filled[f"{dst}.weight"] = f"{prefix}.weight"
        filled[f"{dst}.bias"] = f"{prefix}.bias"
    return filled


def import_torch_checkpoint(path: str, model: nn.Module, **kw
                            ) -> Dict[str, str]:
    """``import_torch_state_dict`` of a ``.pth`` / ``.pt`` file: a plain
    state dict, or one under ``state_dict``, ``model`` or
    ``model_state_dict``. A checkpoint file of the port's
    ``CheckpointManager`` raises ``ValueError`` naming its directory."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and _PORT_STATE_KEYS <= obj.keys():
        raise ValueError(
            f"{path} is a train-state checkpoint of the port's "
            "CheckpointManager (step_<n>.pt), not a reference state dict: "
            "pass the directory that holds it (--ckpt DIR, or "
            "CheckpointManager(DIR).load()['model'])")
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state_dict"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    return import_torch_state_dict(obj, model, **kw)
