"""The parity harness (counterpart of ``pwcnet_tpu/train/parity.py``).

For one image pair, with a ground-truth ``.flo`` and/or a reference
implementation's predicted ``.flo``, and optionally a checkpoint, it
reports:

- the full-resolution EPE of the port's prediction against the GT flow;
- the EPE against the reference prediction, when one is given;
- per level: each predicted level, upsampled to full resolution and
  rescaled to pixels, against the GT;
- the mean flow magnitude;
- with ``sweep=True``, that report for all four combinations of
  ``resize_mode`` (half_pixel, align_corners) and ``input_center`` (False,
  True), and the best of them by the reference EPE (else the GT EPE).

CLI: ``python -m pwcnet_tpu_torch.cli parity --im1 a.png --im2 b.png
[--gt gt.flo] [--ref-flow ref.flo] [--ckpt DIR|ref.pth] [--sweep]
[overrides ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pwcnet_tpu_torch.compat.torch_import import import_torch_checkpoint
from pwcnet_tpu_torch.data.base import read_image
from pwcnet_tpu_torch.io import load_flow
from pwcnet_tpu_torch.train.checkpoint import load_model_weights
from pwcnet_tpu_torch.train.evaluate import pad_to_divisible
from pwcnet_tpu_torch.train.loop import build_model


def _epe(pred: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(((pred - ref) ** 2).sum(-1)).mean())


def parity_report(cfg, im1_path: str, im2_path: str,
                  gt_path: Optional[str] = None,
                  ref_flow_path: Optional[str] = None,
                  ckpt: Optional[str] = None, sweep: bool = False,
                  device=None) -> Dict:
    """The JAX harness's report dict, with its keys, for the port's model
    of ``cfg`` (bf16 or f32 as ``cfg.model.dtype`` says) on ``device``
    (None: the GPU).

    ``ckpt``: a ``.pth``/``.pt`` file is a reference state dict
    (``compat.import_torch_checkpoint``); a directory is the port's
    ``CheckpointManager``'s (an Orbax directory is refused); None keeps the
    port's seeded init (``cfg.train.seed``), whose weights are not those of
    the JAX harness's ``key(0)`` init, so its numbers differ from JAX's.
    """
    im1, im2 = read_image(im1_path), read_image(im2_path)
    gt = load_flow(gt_path) if gt_path else None
    ref = load_flow(ref_flow_path) if ref_flow_path else None

    @torch.inference_mode()
    def run(model_cfg) -> Dict:
        model = build_model(dataclasses.replace(cfg, model=model_cfg),
                            device)
        if ckpt and ckpt.endswith((".pth", ".pt")):
            import_torch_checkpoint(ckpt, model)
        elif ckpt:
            load_model_weights(model, ckpt)
        model.eval()
        div = model.pad_divisor
        p1, (h, w) = pad_to_divisible(im1[None], div)
        p2, _ = pad_to_divisible(im2[None], div)
        a = torch.tensor(p1, device=model.device)
        b = torch.tensor(p2, device=model.device)
        flows = model(a, b, train=False)
        hw = tuple(a.shape[1:3])

        def full_res(fl):
            return model.full_res_flow([fl], hw)[0, :h, :w].float().cpu(
            ).numpy()

        full = full_res(flows[-1])
        out: Dict = {
            "resize_mode": model_cfg.resize_mode,
            "input_center": model_cfg.input_center,
            "mean_flow_magnitude":
                float(np.sqrt((full ** 2).sum(-1)).mean()),
        }
        if gt is not None:
            out["epe_vs_gt"] = _epe(full, gt)
            out["per_level"] = [{"level_hw": list(fl.shape[1:3]),
                                 "epe_vs_gt": _epe(full_res(fl), gt)}
                                for fl in flows]
        if ref is not None:
            out["epe_vs_reference"] = _epe(full, ref)
        return out

    base = cfg.model
    if not sweep:
        return run(base)
    combos = [run(dataclasses.replace(base, resize_mode=mode,
                                      input_center=center))
              for mode in ("half_pixel", "align_corners")
              for center in (False, True)]
    key = ("epe_vs_reference" if ref is not None
           else "epe_vs_gt" if gt is not None else None)
    best = None
    if key:
        best = min(combos, key=lambda r: r[key])
        best = {k: best[k] for k in ("resize_mode", "input_center", key)}
    return {"sweep": combos, "best": best}
