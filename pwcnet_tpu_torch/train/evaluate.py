"""Evaluation (counterpart of ``pwcnet_tpu/train/evaluate.py``): dataset
EPE, Fl-all and their breakdowns (``evaluate_dataset``), and single-pair
inference (``predict_flow``: pad to the model's divisor, forward, upsample
the finest flow to full resolution, undo the supervision scale, crop)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pwcnet_tpu_torch.data.base import FlowDataset
from pwcnet_tpu_torch.data.pipeline import eval_batches
from pwcnet_tpu_torch.models.pwcnet import PWCNet
from pwcnet_tpu_torch.train.step import make_eval_step


def pad_to_divisible(img: np.ndarray, div: int = 64
                     ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad (bottom/right) H, W to multiples of ``div``; returns the
    padded array and the original (H, W)."""
    h, w = img.shape[-3:-1]
    ph, pw = -(-h // div) * div, -(-w // div) * div
    if (ph, pw) == (h, w):
        return img, (h, w)
    pad = [(0, 0)] * (img.ndim - 3) + [(0, ph - h), (0, pw - w), (0, 0)]
    return np.pad(img, pad), (h, w)


@torch.inference_mode()
def predict_flow(model: PWCNet, im1: np.ndarray, im2: np.ndarray
                 ) -> np.ndarray:
    """(H, W, 3) images in [0, 1] -> (H, W, 2) f32 pixel flow at input
    resolution, on the model's device."""
    div = model.pad_divisor
    p1, (h, w) = pad_to_divisible(np.asarray(im1, np.float32)[None], div)
    p2, _ = pad_to_divisible(np.asarray(im2, np.float32)[None], div)
    a = torch.tensor(p1, device=model.device)  # a copy: p1 may be read-only
    b = torch.tensor(p2, device=model.device)
    full = model.full_res_flow(model(a, b), tuple(a.shape[1:3]))
    return full[0, :h, :w].float().cpu().numpy()


def evaluate_dataset(model: PWCNet, dataset: FlowDataset, batch: int = 4,
                     limit: Optional[int] = None) -> Dict[str, float]:
    """Mean EPE and Fl-all (%) over the first ``limit`` samples, masked by
    validity (padding is invalid), with the EPE by GT magnitude and the
    per-sample means and standard errors: the JAX function's keys.

    The sums stay on the model's device and are fetched once at the end.
    """
    step = make_eval_step(model)
    totals, samples = None, []
    for b in eval_batches(dataset, batch, limit=limit,
                          div=model.pad_divisor):
        out = step({k: torch.from_numpy(v).to(model.device)
                    for k, v in b.items()})
        samples.append(out[4])
        totals = out[:4] if totals is None else tuple(
            t + o for t, o in zip(totals, out[:4]))
    num, outl, den, bins = (t.double().cpu().numpy() for t in totals)
    ps = torch.cat(samples).double().cpu().numpy()
    num, outl, den = float(num), float(outl), max(float(den), 1.0)
    res = {"epe": num / den, "fl_all": 100.0 * outl / den,
           "num_valid_px": den}
    for name, (se, ce) in zip(("epe_s0_10", "epe_s10_40", "epe_s40plus"),
                              bins.T):
        res[name] = float(se) / max(float(ce), 1.0)
    # Per-sample statistics; all-invalid rows are the last batch's filler.
    ps = ps[ps[:, 1] > 0]
    res["num_samples"] = len(ps)
    for name, (s_col, c_col) in (("epe", (0, 1)), ("epe_s0_10", (2, 5)),
                                 ("epe_s10_40", (3, 6)),
                                 ("epe_s40plus", (4, 7))):
        has = ps[:, c_col] > 0
        if not has.any():
            continue
        vals = ps[has, s_col] / ps[has, c_col]
        res[f"{name}_sample_mean"] = float(vals.mean())
        res[f"{name}_sample_stderr"] = float(
            vals.std(ddof=1) / np.sqrt(len(vals))) if len(vals) > 1 else 0.0
    return res
