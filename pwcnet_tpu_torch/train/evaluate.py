"""Single-pair inference (counterpart of ``pwcnet_tpu/train/evaluate.py``
``pad_to_divisible`` / ``predict_flow``): pad to the model's divisor,
forward, upsample the finest flow to full resolution, undo the supervision
scale, crop."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pwcnet_tpu_torch.models.pwcnet import PWCNet


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
    a = torch.from_numpy(p1).to(model.device)
    b = torch.from_numpy(p2).to(model.device)
    full = model.full_res_flow(model(a, b), tuple(a.shape[1:3]))
    return full[0, :h, :w].float().cpu().numpy()
