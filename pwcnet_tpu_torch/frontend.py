"""Two-view matching front-end (counterpart of ``pwcnet_tpu/frontend.py``):
dense flow to sparse, confidence-scored correspondences, for PWC-Net or
RAFT.

1. One batched forward computes both directions (the pair stacked as a
   batch of two).
2. Forward-backward consistency: e(x) = |F_fw(x) + F_bw(x + F_fw(x))|,
   with the backward field sampled by the port's bilinear warp
   (``ops/warp.py:warp_bilinear``).
3. Matches on a regular grid, kept where the consistency error is at most
   ``fb_threshold`` px and the forward target lies in the image.

Inputs and outputs are numpy arrays, as ``predict_flow``'s; the work runs on
the model's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from pwcnet_tpu_torch.models.pwcnet import _resolve_device
from pwcnet_tpu_torch.ops.warp import warp_bilinear
from pwcnet_tpu_torch.train.evaluate import infer_flow, pad_to_divisible


@torch.inference_mode()
def _both_flows(model, im1: np.ndarray, im2: np.ndarray,
                capture: Optional[bool] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 2) forward and backward pixel flows from one batched forward
    (``train=False``; captured on a CUDA model, see ``infer_flow``)."""
    h, w = im1.shape[:2]
    im1, im2 = np.asarray(im1, np.float32), np.asarray(im2, np.float32)
    a, _ = pad_to_divisible(np.stack([im1, im2]), model.pad_divisor)
    b, _ = pad_to_divisible(np.stack([im2, im1]), model.pad_divisor)
    a = torch.tensor(a, device=model.device)
    b = torch.tensor(b, device=model.device)
    full = infer_flow(model, a, b, capture)[:, :h, :w].float().cpu().numpy()
    return full[0], full[1]


@torch.inference_mode()
def fb_consistency(flow_fw: np.ndarray, flow_bw: np.ndarray,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> np.ndarray:
    """Per-pixel forward-backward error |F_fw(x) + F_bw(x + F_fw(x))| of two
    (H, W, 2) pixel flows, computed on ``device`` (None: the GPU)."""
    dev = _resolve_device(device)
    fw = torch.tensor(np.asarray(flow_fw, np.float32), device=dev)[None]
    bw = torch.tensor(np.asarray(flow_bw, np.float32), device=dev)[None]
    err = torch.sqrt(((fw + warp_bilinear(bw, fw)) ** 2).sum(-1))
    return err[0].cpu().numpy()


def match_two_view(model, im1: np.ndarray, im2: np.ndarray, *,
                   grid_step: int = 8, fb_threshold: float = 1.5,
                   capture: Optional[bool] = None
                   ) -> Dict[str, np.ndarray]:
    """Sparse matches between one image pair.

    Args:
      model: a flow model of the port (``PWCNet`` or ``RAFT``).
      im1, im2: (H, W, 3) float images in [0, 1].
      grid_step: the sampling stride in pixels.
      fb_threshold: the largest forward-backward error in px of a match.
      capture: the batched forward's (``train.evaluate.infer_flow``).

    Returns ``pts1``/``pts2`` (M, 2) f32 x-y coordinates, ``confidence``
    (M,) in (0, 1] (1 / (1 + fb_error)), and the dense ``flow`` (H, W, 2)
    and ``fb_error`` (H, W).
    """
    h, w = im1.shape[:2]
    flow_fw, flow_bw = _both_flows(model, im1, im2, capture)
    err = fb_consistency(flow_fw, flow_bw, model.device)

    ys, xs = np.mgrid[grid_step // 2:h:grid_step, grid_step // 2:w:grid_step]
    ys, xs = ys.ravel(), xs.ravel()
    tx, ty = xs + flow_fw[ys, xs, 0], ys + flow_fw[ys, xs, 1]
    e = err[ys, xs]
    keep = ((e <= fb_threshold)
            & (tx >= 0) & (tx <= w - 1) & (ty >= 0) & (ty <= h - 1))
    return {
        "pts1": np.stack([xs[keep], ys[keep]], -1).astype(np.float32),
        "pts2": np.stack([tx[keep], ty[keep]], -1).astype(np.float32),
        "confidence": (1.0 / (1.0 + e[keep])).astype(np.float32),
        "flow": flow_fw,
        "fb_error": err,
    }
