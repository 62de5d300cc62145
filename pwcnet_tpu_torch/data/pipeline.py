"""Evaluation batches (counterpart of ``eval_batches`` and ``_fit_to_shape``
in ``pwcnet_tpu/data/pipeline.py``). The training ``Loader`` and the native
decoder come with the file datasets (ROADMAP A1)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pwcnet_tpu_torch.data.base import FlowDataset


def _fit_to_shape(sample: Dict[str, np.ndarray],
                  hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Center-crop what is larger than ``hw``, then pad bottom/right with
    zeros marked invalid, so every sample of a batch has one shape."""
    h, w = sample["im1"].shape[:2]
    th, tw = hw
    out = dict(sample)
    if h > th or w > tw:
        y0 = max((h - th) // 2, 0)
        x0 = max((w - tw) // 2, 0)
        for k in ("im1", "im2", "flow", "valid"):
            out[k] = out[k][y0:y0 + min(th, h), x0:x0 + min(tw, w)]
        h, w = out["im1"].shape[:2]
    if h < th or w < tw:
        pad_hw = ((0, th - h), (0, tw - w))
        for k in ("im1", "im2", "flow"):
            out[k] = np.pad(out[k], pad_hw + ((0, 0),))
        out["valid"] = np.pad(out["valid"], pad_hw)
    return out


def eval_batches(dataset: FlowDataset, batch: int,
                 limit: Optional[int] = None, div: int = 64
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """The first ``limit`` samples (all by default) in order, in batches of
    ``batch``, each fitted to the first sample's size rounded up to a
    multiple of ``div``; the last batch is filled up with all-invalid copies
    of its first sample."""
    n = len(dataset) if limit is None else min(limit, len(dataset))
    h, w = dataset[0]["im1"].shape[:2]
    pad_to = (-(-h // div) * div, -(-w // div) * div)
    for start in range(0, n, batch):
        samples = [_fit_to_shape(dataset[i], pad_to)
                   for i in range(start, min(start + batch, n))]
        while len(samples) < batch:
            dup = {k: v.copy() for k, v in samples[0].items()}
            dup["valid"] = np.zeros_like(dup["valid"])
            samples.append(dup)
        yield {k: np.stack([s[k] for s in samples]).astype(np.float32)
               for k in ("im1", "im2", "flow", "valid")}
