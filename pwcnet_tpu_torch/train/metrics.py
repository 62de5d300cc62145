"""Training metrics (counterpart of ``pwcnet_tpu/train/metrics.py``):
scalars to a JSONL file and images to PNG files under ``<log_dir>/images``
(``<tag>_<step>.png``, ``/`` in a tag as ``_``), each mirrored to
TensorBoard through ``tensorboardX`` when it can be imported. Only process
0 writes."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from pwcnet_tpu_torch.io.png import write_png
from pwcnet_tpu_torch.io.vis import flow_to_rgb
from pwcnet_tpu_torch.parallel.mesh import process_index


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self._is_main = process_index() == 0
        self._jsonl = self._tb = None
        if not self._is_main:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._image_dir = os.path.join(log_dir, "images")
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if not self._is_main:
            return
        values = {k: float(v) for k, v in values.items()}
        rec = {"step": int(step), "ts": time.time(), **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)

    def flow_image(self, step: int, tag: str, flow: np.ndarray,
                   max_mag: Optional[float] = None) -> None:
        self.image(step, tag, flow_to_rgb(np.asarray(flow), max_mag=max_mag))

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        """Write uint8 (H, W, 3) ``img``."""
        if not self._is_main:
            return
        img = np.asarray(img)
        os.makedirs(self._image_dir, exist_ok=True)
        write_png(os.path.join(self._image_dir,
                               f"{tag.replace('/', '_')}_{int(step)}.png"),
                  img)
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
