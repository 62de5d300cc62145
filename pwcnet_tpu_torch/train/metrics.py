"""Training metrics: a JSONL file, mirrored to TensorBoard through
``tensorboardX`` when it can be imported (counterpart of
``pwcnet_tpu/train/metrics.py``; its flow-image summaries come with the
evaluation, ROADMAP A2)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        values = {k: float(v) for k, v in values.items()}
        rec = {"step": int(step), "ts": time.time(), **values}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
