"""The host input pipeline (counterpart of ``pwcnet_tpu/data/pipeline.py``):
the training ``Loader`` (deterministic in (seed, step), threaded, with
prefetch and the native decoder's fast path) and the evaluation batches.

Batches are numpy on the host; the trainer copies them to the card, where
the augmentation runs inside the train step (``data/augment.py``).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from pwcnet_tpu_torch import native, trace
from pwcnet_tpu_torch.data.base import FlowDataset

_log = logging.getLogger(__name__)
KEYS = ("im1", "im2", "flow", "valid")


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
        for k in KEYS:
            out[k] = out[k][y0:y0 + min(th, h), x0:x0 + min(tw, w)]
        h, w = out["im1"].shape[:2]
    if h < th or w < tw:
        pad_hw = ((0, th - h), (0, tw - w))
        for k in ("im1", "im2", "flow"):
            out[k] = np.pad(out[k], pad_hw + ((0, 0),))
        out["valid"] = np.pad(out["valid"], pad_hw)
    return out


def _stack(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]).astype(np.float32)
            for k in KEYS}


class Loader:
    """Deterministic, threaded, endless batch iterator (the JAX package's
    ``Loader``): ``next(loader)`` is a dict of f32 numpy im1, im2
    (n, H, W, 3), flow (n, H, W, 2) and valid (n, H, W), each sample fitted
    to ``sample_hw`` (center crop, or zero padding marked invalid), with n
    the rows of this process.

    Step s of a global batch b takes the dataset indices
    ``perm[pos * b:(pos + 1) * b]`` of the permutation
    ``default_rng((seed, epoch)).permutation(len(dataset))``, where
    ``epoch, pos = divmod(s, max(len(dataset) // b, 1))``, wrapped around
    its start when the dataset has fewer than b samples; process r of p
    takes rows ``[r * b / p, (r + 1) * b / p)``. A loader made with
    ``start_step=s`` yields step s first, so a resumed run reads what the
    uninterrupted one read.

    A producer thread decodes ahead into a queue of ``prefetch`` batches.
    FlyingChairs records (.ppm, .ppm, .flo) go through the native decoder
    (``pwcnet_tpu_torch.native``) when it builds, and everything else
    through the dataset on a pool of ``num_threads`` threads; ``decoded``
    counts the batches of each path. ``close()`` stops and joins the
    producer.
    """

    def __init__(self, dataset: FlowDataset, global_batch: int,
                 sample_hw: Tuple[int, int], seed: int = 0,
                 num_threads: int = 8, start_step: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 4):
        if global_batch % process_count:
            raise ValueError("global batch must divide across processes")
        self.dataset = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.sample_hw = tuple(sample_hw)
        self.seed = seed
        self.rank = process_index
        self.step = start_step
        self.decoded = {"native": 0, "python": 0}
        self._steps_per_epoch = max(len(dataset) // global_batch, 1)
        self._num_threads = num_threads
        self._warned = False
        self._pool = ThreadPoolExecutor(max_workers=num_threads,
                                        thread_name_prefix="pwcnet-loader")
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def indices_for_step(self, step: int) -> np.ndarray:
        """The dataset indices of this process's rows at ``step``."""
        epoch, pos = divmod(step, self._steps_per_epoch)
        perm = np.random.default_rng((self.seed, epoch)).permutation(
            len(self.dataset))
        start = pos * self.global_batch
        g = perm[start:start + self.global_batch]
        if g.size < self.global_batch:
            g = np.concatenate([g, perm[:self.global_batch - g.size]])
        lo = self.rank * self.local_batch
        return g[lo:lo + self.local_batch]

    def native_batch(self, idxs) -> Optional[Dict[str, np.ndarray]]:
        """The batch of ``idxs`` from the native decoder; None where the
        records are not (.ppm, .ppm, .flo) or the decoder did not build
        (logged once)."""
        recs = getattr(self.dataset, "records", None)
        if recs is None:
            return None
        batch = [recs[int(i)] for i in idxs]
        if not all(r.im1.endswith(".ppm") and r.im2.endswith(".ppm")
                   and r.flow.endswith(".flo") for r in batch):
            return None
        if not native.available():
            if not self._warned:
                self._warned = True
                _log.warning("the native decoder did not build; decoding "
                             "(.ppm, .ppm, .flo) records in Python: %s",
                             native.BUILD_ERROR)
            return None
        return native.decode_batch(
            [r.im1 for r in batch], [r.im2 for r in batch],
            [r.flow for r in batch], self.sample_hw,
            num_threads=self._num_threads)

    def python_batch(self, idxs) -> Dict[str, np.ndarray]:
        """The batch of ``idxs`` through the dataset's own decoding."""
        return _stack(list(self._pool.map(
            lambda i: _fit_to_shape(self.dataset[int(i)], self.sample_hw),
            idxs)))

    def _load_batch(self, step: int) -> Dict[str, np.ndarray]:
        idxs = self.indices_for_step(step)
        batch = self.native_batch(idxs)
        path = "python" if batch is None else "native"
        if batch is None:
            batch = self.python_batch(idxs)
        self.decoded[path] += 1
        return batch

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                batch = self._load_batch(step)
            except RuntimeError:
                # close() shuts the pool down under a running map.
                if self._stop.is_set():
                    return
                raise
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        with trace.span("loader.wait"):
            while True:
                try:
                    step, batch = self._q.get(timeout=1.0)
                    break
                except queue.Empty:
                    if not self._thread.is_alive():
                        raise RuntimeError(
                            "the Loader's producer stopped (see its "
                            "traceback above)") from None
        self.step = step + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)


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
        yield _stack(samples)
