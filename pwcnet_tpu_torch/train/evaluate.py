"""Evaluation (counterpart of ``pwcnet_tpu/train/evaluate.py``): dataset
EPE, Fl-all and their breakdowns (``evaluate_dataset``), and single-pair
inference (``predict_flow``: pad to the model's divisor, forward with
``train=False``, upsample the finest flow to full resolution, undo the
supervision scale, crop), for PWC-Net and RAFT. On a CUDA model both run
through the model's captured graphs (``capture.py``) unless the caller
passes ``capture=False``.

``predict_flow`` stages a pair through buffers that live with the model
(``_Stage``): the frames are copied once into a host buffer (pinned for a
GPU) and cross to the device in one non-blocking copy, into the interior
of a device buffer laid out as the padded pair whose margin was zeroed
when it was made. So the padding costs no host work and no copy.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.capture import capture_enabled, model_captured
from pwcnet_tpu_torch.data.base import FlowDataset
from pwcnet_tpu_torch.data.pipeline import eval_batches
from pwcnet_tpu_torch.models.pwcnet import PWCNet
from pwcnet_tpu_torch.models.raft import RAFT
from pwcnet_tpu_torch.parallel.mesh import (GridMesh, local_batch_size,
                                            shard_batch)
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


def _full_res(model, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return model.full_res_flow(model(a, b, train=False), tuple(a.shape[1:3]))


@torch.inference_mode()
def infer_flow(model: Union[PWCNet, RAFT], a: torch.Tensor, b: torch.Tensor,
               capture: Optional[bool] = None) -> torch.Tensor:
    """The inference forward of padded (N, H, W, 3) images on the model's
    device -> (N, H, W, 2) full-resolution pixel flow. ``capture`` (None:
    on a CUDA model) replays the model's graph of the input shape."""
    if capture_enabled(capture, model.device):
        return model_captured(model, "inference forward", _full_res)(
            model, a, b)
    return _full_res(model, a, b)


COUNTS = trace.counters("predict_flow", ("calls", "pinned_uploads"))


class _Stage:
    """The buffers that carry pairs of one frame shape to one device:
    ``host``, the pair as sent ((2, H, W, C) f32, pinned for a GPU);
    ``padded``, the pair as the model reads it ((2, H', W', C) f32 on the
    device, H' and W' the multiples of ``div`` that ``pad_to_divisible``
    gives, the bottom and right margin zeroed here and never written
    again); on a GPU ``copied``, the event of the last copy from one to the
    other, which the next call waits for before it writes ``host``; and
    ``lock``, which a call holds from writing ``host`` until its answer is
    fetched, so that calls from several threads take turns."""

    def __init__(self, shape: Tuple[int, int, int], div: int,
                 device: torch.device):
        h, w, c = shape
        self.pinned = device.type == "cuda"
        self.host = torch.empty((2, h, w, c), dtype=torch.float32,
                                pin_memory=self.pinned)
        self.padded = torch.zeros(
            (2, -(-h // div) * div, -(-w // div) * div, c),
            dtype=torch.float32, device=device)
        self.copied = torch.cuda.Event() if self.pinned else None
        self.lock = threading.Lock()


# Each model's stages, by device and frame shape, for as long as the model
# lives (as ``capture.model_captured`` keeps its graphs).
_STAGES: "weakref.WeakKeyDictionary[torch.nn.Module, Dict[tuple, _Stage]]" \
    = weakref.WeakKeyDictionary()


def _stage(model: Union[PWCNet, RAFT], shape: Tuple[int, ...]) -> _Stage:
    """``model``'s stage of frames of ``shape`` on its device, made on
    first use."""
    per = _STAGES.setdefault(model, {})
    key = (model.device, shape)
    if key not in per:
        per[key] = _Stage(shape, model.pad_divisor, model.device)
    return per[key]


@torch.inference_mode()
def predict_flow(model: Union[PWCNet, RAFT], im1: np.ndarray,
                 im2: np.ndarray, capture: Optional[bool] = None
                 ) -> np.ndarray:
    """(H, W, 3) images in [0, 1] -> (H, W, 2) f32 pixel flow at input
    resolution, on the model's device (through ``infer_flow``), as a fresh
    array that the caller owns. The pair goes through the model's
    ``_Stage`` of its shape (module docstring). Spans ``predict_flow`` and
    its ``.pad`` (reading the frames, acquiring the stage), ``.upload``
    (the copy into the host buffer and the issue of the copy to the
    device), ``.run``, ``.fetch``; counters ``predict_flow.calls`` and
    ``.pinned_uploads`` (``trace.py``)."""
    with trace.span("predict_flow"):
        COUNTS["calls"] += 1
        with trace.span("predict_flow.pad"):
            # No copy of an f32 frame; another dtype is converted here.
            f1, f2 = np.asarray(im1, np.float32), np.asarray(im2, np.float32)
            if f1.ndim != 3 or f2.shape != f1.shape:
                raise ValueError(f"predict_flow takes two (H, W, C) frames "
                                 f"of one shape; got {f1.shape} and "
                                 f"{f2.shape}")
            h, w = f1.shape[:2]
            stage = _stage(model, f1.shape)
        with stage.lock:
            with trace.span("predict_flow.upload"):
                if stage.pinned:  # the last copy out of ``host`` has run
                    stage.copied.synchronize()
                # numpy's copy, on this thread: torch's spreads over its
                # thread pool and waits for the slowest thread, which on the
                # eight cores of an H100 host put a tail of calls several
                # milliseconds long on a stream.
                host = stage.host.numpy()
                np.copyto(host[0], f1)
                np.copyto(host[1], f2)
                # Into a strided view: on a GPU torch lands the bytes in one
                # block, then places them with one copy on the device.
                stage.padded[:, :h, :w].copy_(stage.host,
                                              non_blocking=stage.pinned)
                if stage.pinned:
                    stage.copied.record(
                        torch.cuda.current_stream(stage.padded.device))
                    COUNTS["pinned_uploads"] += 1
            with trace.span("predict_flow.run"):
                full = infer_flow(model, stage.padded[:1], stage.padded[1:],
                                  capture)
            with trace.span("predict_flow.fetch"):
                return full[0, :h, :w].float().cpu().numpy()


def evaluate_dataset(model: Union[PWCNet, RAFT], dataset: FlowDataset,
                     batch: int = 4, limit: Optional[int] = None,
                     mesh: Optional[GridMesh] = None,
                     return_per_sample: bool = False,
                     capture: Optional[bool] = None):
    """Mean EPE and Fl-all (%) over the first ``limit`` samples, masked by
    validity (padding is invalid), with the EPE by GT magnitude and the
    per-sample means and standard errors: the JAX function's keys. With
    ``return_per_sample``, ``(that dict, rows)``: the eval step's (B, 8)
    per-sample rows of every batch in order, on the CPU, the last batch's
    filler rows (all zero) included.

    Under a ``mesh`` every rank calls this; each evaluates its data row's
    rows of each eval batch of ``batch`` pairs (which must divide over the
    data axis; the spatial and model replicas of a data row evaluate the
    same rows, counted once), and every rank returns the same dict. The sums stay on the model's
    device and are fetched once at the end. ``capture`` is the eval step's
    (``make_eval_step``).
    """
    local_batch_size(batch, mesh)
    step = make_eval_step(model, mesh, capture)
    totals, samples = None, []
    for b in eval_batches(dataset, batch, limit=limit,
                          div=model.pad_divisor):
        out = step({k: torch.from_numpy(v).to(model.device)
                    for k, v in shard_batch(mesh, b).items()})
        samples.append(out[4])
        totals = out[:4] if totals is None else tuple(
            t + o for t, o in zip(totals, out[:4]))
    num, outl, den, bins = (t.double().cpu().numpy() for t in totals)
    rows = torch.cat(samples).cpu()
    ps = rows.double().numpy()
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
    return (res, rows) if return_per_sample else res
