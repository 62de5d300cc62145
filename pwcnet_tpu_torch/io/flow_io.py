"""Middlebury ``.flo`` read/write (numpy only).

The port's own copy of the ``.flo`` part of ``pwcnet_tpu/io/flow_io.py``;
``load_flow``/``save_flow`` dispatch on the extension and take ``.flo`` only.
"""

from __future__ import annotations

import os

import numpy as np

FLO_MAGIC = 202021.25  # Middlebury sanity-check magic number.


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury ``.flo`` file -> float32 array of shape (H, W, 2)."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if not np.isclose(magic, FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
        if data.size != h * w * 2:
            raise ValueError(f"{path}: truncated .flo ({data.size} floats, "
                             f"expected {h * w * 2})")
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write float32 flow (H, W, 2) as Middlebury ``.flo``."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(FLO_MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())


def _check_flo(path: str) -> None:
    if os.path.splitext(path)[1].lower() != ".flo":
        raise ValueError(f"unsupported flow format (only .flo is ported): "
                         f"{path}")


def load_flow(path: str) -> np.ndarray:
    _check_flo(path)
    return read_flo(path)


def save_flow(path: str, flow: np.ndarray) -> None:
    _check_flo(path)
    write_flo(path, flow)
