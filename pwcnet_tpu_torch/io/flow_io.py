"""Optical-flow file formats: Middlebury ``.flo``, ``.pfm`` and KITTI 16-bit
PNG (numpy only; the port's own copy of ``pwcnet_tpu/io/flow_io.py``, with
the KITTI PNGs through the port's PNG codec in place of ``cv2``).

``load_flow``/``save_flow`` dispatch on the extension.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from pwcnet_tpu_torch.io.png import read_png, write_png

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


def read_pfm(path: str) -> np.ndarray:
    """Read a ``.pfm`` file -> float32 (H, W) or (H, W, 3), top row first."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        channels = 3 if header == "PF" else 1
        dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4", count=h * w * channels)
    img = np.flipud(data.reshape(h, w, channels))  # stored bottom row first
    if channels == 1:
        img = img[..., 0]
    return np.ascontiguousarray(img.astype(np.float32))


def write_pfm(path: str, img: np.ndarray, scale: float = 1.0) -> None:
    """Write float32 (H, W) or (H, W, 3) as little-endian ``.pfm``."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        header = "Pf"
    elif img.ndim == 3 and img.shape[-1] == 3:
        header = "PF"
    else:
        raise ValueError(f"image must be (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"{header}\n{w} {h}\n{-abs(scale)}\n".encode("latin-1"))
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_kitti_png(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a KITTI flow PNG -> (flow (H, W, 2), valid (H, W)), float32.

    16-bit RGB: ``u = (R - 2**15) / 64``, ``v = (G - 2**15) / 64``,
    ``valid = B > 0``; invalid pixels' flow is zeroed."""
    raw = read_png(path)
    if raw.dtype != np.uint16 or raw.ndim != 3 or raw.shape[-1] != 3:
        raise ValueError(f"{path}: expected a 16-bit 3-channel PNG, got "
                         f"{raw.dtype} {raw.shape}")
    rgb = raw.astype(np.float32)
    valid = (rgb[..., 2] > 0).astype(np.float32)
    flow = (rgb[..., :2] - 2.0 ** 15) / 64.0
    return flow * valid[..., None], valid


def write_kitti_png(path: str, flow: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> None:
    """Write flow (H, W, 2) [+ valid mask] as a KITTI 16-bit PNG."""
    flow = np.asarray(flow, np.float32)
    if valid is None:
        valid = np.ones(flow.shape[:2], np.float32)
    uv = np.clip(flow * 64.0 + 2.0 ** 15, 0, 65535).astype(np.uint16)
    b = (np.asarray(valid) > 0).astype(np.uint16)
    write_png(path, np.concatenate([uv, b[..., None]], -1))


def load_flow(path: str) -> np.ndarray:
    """Load flow from ``.flo`` / ``.pfm`` / KITTI ``.png`` (for a KITTI PNG
    the flow only; ``read_kitti_png`` gives the mask too)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        pfm = read_pfm(path)
        # FlyingThings flow PFMs have an unused third channel.
        return pfm[..., :2] if pfm.ndim == 3 else pfm
    if ext == ".png":
        return read_kitti_png(path)[0]
    raise ValueError(f"unknown flow format: {path}")


def save_flow(path: str, flow: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        write_flo(path, flow)
    elif ext == ".pfm":
        flow = np.asarray(flow, np.float32)
        write_pfm(path, np.concatenate(
            [flow, np.zeros(flow.shape[:2] + (1,), np.float32)], -1))
    elif ext == ".png":
        write_kitti_png(path, flow)
    else:
        raise ValueError(f"unknown flow format: {path}")
