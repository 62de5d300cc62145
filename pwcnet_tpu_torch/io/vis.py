"""Flow visualization: the Middlebury 55-bin color wheel (the port's own
copy of ``pwcnet_tpu/io/vis.py``): flow -> uint8 RGB, hue for direction,
saturation for magnitude (normalized by the image's largest magnitude)."""

from __future__ import annotations

from typing import Optional

import numpy as np

# Middlebury wheel segment lengths: RY, YG, GC, CB, BM, MR.
_SEGMENTS = (15, 6, 4, 11, 13, 6)


def make_color_wheel() -> np.ndarray:
    """The (55, 3) uint8 Middlebury color wheel."""
    ry, yg, gc, cb, bm, mr = _SEGMENTS
    wheel = np.zeros((sum(_SEGMENTS), 3), np.uint8)
    ramp = lambda n: np.floor(255 * np.arange(n) / n)  # noqa: E731
    col = 0
    wheel[col:col + ry, 0] = 255
    wheel[col:col + ry, 1] = ramp(ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - ramp(yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = ramp(gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - ramp(cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = ramp(bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - ramp(mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def flow_to_rgb(flow: np.ndarray,
                max_mag: Optional[float] = None) -> np.ndarray:
    """Render flow (H, W, 2) as uint8 RGB (H, W, 3). ``max_mag`` overrides
    the per-image magnitude normalization; NaNs render black."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    nan = ~np.isfinite(u) | ~np.isfinite(v)
    u[nan] = 0.0
    v[nan] = 0.0
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-3)
    u, v, mag = u / max_mag, v / max_mag, mag / max_mag

    ncols = _WHEEL.shape[0]
    angle = np.arctan2(-v, -u) / np.pi  # in (-1, 1]
    fk = (angle + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    c0 = _WHEEL[k0].astype(np.float32) / 255.0
    c1 = _WHEEL[k1].astype(np.float32) / 255.0
    color = (1 - f) * c0 + f * c1
    # Towards white for small magnitudes; darker out of range.
    m = np.clip(mag, 0.0, None)[..., None]
    color = np.where(m <= 1.0, 1.0 - m * (1.0 - color), color * 0.75)
    color[nan] = 0.0
    return (255.0 * color).astype(np.uint8)
