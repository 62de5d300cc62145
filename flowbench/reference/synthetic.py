"""The procedural training pairs of the ``synthetic-proof`` preset, drawn
and rendered again: a frozen copy of the program's sampler law and
renderer (``data/synthetic.py``: numpy draws per (seed, 2, step, sample),
a sum of plane waves warped by an affine flow with Gaussian bumps; the
smooth regime). The draws must repeat the program's bit for bit, so the
order and the constants here are the program's."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

N_WAVES = 24
WAVELEN_RANGE = (8.0, 128.0)
TEX_STD = 0.18
N_BUMPS = 3
BUMP_SIGMA = (16.0, 64.0)
BUMP_AMP = 5.0
AFFINE_LIN = 0.02
AFFINE_SHIFT = 8.0


def draw(seed: int, step: int, i: int,
         hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Sample i of training step ``step``: its parameters, positions in
    pixels."""
    rng = np.random.default_rng((seed, 2, int(step), i))
    lam = np.exp(rng.uniform(np.log(WAVELEN_RANGE[0]),
                             np.log(WAVELEN_RANGE[1]), N_WAVES))
    theta = rng.uniform(0, 2 * math.pi, N_WAVES)
    sigma_w = TEX_STD * math.sqrt(2.0 / N_WAVES)
    p = {
        "fx": (np.cos(theta) / lam).astype(np.float32),
        "fy": (np.sin(theta) / lam).astype(np.float32),
        "phase": rng.uniform(0, 2 * math.pi, N_WAVES).astype(np.float32),
        "w": rng.normal(0, sigma_w, (N_WAVES, 3)).astype(np.float32),
        "lin": rng.uniform(-AFFINE_LIN, AFFINE_LIN, (2, 2)).astype(
            np.float32),
        "shift": rng.uniform(-AFFINE_SHIFT, AFFINE_SHIFT, 2).astype(
            np.float32),
        "pos": rng.uniform(0, 1, (N_BUMPS, 2)).astype(np.float32),
        "sigma": rng.uniform(*BUMP_SIGMA, N_BUMPS).astype(np.float32),
        "amp": rng.uniform(-BUMP_AMP, BUMP_AMP, (N_BUMPS, 2)).astype(
            np.float32),
    }
    p["pos"] = p["pos"] * np.asarray([hw[1] - 1.0, hw[0] - 1.0], np.float32)
    return p


def _texture(p, x, y):
    ph = (2.0 * math.pi) * (p["fx"][:, None, None] * x[None]
                            + p["fy"][:, None, None] * y[None])
    waves = torch.cos(ph + p["phase"][:, None, None])
    return torch.clamp(0.5 + torch.tensordot(waves, p["w"], dims=([0], [0])),
                       0.0, 1.0)


def render(p: Dict[str, np.ndarray], hw: Tuple[int, int],
           device) -> Dict[str, torch.Tensor]:
    """im1, im2 (H, W, 3), flow (H, W, 2), valid (H, W): im2 is the texture,
    im1 the texture at x + flow(x)."""
    t = {k: torch.as_tensor(v, device=device) for k, v in p.items()}
    h, w = hw
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    dx, dy = xs - (w - 1) / 2.0, ys - (h - 1) / 2.0
    u = t["lin"][0, 0] * dx + t["lin"][0, 1] * dy + t["shift"][0]
    v = t["lin"][1, 0] * dx + t["lin"][1, 1] * dy + t["shift"][1]
    for j in range(N_BUMPS):
        r2 = (xs - t["pos"][j, 0]) ** 2 + (ys - t["pos"][j, 1]) ** 2
        g = torch.exp(-r2 / (2.0 * t["sigma"][j] ** 2))
        u = u + t["amp"][j, 0] * g
        v = v + t["amp"][j, 1] * g
    return {"im1": _texture(t, xs + u, ys + v), "im2": _texture(t, xs, ys),
            "flow": torch.stack([u, v], -1),
            "valid": torch.ones((h, w), device=device)}


def batch(seed: int, step: int, n: int, hw: Tuple[int, int],
          device) -> Dict[str, torch.Tensor]:
    samples = [render(draw(seed, step, i, hw), hw, device) for i in range(n)]
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
