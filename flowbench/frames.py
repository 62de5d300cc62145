"""The stream traffic's frames: one seeded video sequence, made from a
traffic file's parameters. Frame t is a colour texture (a sum of plane
waves of log-uniform wavelengths) seen through a camera that has moved by
t seeded steps (a rotation about the centre, a zoom and a translation
each), so consecutive frames differ by a smooth flow of a few pixels and
no two pairs are alike. Drawn on the device in a few calls, returned as
f32 (H, W, 3) numpy arrays in [0, 1]."""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def make(traffic: dict, seed: int, device) -> List[np.ndarray]:
    h, w = traffic["frame_hw"]
    n, k = traffic["ring_frames"], traffic["waves"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    lo, hi = traffic["wavelength_px"]
    lam = torch.exp(uniform((k,), math.log(lo), math.log(hi)))
    theta = uniform((k,), 0.0, 2 * math.pi)
    fx, fy = torch.cos(theta) / lam, torch.sin(theta) / lam
    phase = uniform((k,), 0.0, 2 * math.pi)
    amp = torch.randn((k, 3), generator=gen, device=device) \
        * (traffic["texture_std"] * math.sqrt(2.0 / k))
    steps = torch.stack([
        uniform((n,), -traffic["rotation_rad"], traffic["rotation_rad"]),
        uniform((n,), -traffic["zoom"], traffic["zoom"]),
        uniform((n,), -traffic["shift_px"], traffic["shift_px"]),
        uniform((n,), -traffic["shift_px"], traffic["shift_px"])], 1)
    steps[0] = 0.0
    pose = steps.cumsum(0)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device) - (h - 1) / 2,
                            torch.arange(w, dtype=torch.float32,
                                         device=device) - (w - 1) / 2,
                            indexing="ij")
    frames = []
    for t in range(n):
        a, z, sx, sy = pose[t]
        scale = torch.exp(z)
        x = scale * (torch.cos(a) * xs - torch.sin(a) * ys) + sx
        y = scale * (torch.sin(a) * xs + torch.cos(a) * ys) + sy
        ph = 2 * math.pi * (fx[:, None, None] * x + fy[:, None, None] * y) \
            + phase[:, None, None]
        img = 0.5 + torch.tensordot(torch.cos(ph), amp, dims=([0], [0]))
        frames.append(img.clamp(0.0, 1.0))
    return [f.cpu().numpy() for f in frames]
