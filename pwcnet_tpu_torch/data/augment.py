"""Training augmentation on the device (counterpart of
``pwcnet_tpu/data/augment.py``): per sample a random crop, a horizontal and
a vertical flip (with the flow's sign fixed along the flipped axis) and
photometric jitter of the images only (contrast, brightness, gamma, a
colour scale per channel and Gaussian noise; the same for both frames
unless an asymmetric draw gives the second frame its own).

JAX draws with ``jax.random`` inside its jitted step, and torch cannot
replay those bits. So the port splits the work in two:

- ``draw_augment_params(generator, n, hw, cfg)`` draws every per-sample
  scalar on a CPU ``torch.Generator`` (the ``TrainState``'s, which a
  checkpoint saves) and packs them into one (n, ``N_PARAMS``) f32 tensor,
  with the seed of the step's noise;
- ``apply_augment(batch, params, cfg, noise)`` is a pure transform of a
  batch on any device given those scalars and the noise (a tensor, or a
  generator on the batch's device to draw it from).

``augment_batch`` is the two together. The transform follows JAX's order
and semantics: crop at ``randint(0, max(h - th, 0) + 1)``, then hflip
(negating u), then vflip (negating v), then ``(im - mean) * c + mean + b``
(mean per sample and channel over H, W), clip to [0, 1], ``** g``,
``* col``, ``+ noise``, clip. A symmetric draw gives frame 2 frame 1's b,
c, g, colour and noise field, as JAX's reuse of the same key does.
Nothing here reads a device value on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from pwcnet_tpu_torch.config import AugmentConfig

Batch = Dict[str, torch.Tensor]

# Columns of the packed parameters: the crop offsets, the flips, the
# asymmetric flag, then (b, c, g, col_r, col_g, col_b) of frame 1 and of
# frame 2 (frame 1's again where the draw is symmetric).
Y0, X0, HFLIP, VFLIP, ASYM = range(5)
PHOTO = (5, 11)  # first column of each frame's six photometric scalars
N_PARAMS = 17


def draw_augment_params(generator: torch.Generator, n: int,
                        hw: Tuple[int, int], cfg: AugmentConfig
                        ) -> Tuple[torch.Tensor, int]:
    """Draw the augmentation of n samples of size ``hw`` on the CPU
    ``generator``: (packed (n, N_PARAMS) f32 params on the CPU, the seed of
    the noise). The draws, in this order: y0, x0, the hflip, vflip and
    asymmetric uniforms, then per frame b, c, g and the colour scales, then
    the noise seed."""
    h, w = hw
    th, tw = cfg.crop_hw
    if th > h or tw > w:
        raise ValueError(f"crop {cfg.crop_hw} is larger than the samples "
                         f"{tuple(hw)}")

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    p = torch.empty((n, N_PARAMS))
    p[:, Y0] = torch.randint(0, h - th + 1, (n,), generator=generator)
    p[:, X0] = torch.randint(0, w - tw + 1, (n,), generator=generator)
    flips = torch.rand((3, n), generator=generator)
    p[:, HFLIP] = (flips[0] < cfg.hflip_prob).float()
    p[:, VFLIP] = (flips[1] < cfg.vflip_prob).float()
    p[:, ASYM] = (flips[2] < cfg.asymmetric_prob).float()
    b = uniform((2, n), -cfg.brightness, cfg.brightness)
    c = 1.0 + uniform((2, n), -cfg.contrast, cfg.contrast)
    g = uniform((2, n), cfg.gamma[0], cfg.gamma[1])
    col = 1.0 + uniform((2, n, 3), -cfg.color, cfg.color)
    frame = torch.cat([b[..., None], c[..., None], g[..., None], col], -1)
    asym = p[:, ASYM, None] > 0
    p[:, PHOTO[0]:PHOTO[0] + 6] = frame[0]
    p[:, PHOTO[1]:PHOTO[1] + 6] = torch.where(asym, frame[1], frame[0])
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return p, seed


def draw_noise(generator: torch.Generator, params: torch.Tensor,
               cfg: AugmentConfig, device) -> torch.Tensor:
    """Standard normal noise (2, n, th, tw, 3) on ``device`` from
    ``generator`` (on that device); frame 2's is frame 1's where the
    sample's draw is symmetric."""
    n = params.shape[0]
    z = torch.randn((2, n, *cfg.crop_hw, 3), generator=generator,
                    device=device)
    asym = params[:, ASYM].to(device).view(n, 1, 1, 1) > 0
    return torch.stack([z[0], torch.where(asym, z[1], z[0])])


def _crop_flip(a: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    idx = torch.arange(n, device=a.device).view(n, 1, 1)
    return a[idx, rows[:, :, None], cols[:, None, :]]


def _photometric(im: torch.Tensor, q: torch.Tensor, noise: torch.Tensor,
                 cfg: AugmentConfig) -> torch.Tensor:
    b, c, g = (q[:, i].view(-1, 1, 1, 1) for i in range(3))
    col = q[:, 3:6].view(-1, 1, 1, 3)
    mean = im.mean(dim=(1, 2), keepdim=True)
    im = (im - mean) * c + mean + b
    im = im.clamp(0.0, 1.0) ** g
    im = im * col
    return (im + cfg.noise_std * noise).clamp(0.0, 1.0)


def apply_augment(batch: Batch, params: torch.Tensor, cfg: AugmentConfig,
                  noise: Optional[Union[torch.Tensor, torch.Generator]]
                  = None) -> Batch:
    """The augmentation of ``batch`` (f32 im1, im2 (N, H, W, 3), flow
    (N, H, W, 2), valid (N, H, W)) given the packed ``params`` of
    ``draw_augment_params`` (on any device) and ``noise``: a standard
    normal (2, N, th, tw, 3) tensor as ``draw_noise`` gives, or a generator
    to draw it from (unused when ``cfg.photometric`` is off). The crop and
    the flips are one gather per tensor."""
    dev = batch["im1"].device
    if dev.type == "cuda" and not params.is_cuda:
        params = params.pin_memory()  # an asynchronous copy, no host wait
    p = params.to(dev, non_blocking=True)
    th, tw = cfg.crop_hw
    ar_h = torch.arange(th, device=dev)
    ar_w = torch.arange(tw, device=dev)
    hflip, vflip = p[:, HFLIP, None] > 0, p[:, VFLIP, None] > 0
    rows = p[:, Y0, None].long() + torch.where(vflip, th - 1 - ar_h, ar_h)
    cols = p[:, X0, None].long() + torch.where(hflip, tw - 1 - ar_w, ar_w)
    out = {k: _crop_flip(v, rows, cols) for k, v in batch.items()}
    sign = torch.stack([1.0 - 2.0 * p[:, HFLIP], 1.0 - 2.0 * p[:, VFLIP]],
                       -1).view(-1, 1, 1, 2)
    out["flow"] = out["flow"] * sign
    if cfg.photometric:
        if isinstance(noise, torch.Generator):
            noise = draw_noise(noise, p, cfg, dev)
        for i, key in enumerate(("im1", "im2")):
            q = p[:, PHOTO[i]:PHOTO[i] + 6]
            out[key] = _photometric(out[key], q, noise[i], cfg)
    return out


def augment_batch(batch: Batch, generator: torch.Generator,
                  cfg: AugmentConfig,
                  noise_generator: Optional[torch.Generator] = None
                  ) -> Batch:
    """Draw on the CPU ``generator``, then apply on the batch's device;
    the noise comes from ``noise_generator`` (on that device), reseeded
    with the drawn seed, or from a fresh generator when None."""
    n, h, w = batch["im1"].shape[:3]
    params, seed = draw_augment_params(generator, n, (h, w), cfg)
    dev = batch["im1"].device
    if noise_generator is None:
        noise_generator = torch.Generator(device=dev)
    noise_generator.manual_seed(seed)
    return apply_augment(batch, params, cfg, noise_generator)
