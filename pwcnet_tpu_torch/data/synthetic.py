"""Synthetic-motion pairs with exact dense ground-truth flow (counterpart of
``pwcnet_tpu/data/synthetic.py``).

A continuous texture ``T(x, y)`` (a sum of random sinusoidal plane waves;
composites of broadband textures across sharp boundaries in the "hard"
regime) and a smooth flow ``u`` (affine + Gaussian bumps) give
``im2(x) = T(x)`` and ``im1(x) = T(x + u(x))``, so ``im1(x) = im2(x + u(x))``
holds exactly and the ground truth is ``u``. The hard regime composites a
nearer, rigidly moving foreground layer (occlusions; its soft edge band is
marked invalid).

``_host_params`` draws a sample's parameters with numpy and ``_render``
evaluates them with torch, on whatever device the parameters are on. The
constants, the parameter law and the formulas are the JAX package's.
``SyntheticFlow`` is the host dataset (the eval split); training batches
come from ``make_device_batcher``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.data.base import FlowDataset, register_dataset
from pwcnet_tpu_torch.parallel.mesh import local_batch_size

N_WAVES = 24
WAVELEN_RANGE = (8.0, 128.0)   # px, log-uniform
TEX_STD = 0.18
N_BUMPS = 3
BUMP_SIGMA = (16.0, 64.0)      # px
BUMP_AMP = 5.0                 # px, uniform +/-
AFFINE_LIN = 0.02
AFFINE_SHIFT = 8.0             # px, uniform +/-

HARD_AFFINE_SHIFT = 40.0
HARD_BUMP_AMP = 20.0
FG_SHIFT = 56.0
FG_ROT = 0.15
FG_AX = (20.0, 90.0)
FG_EDGE = 1.0
FG_BAND = (0.02, 0.98)
HARD_WAVELEN_RANGE = (2.5, 256.0)
HARD_N_TEX = 3
HARD_FG_N_TEX = 2
BND_EDGE = 0.7
TEX_MEAN_JITTER = 0.18

Params = Dict[str, torch.Tensor]


def _tex_value(p: Params, prefix: str, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """The texture ``prefix`` at real coordinates: one sinusoid sum for 1-D
    wave parameters (K,), a composite across sigmoid line boundaries for
    stacked ones (S, K)."""
    fx, fy = p[prefix + "fx"], p[prefix + "fy"]
    ph0, w = p[prefix + "phase"], p[prefix + "w"]

    def one(fx, fy, ph0, w, mean=0.5):
        ph = (2.0 * math.pi) * (fx[:, None, None] * x[None]
                                + fy[:, None, None] * y[None])
        waves = torch.cos(ph + ph0[:, None, None])
        return mean + torch.tensordot(waves, w, dims=([0], [0]))

    if fx.dim() == 1:
        return torch.clamp(one(fx, fy, ph0, w), 0.0, 1.0)
    mean = 0.5 + p[prefix + "mean"]
    img = one(fx[0], fy[0], ph0[0], w[0], mean[0])
    for i in range(fx.shape[0] - 1):
        th = p[prefix + "bnd_theta"][i]
        ca, sa = torch.cos(th), torch.sin(th)
        d = (ca * (x - p[prefix + "bnd_pos"][i, 0])
             + sa * (y - p[prefix + "bnd_pos"][i, 1]))
        d = torch.clamp(d, -30.0 * BND_EDGE, 30.0 * BND_EDGE)
        m = 1.0 / (1.0 + torch.exp(-d / BND_EDGE))
        img = img + m[..., None] * (one(fx[i + 1], fy[i + 1], ph0[i + 1],
                                        w[i + 1], mean[i + 1]) - img)
    return torch.clamp(img, 0.0, 1.0)


def _render(hw: Tuple[int, int], p: Params) -> Dict[str, torch.Tensor]:
    """Texture and flow on the pixel grid, on the device of ``p``'s
    tensors (f32). Returns im1, im2 (H, W, 3) in [0, 1], flow (H, W, 2) and
    valid (H, W)."""
    h, w = hw
    dev = p["lin"].device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx, dy = xs - cx, ys - cy
    u = p["lin"][0, 0] * dx + p["lin"][0, 1] * dy + p["shift"][0]
    v = p["lin"][1, 0] * dx + p["lin"][1, 1] * dy + p["shift"][1]
    for j in range(N_BUMPS):
        r2 = (xs - p["pos"][j, 0]) ** 2 + (ys - p["pos"][j, 1]) ** 2
        g = torch.exp(-r2 / (2.0 * p["sigma"][j] ** 2))
        u = u + p["amp"][j, 0] * g
        v = v + p["amp"][j, 1] * g

    im2 = _tex_value(p, "", xs, ys)
    im1 = _tex_value(p, "", xs + u, ys + v)  # im1(x) = im2(x + u(x))
    flow = torch.stack([u, v], -1)
    if "fg_pos" not in p:
        return {"im1": im1, "im2": im2, "flow": flow,
                "valid": torch.ones((h, w), device=dev)}

    # Hard regime: a nearer rigid layer (rotation about its centre plus a
    # translation), defined in frame 2 and warped analytically.
    def fg_mask(x, y):
        dx0, dy0 = x - p["fg_pos"][0], y - p["fg_pos"][1]
        ca, sa = torch.cos(p["fg_angle"]), torch.sin(p["fg_angle"])
        ex = (ca * dx0 + sa * dy0) / p["fg_ax"][0]
        ey = (-sa * dx0 + ca * dy0) / p["fg_ax"][1]
        r = torch.sqrt(ex * ex + ey * ey + 1e-12)
        dist = torch.clamp((r - 1.0) * torch.minimum(p["fg_ax"][0],
                                                     p["fg_ax"][1]),
                           -30.0 * FG_EDGE, 30.0 * FG_EDGE)
        return 1.0 / (1.0 + torch.exp(dist / FG_EDGE))

    crot, srot = torch.cos(p["fg_rot"]), torch.sin(p["fg_rot"])
    dxf, dyf = xs - p["fg_pos"][0], ys - p["fg_pos"][1]
    uf = (crot - 1.0) * dxf - srot * dyf + p["fg_shift"][0]
    vf = srot * dxf + (crot - 1.0) * dyf + p["fg_shift"][1]

    m2 = fg_mask(xs, ys)[..., None]
    m1 = fg_mask(xs + uf, ys + vf)[..., None]
    im2 = m2 * _tex_value(p, "f", xs, ys) + (1.0 - m2) * im2
    im1 = m1 * _tex_value(p, "f", xs + uf, ys + vf) + (1.0 - m1) * im1
    fg1 = (m1[..., 0] >= 0.5).float()[..., None]
    flow = fg1 * torch.stack([uf, vf], -1) + (1.0 - fg1) * flow
    band = (m1[..., 0] > FG_BAND[0]) & (m1[..., 0] < FG_BAND[1])
    return {"im1": im1, "im2": im2, "flow": flow,
            "valid": 1.0 - band.float()}


def _host_params(rng: np.random.Generator,
                 regime: str = "smooth") -> Dict[str, np.ndarray]:
    """One sample's parameters (the JAX package's law and draw order)."""
    shift = HARD_AFFINE_SHIFT if regime == "hard" else AFFINE_SHIFT
    amp = HARD_BUMP_AMP if regime == "hard" else BUMP_AMP
    lam = np.exp(rng.uniform(np.log(WAVELEN_RANGE[0]),
                             np.log(WAVELEN_RANGE[1]), N_WAVES))
    theta = rng.uniform(0, 2 * math.pi, N_WAVES)
    sigma_w = TEX_STD * math.sqrt(2.0 / N_WAVES)
    p = {
        "fx": (np.cos(theta) / lam).astype(np.float32),
        "fy": (np.sin(theta) / lam).astype(np.float32),
        "phase": rng.uniform(0, 2 * math.pi, N_WAVES).astype(np.float32),
        "w": (rng.normal(0, sigma_w, (N_WAVES, 3))).astype(np.float32),
        "lin": rng.uniform(-AFFINE_LIN, AFFINE_LIN, (2, 2)).astype(
            np.float32),
        "shift": rng.uniform(-shift, shift, 2).astype(np.float32),
        "pos": rng.uniform(0, 1, (N_BUMPS, 2)).astype(np.float32),
        "sigma": rng.uniform(*BUMP_SIGMA, N_BUMPS).astype(np.float32),
        "amp": rng.uniform(-amp, amp, (N_BUMPS, 2)).astype(np.float32),
    }
    if regime == "hard":
        def waves(n_tex):
            lam = np.exp(rng.uniform(np.log(HARD_WAVELEN_RANGE[0]),
                                     np.log(HARD_WAVELEN_RANGE[1]),
                                     (n_tex, N_WAVES)))
            th = rng.uniform(0, 2 * math.pi, (n_tex, N_WAVES))
            return {
                "fx": (np.cos(th) / lam).astype(np.float32),
                "fy": (np.sin(th) / lam).astype(np.float32),
                "phase": rng.uniform(0, 2 * math.pi,
                                     (n_tex, N_WAVES)).astype(np.float32),
                "w": rng.normal(0, sigma_w,
                                (n_tex, N_WAVES, 3)).astype(np.float32),
                "bnd_pos": rng.uniform(0, 1, (n_tex - 1, 2)).astype(
                    np.float32),
                "bnd_theta": rng.uniform(0, 2 * math.pi, n_tex - 1).astype(
                    np.float32),
                "mean": rng.uniform(-TEX_MEAN_JITTER, TEX_MEAN_JITTER,
                                    (n_tex, 3)).astype(np.float32),
            }

        p.update(waves(HARD_N_TEX))
        p.update({"f" + k: v for k, v in waves(HARD_FG_N_TEX).items()})
        p.update({
            "fg_pos": rng.uniform(0, 1, 2).astype(np.float32),
            "fg_ax": rng.uniform(*FG_AX, 2).astype(np.float32),
            "fg_angle": np.float32(rng.uniform(0, math.pi)),
            "fg_rot": np.float32(rng.uniform(-FG_ROT, FG_ROT)),
            "fg_shift": rng.uniform(-FG_SHIFT, FG_SHIFT, 2).astype(
                np.float32),
        })
    return p


def _scale_pos(p: Dict[str, np.ndarray],
               hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Positions are drawn in [0, 1]^2; scale them to pixels."""
    q = dict(p)
    scale = np.asarray([hw[1] - 1.0, hw[0] - 1.0], dtype=p["pos"].dtype)
    for k in ("pos", "fg_pos", "bnd_pos", "fbnd_pos"):
        if k in p:
            q[k] = p[k] * scale
    return q


def to_device(p: Dict[str, np.ndarray], device) -> Params:
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in p.items()}


@register_dataset("synthetic")
class SyntheticFlow(FlowDataset):
    """Procedural pairs with exact dense ground truth, rendered on the CPU.

    Sample ``idx`` of a split is deterministic in ``(seed, stream, idx)``
    (stream 1 for "val", 0 otherwise) and equals the JAX package's sample
    of the same index: the same numpy draws, rendered by ``_render``.
    ``root`` is accepted and ignored, as the file datasets take one. The
    val split keeps rendered samples, read-only, up to ``cache_bytes``.
    """

    def __init__(self, root: str = "-", split: str = "train",
                 hw: Tuple[int, int] = (384, 448), length: int = 4000,
                 val_length: int = 256, seed: int = 17,
                 regime: str = "smooth", cache_bytes: int = 4 << 30):
        self.hw = tuple(hw)
        self.split = split
        self.seed = seed
        self.regime = regime
        self._len = val_length if split == "val" else length
        self._cache: Optional[dict] = {} if split == "val" else None
        self._cache_bytes_left = int(cache_bytes)

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        if self._cache is not None and idx in self._cache:
            return dict(self._cache[idx])
        stream = 1 if self.split == "val" else 0
        rng = np.random.default_rng((self.seed, stream, idx))
        p = _scale_pos(_host_params(rng, self.regime), self.hw)
        with torch.no_grad():
            s = _render(self.hw, to_device(p, "cpu"))
        out = {k: v.numpy() for k, v in s.items()}
        nbytes = sum(v.nbytes for v in out.values())
        if self._cache is not None and self._cache_bytes_left >= nbytes:
            for v in out.values():  # shared with every caller: freeze
                v.flags.writeable = False
            self._cache[idx] = out
            self._cache_bytes_left -= nbytes
        return dict(out)


# Where each array starts in ``_upload``'s buffer: a multiple of 128 f32
# (512 bytes, the CUDA caching allocator's rounding), so that every view is
# as aligned as an allocation of its own and the rendering picks the kernels
# it picks for one.
_ALIGN = 128

COUNTS = trace.counters("device_batcher", ("batches", "pinned_uploads"))


def _upload(draws: List[Dict[str, np.ndarray]], device) -> List[Params]:
    """The draws of a batch's samples (f32 arrays of the same keys and
    shapes) on ``device`` in one copy: one flat buffer of a block a sample,
    each array at the same offset in every block, handed back as views of
    the one device tensor in the arrays' shapes (two host calls a key;
    views launch nothing). To a GPU the buffer is pinned and the copy does
    not wait: the caching host allocator records the copy and hands the
    block out again only after it has run. Elsewhere the buffer is a plain
    tensor."""
    n, layout, block = len(draws), {}, 0
    for k, v in draws[0].items():
        layout[k] = (block, np.shape(v))
        block += -(-np.size(v) // _ALIGN) * _ALIGN
    gap = np.zeros(_ALIGN, np.float32)
    pieces = []
    for p in draws:
        for k in layout:
            v = p[k].ravel()
            pieces += (v, gap[:-v.size % _ALIGN])  # zeros to the next offset
    pin = torch.device(device).type == "cuda"
    host = torch.empty(n * block, dtype=torch.float32, pin_memory=pin)
    np.concatenate(pieces, out=host.numpy())
    if pin:
        dev = host.to(device, non_blocking=True)
        COUNTS["pinned_uploads"] += 1
    else:
        dev = host.to(device)
    cols = {}
    for k, (o, shape) in layout.items():
        inner = tuple(math.prod(shape[j + 1:]) for j in range(len(shape)))
        cols[k] = dev.as_strided((n, *shape), (block, *inner), o).unbind(0)
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def make_device_batcher(global_batch: int, hw: Tuple[int, int],
                        seed: int = 17, regime: str = "smooth",
                        device="cuda", mesh=None):
    """``step -> batch``: a dict of im1, im2 (N, H, W, 3), flow (N, H, W, 2)
    and valid (N, H, W), f32 on ``device``.

    Sample i of step s draws its parameters with
    ``np.random.default_rng((seed, 2, s, i))`` (stream tag 2, apart from the
    JAX package's host train/val streams 0 and 1) and renders them on the
    device, so the batches are deterministic in (seed, step) and a resumed
    run sees the same stream. Under a ``mesh`` the rank of data index r
    renders only its rows ``[r*N/p, (r+1)*N/p)`` of the global batch (p the
    data axis's size), with their global indices i: the data rows together
    are the one-process batch, and a data row's spatial and model replicas
    render the same rows. The JAX
    device batcher draws with ``jax.random``, whose bits torch cannot
    reproduce: the two batchers give the same law, not the same samples.
    Parity is held on ``_render``.

    A batch's draws reach the device in one copy (``_upload``), which on a
    GPU waits neither for the work queued before it nor for itself, so the
    draws and launches of one step overlap the device's work of the last.
    Spans ``device_batcher`` and its ``.draw`` (a sample's), ``.upload``
    (one a batch), ``.render`` (a sample's launches, then the stack)
    (``trace.py``); counters ``device_batcher.batches`` and
    ``.pinned_uploads``.
    """
    n = local_batch_size(global_batch, mesh)
    first = 0 if mesh is None else mesh.data_mesh.rank * n

    def batch(step: int) -> Dict[str, torch.Tensor]:
        with trace.span("device_batcher"):
            draws = []
            for i in range(first, first + n):
                with trace.span("device_batcher.draw"):
                    rng = np.random.default_rng((seed, 2, int(step), i))
                    draws.append(_scale_pos(_host_params(rng, regime), hw))
            with trace.span("device_batcher.upload"):
                params = _upload(draws, device)
            COUNTS["batches"] += 1
            samples = []
            for p in params:
                with trace.span("device_batcher.render"):
                    samples.append(_render(hw, p))
            with trace.span("device_batcher.render"):
                return {k: torch.stack([s[k] for s in samples])
                        for k in samples[0]}

    return batch
