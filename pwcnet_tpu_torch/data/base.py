"""Dataset base (counterpart of ``pwcnet_tpu/data/base.py``): image reading,
sample records, deterministic splits, resizing, the ``FlowDataset``
interface and the dataset registry.

Images are read by the port's own codecs (``io/png.py``: PNG, PPM), and
resized by the port's own bilinear resize (numpy; the JAX package calls
``cv2``, which the GPU machine does not have). The file datasets register
themselves in ``data/datasets.py``, the synthetic one in
``data/synthetic.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pwcnet_tpu_torch.io.png import read_png, read_ppm


def read_image(path: str) -> np.ndarray:
    """Read a PNG or PPM file -> float32 RGB (H, W, 3) in [0, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        img = read_png(path)
    elif ext == ".ppm":
        img = read_ppm(path)
    else:
        raise ValueError(f"unsupported image format (PNG, PPM): {path}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3]
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    return img.astype(np.float32) / scale


@dataclass(frozen=True)
class SampleRecord:
    """Paths of one pair; ``flow`` may carry a validity channel (KITTI)."""
    im1: str
    im2: str
    flow: str


def require_dir(path: str, what: str) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{what} directory not found: {path}")


def center_crop(arrs: Sequence[np.ndarray],
                hw: Tuple[int, int]) -> List[np.ndarray]:
    h, w = arrs[0].shape[:2]
    th, tw = hw
    y0 = max((h - th) // 2, 0)
    x0 = max((w - tw) // 2, 0)
    return [a[y0:y0 + th, x0:x0 + tw] for a in arrs]


def _linear_taps(n_in: int, n_out: int, coord_dtype):
    """Source indices and weights of a half-pixel linear resize along one
    axis, clamped at the edges, as ``cv2.INTER_LINEAR`` takes them: the
    coordinate in ``coord_dtype``, the weights in float32."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(coord_dtype)
    i0 = np.floor(f)
    frac = (f - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1),
            1.0 - frac, frac)


def resize_sample(im: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of (H, W[, C]) to ``hw`` with half-pixel centres and
    edge clamping (``cv2.resize(..., INTER_LINEAR)``), in float32: along
    W first, then along H, as cv2's two passes. cv2 keeps the source
    coordinate in float64 for 1, 3 and 4 channels and rounds it to float32
    for other counts (such as a flow's 2); so does this."""
    a = np.asarray(im, np.float32)
    cn = a.shape[2] if a.ndim == 3 else 1
    coord = np.float64 if cn in (1, 3, 4) else np.float32
    y0, y1, wy0, wy1 = _linear_taps(a.shape[0], hw[0], coord)
    x0, x1, wx0, wx1 = _linear_taps(a.shape[1], hw[1], coord)
    tail = (1,) * (a.ndim - 2)
    cols = (a[:, x0] * wx0.reshape(1, -1, *tail)
            + a[:, x1] * wx1.reshape(1, -1, *tail))
    return (cols[y0] * wy0.reshape(-1, 1, *tail)
            + cols[y1] * wy1.reshape(-1, 1, *tail))


def resize_flow(flow: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize dense flow (H, W, 2) to ``hw``, scaling u by the width ratio
    and v by the height ratio."""
    h, w = flow.shape[:2]
    out = resize_sample(flow, hw)
    return out * np.asarray([hw[1] / w, hw[0] / h], np.float32)


class FlowDataset:
    """An indexable flow dataset of decoded numpy samples: ``ds[i]`` is a
    dict of im1, im2 (H, W, 3) f32 in [0, 1], flow (H, W, 2) f32 pixels and
    valid (H, W) f32 (all ones where the ground truth is dense).

    A file dataset fills ``self.records`` and implements ``_load``; a
    dataset without records (the synthetic one) overrides ``__len__`` and
    ``__getitem__``.
    """

    records: List[SampleRecord]

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = self._load(self.records[idx])
        if "valid" not in sample:
            sample["valid"] = np.ones(sample["flow"].shape[:2], np.float32)
        return sample

    @staticmethod
    def split_records(records: Sequence[SampleRecord], split: str,
                      val_fraction: float = 0.1,
                      seed: int = 0) -> List[SampleRecord]:
        """A seeded train/val split: a ``default_rng(seed)`` permutation,
        its first ``max(int(n * val_fraction), 1)`` entries for val, the
        rest for train, each kept in record order; ``"all"`` keeps all."""
        if split == "all":
            return list(records)
        idx = np.random.default_rng(seed).permutation(len(records))
        n_val = max(int(len(records) * val_fraction), 1)
        chosen = idx[:n_val] if split == "val" else idx[n_val:]
        return [records[i] for i in sorted(chosen)]

    @staticmethod
    def split_groups(records: Sequence[SampleRecord], keys: Sequence[str],
                     split: str, val_fraction: float = 0.1,
                     seed: int = 0) -> List[SampleRecord]:
        """As ``split_records`` over whole groups (``keys``, e.g. Sintel
        scenes), so that near-duplicate frames of one scene never land on
        both sides."""
        if split == "all":
            return list(records)
        groups = sorted(set(keys))
        order = np.random.default_rng(seed).permutation(len(groups))
        n_val = max(int(len(groups) * val_fraction), 1)
        val_groups = {groups[i] for i in order[:n_val]}
        want_val = split == "val"
        return [r for r, k in zip(records, keys)
                if (k in val_groups) == want_val]


_REGISTRY: Dict[str, type] = {}


def register_dataset(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def _register_all() -> None:
    # Each dataset module registers its classes when it is imported.
    import pwcnet_tpu_torch.data.datasets  # noqa: F401
    import pwcnet_tpu_torch.data.synthetic  # noqa: F401


def get_dataset(name: str, root: str, split: str = "train",
                **kwargs) -> FlowDataset:
    """The registered dataset ``name`` (the JAX package's factory)."""
    _register_all()
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; have {sorted(_REGISTRY)}") from None
    return cls(root=root, split=split, **kwargs)


def available_datasets() -> List[str]:
    _register_all()
    return sorted(_REGISTRY)
