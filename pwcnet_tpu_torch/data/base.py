"""Dataset base (counterpart of ``pwcnet_tpu/data/base.py``): image reading,
the ``FlowDataset`` interface, the dataset registry and ``center_crop``.

Images are read by the port's own codecs (``io/png.py``: PNG, PPM). The
file datasets (``pwcnet_tpu/data/datasets.py``: Chairs, Things, Sintel,
KITTI) are not ported yet: ``get_dataset`` raises for them, naming
ROADMAP A1.
"""

from __future__ import annotations

import abc
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from pwcnet_tpu_torch.io.png import read_png, read_ppm

# The JAX package's file datasets, which wait for ROADMAP A1.
FILE_DATASETS = ("flyingchairs", "flyingthings", "sintel", "kitti")


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


def center_crop(arrs: Sequence[np.ndarray],
                hw: Tuple[int, int]) -> List[np.ndarray]:
    h, w = arrs[0].shape[:2]
    th, tw = hw
    y0 = max((h - th) // 2, 0)
    x0 = max((w - tw) // 2, 0)
    return [a[y0:y0 + th, x0:x0 + tw] for a in arrs]


class FlowDataset(abc.ABC):
    """An indexable flow dataset of decoded numpy samples: ``ds[i]`` is a
    dict of im1, im2 (H, W, 3) f32 in [0, 1], flow (H, W, 2) f32 pixels and
    valid (H, W) f32."""

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        ...


_REGISTRY: Dict[str, type] = {}


def register_dataset(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_dataset(name: str, root: str, split: str = "train",
                **kwargs) -> FlowDataset:
    """The registered dataset ``name`` (the JAX package's factory)."""
    # The synthetic dataset registers itself when its module is imported.
    import pwcnet_tpu_torch.data.synthetic  # noqa: F401
    if name in FILE_DATASETS:
        raise NotImplementedError(f"dataset {name!r} reads dataset files; "
                                  "the file datasets are not ported yet "
                                  "(ROADMAP A1)")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; have {sorted(_REGISTRY)}") from None
    return cls(root=root, split=split, **kwargs)


def available_datasets() -> List[str]:
    import pwcnet_tpu_torch.data.synthetic  # noqa: F401
    return sorted(_REGISTRY)
