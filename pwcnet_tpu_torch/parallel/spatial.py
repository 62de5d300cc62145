"""Spatial (image-H) sharded inference (counterpart of
``pwcnet_tpu/parallel/spatial.py``).

Every rank of a :class:`~pwcnet_tpu_torch.parallel.mesh.SpatialMesh` holds
the same weights and takes its rows of the global image pair; the forward
runs shard-locally with row exchanges across shard edges (``halo.py``,
``spatial_ops.py``), and the per-level flows are gathered, so every rank
returns them replicated, as JAX returns them. Uses: inputs whose
activations do not fit one card, and the latency of one large pair.

Halo contract (as in the JAX package): per level, the warp's vertical
reach across a shard edge is bounded by ``model.spatial_halo`` rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pwcnet_tpu_torch.parallel.mesh import SpatialMesh
from pwcnet_tpu_torch.parallel.spatial_ops import all_gather_rows


def required_divisor(model, mesh: SpatialMesh) -> int:
    """H must be divisible by (2**num_levels) * spatial_size so every
    pyramid level splits evenly across the spatial shards."""
    return (2 ** model.num_levels) * mesh.size


def shard_rows(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """This rank's rows of a global (N, H, ...) tensor."""
    t = x.shape[1] // mesh.size
    return x[:, mesh.rank * t:(mesh.rank + 1) * t]


def spatial_forward(model, mesh: SpatialMesh, im1, im2
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run ``model`` (a port ``PWCNet``) with H sharded over ``mesh``.

    ``im1``/``im2``: the global (N, H, W, 3) images (tensors or arrays),
    the same on every rank, H divisible by :func:`required_divisor`. Every
    rank of the mesh must call this. Returns (per-level flows, full-res
    pixel flow), both replicated on every rank, on the mesh's device."""
    h = im1.shape[1]
    div = required_divisor(model, mesh)
    if h % div:
        raise ValueError(
            f"H={h} must be divisible by {div} for spatial sharding "
            f"(2**num_levels * spatial shards); pad the images")
    a = shard_rows(torch.as_tensor(im1), mesh)
    b = shard_rows(torch.as_tensor(im2), mesh)
    flows = model(a.to(mesh.device), b.to(mesh.device), mesh=mesh)
    flows = [all_gather_rows(f, mesh) for f in flows]
    full = model.full_res_flow(flows, tuple(im1.shape[1:3]))
    return flows, full


def pad_for_spatial(img: np.ndarray, model, mesh: SpatialMesh
                    ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Zero-pad H (bottom) and W (right, to /2**num_levels) for
    :func:`spatial_forward`; returns padded array + original (H, W)."""
    div_h = required_divisor(model, mesh)
    div_w = 2 ** model.num_levels
    h, w = img.shape[-3:-1]
    ph = -(-h // div_h) * div_h
    pw = -(-w // div_w) * div_w
    if (ph, pw) == (h, w):
        return img, (h, w)
    pad = [(0, 0)] * (img.ndim - 3) + [(0, ph - h), (0, pw - w), (0, 0)]
    return np.pad(img, pad), (h, w)
