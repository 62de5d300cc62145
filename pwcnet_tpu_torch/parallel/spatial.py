"""Spatial (image-H) sharded forward (counterpart of
``pwcnet_tpu/parallel/spatial.py``).

Every rank of a mesh's spatial axis holds the same weights and takes its
rows of the global image pair; the forward runs shard-locally with row
exchanges across shard edges (``halo.py``, ``spatial_ops.py``), and the
per-level flows are gathered, so every rank returns them replicated, as JAX
returns them. On a (data, spatial, model) grid each data row (and model
replica) runs its own sharded forward on its spatial group, with the images
replicated over ``data``, as JAX's ``P(None, SPATIAL_AXIS)`` places them.
The forward is differentiable: under ``torch.enable_grad()`` the flows
carry gradients back to this rank's image rows and to the replicated
parameters, the global loss being the sum of the ranks' losses. Uses:
inputs whose activations do not fit one card, and the latency of one large
pair.

Halo contract (as in the JAX package): per level, the warp's vertical
reach across a shard edge is bounded by ``model.spatial_halo`` rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pwcnet_tpu_torch.parallel.mesh import GridMesh
from pwcnet_tpu_torch.parallel.spatial_ops import all_gather_rows


def required_divisor(model, mesh: GridMesh) -> int:
    """H must be divisible by (2**num_levels) * spatial_size so every
    pyramid level splits evenly across the spatial shards."""
    return (2 ** model.num_levels) * mesh.spatial_mesh.size


def shard_rows(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """This rank's rows (by its spatial index) of a global (N, H, ...)
    tensor."""
    sm = mesh.spatial_mesh
    t = x.shape[1] // sm.size
    return x[:, sm.rank * t:(sm.rank + 1) * t]


def spatial_forward(model, mesh: GridMesh, im1, im2
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run ``model`` (a port ``PWCNet``) with H sharded over the spatial
    axis of ``mesh`` (a grid; one along the spatial axis alone shards
    over all of it).

    ``im1``/``im2``: the global (N, H, W, 3) images (tensors or arrays),
    the same on every rank of the spatial axis, H divisible by
    :func:`required_divisor`. Every rank of the axis must call this.
    Returns (per-level flows, full-res pixel flow), both replicated on
    every rank, on the mesh's device."""
    sm = mesh.spatial_mesh
    h = im1.shape[1]
    div = required_divisor(model, mesh)
    if h % div:
        raise ValueError(
            f"H={h} must be divisible by {div} for spatial sharding "
            f"(2**num_levels * spatial shards); pad the images")
    a = shard_rows(torch.as_tensor(im1), sm)
    b = shard_rows(torch.as_tensor(im2), sm)
    flows = model(a.to(sm.device), b.to(sm.device), mesh=sm)
    flows = [all_gather_rows(f, sm) for f in flows]
    full = model.full_res_flow(flows, tuple(im1.shape[1:3]))
    return flows, full


def pad_for_spatial(img: np.ndarray, model, mesh: GridMesh
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


def predict_flow_spatial(model, mesh: GridMesh, im1: np.ndarray,
                         im2: np.ndarray) -> np.ndarray:
    """``predict_flow`` with the pair's rows sharded over the spatial axis
    of ``mesh``: (H, W, 3) images in [0, 1] -> (H, W, 2) f32 pixel flow at
    input resolution, the same on every rank. Every rank of the axis must
    call this, with the same images."""
    if not hasattr(model, "num_levels"):
        raise ValueError("the spatial path runs PWC-Net only")
    p1, (h, w) = pad_for_spatial(np.asarray(im1, np.float32)[None], model,
                                 mesh)
    p2, _ = pad_for_spatial(np.asarray(im2, np.float32)[None], model, mesh)
    with torch.inference_mode():
        _, full = spatial_forward(model, mesh, torch.tensor(p1),
                                  torch.tensor(p2))
    return full[0, :h, :w].float().cpu().numpy()
