"""The model's ops on H-sharded activations, outside the correlation.

In the JAX package GSPMD partitions everything outside the halo islands
(``pwcnet_tpu/parallel/spatial.py``). Here each op exchanges the rows it
reads across shard edges itself. The rule: a zero halo row at a global edge
equals SAME zero padding for one conv, and for nothing else.

- ``conv_rows``: one conv exchanges the rows its SAME padding would add
  (``(d, d)`` for a 3x3 conv of dilation d, ``(0, 1)`` for stride 2 on an
  even height) and runs unpadded in H, SAME-padded in W.
- ``stem_rows``: the fused stem (K4) runs four convs, and a zero row past the
  global edge would pass through bias and LeakyReLU. So it takes real
  neighbour rows only, ``STEM_ROWS`` above and below, none past a global
  edge (there the kernel's own SAME padding is the global one), and crops.
- ``upsample2x_rows``: half-pixel 2x upsampling clamps at the global edges,
  so it too takes one real row on each side and crops.
- ``all_reduce_sum`` / ``all_gather_rows`` for the global input
  normalisation and the replicated flows.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.conv import _same_pads
from pwcnet_tpu_torch.ops.resize import resize_bilinear
from pwcnet_tpu_torch.parallel.halo import exchange_rows, to_comm
from pwcnet_tpu_torch.parallel.mesh import SpatialMesh

# Image rows the stem takes above and below a shard. Level-2 row j (image
# rows 4j..4j+3) depends on image rows 4j-6 .. 4j+12: conv4 reads level-2
# rows j-1..j+1, conv3 (stride 2, pads 0 above and 1 below) level-1 rows
# 2j-2..2j+4, conv2 level-1 rows 2j-3..2j+5, conv1 (stride 2) image rows
# 4j-6..4j+12. So 6 rows above and 9 below; the counts are rounded up to
# multiples of 4, so that the extended block starts on the level-2 grid and
# keeps an even height (the stride-2 pads stay (0, 1)).
STEM_RECEPTIVE = (6, 9)
STEM_ROWS = (8, 12)


def conv_rows(x: torch.Tensor, w: torch.Tensor, b, stride: int,
              dilation: int, mesh: SpatialMesh) -> torch.Tensor:
    """``conv_same`` on an NCHW shard of the H-sharded activation."""
    kh, kw = w.shape[-2:]
    top, bottom = _same_pads(x.shape[-2] * mesh.size, kh, stride, dilation)
    xe = exchange_rows(x, top, bottom, mesh, dim=2)
    if x.is_contiguous(memory_format=torch.channels_last):
        xe = xe.contiguous(memory_format=torch.channels_last)
    left, right = _same_pads(x.shape[-1], kw, stride, dilation)
    wt, bt = w.to(x.dtype), None if b is None else b.to(x.dtype)
    if left == right:
        return F.conv2d(xe, wt, bt, stride=stride, padding=(0, left),
                        dilation=dilation)
    return F.conv2d(F.pad(xe, (left, right)), wt, bt, stride=stride,
                    dilation=dilation)


def real_rows(ext: torch.Tensor, above: int, below: int, t: int,
              rank: int, size: int):
    """The rows of an exchanged block ``ext`` (``above`` + t + ``below``
    rows along dim 1, from ``exchange_rows``) that lie inside the image of
    ``size`` shards of t rows: the block and the rows it kept above."""
    keep_above = min(above, rank * t)
    keep_below = min(below, (size - rank - 1) * t)
    return ext[:, above - keep_above:above + t + keep_below], keep_above


def stem_block(ext: torch.Tensor, stem: Callable[[torch.Tensor],
                                                 torch.Tensor],
               t: int, rank: int, size: int) -> torch.Tensor:
    """The stem's rows of one shard from its exchanged image rows ``ext``
    (N, STEM_ROWS[0] + t + STEM_ROWS[1], W, 3): the stem on the real rows,
    cropped to the shard's t/4 level-2 rows."""
    block, above = real_rows(ext, *STEM_ROWS, t, rank, size)
    return stem(block.contiguous())[:, above // 4:above // 4 + t // 4]


def stem_rows(im: torch.Tensor, stem: Callable[[torch.Tensor], torch.Tensor],
              mesh: SpatialMesh) -> torch.Tensor:
    """The fused stem on an NHWC image shard (t rows, t divisible by 4):
    (N, t, W, 3) -> (N, t/4, W/4, C2)."""
    t = im.shape[1]
    if t % 4:
        raise ValueError(f"a shard of {t} image rows does not split on the "
                         "level-2 grid")
    return stem_block(exchange_rows(im, *STEM_ROWS, mesh), stem, t,
                      mesh.rank, mesh.size)


def upsample2x_block(ext: torch.Tensor, t: int, rank: int,
                     size: int) -> torch.Tensor:
    """Half-pixel 2x upsample of one shard's rows from its exchanged rows
    ``ext`` (N, 1 + t + 1, W, C): (N, 2t, 2W, C)."""
    block, above = real_rows(ext, 1, 1, t, rank, size)
    y = resize_bilinear(block, (2 * block.shape[1], 2 * block.shape[2]),
                        "half_pixel")
    return y[:, 2 * above:2 * above + 2 * t]


def upsample2x_rows(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """Half-pixel 2x bilinear upsample of an NHWC shard: (N, t, W, C) ->
    (N, 2t, 2W, C), equal to the rows of the unsharded upsample."""
    return upsample2x_block(exchange_rows(x, 1, 1, mesh), x.shape[1],
                            mesh.rank, mesh.size)


def all_reduce_sum(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The sum of ``x`` over the shards (a new tensor on x's device)."""
    if mesh.size == 1:
        return x.clone()
    buf = to_comm(x, mesh).clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """The (N, t, ...) shards of every rank, concatenated along rows."""
    if mesh.size == 1:
        return x
    buf = to_comm(x, mesh)
    parts: List[torch.Tensor] = [torch.empty_like(buf)
                                 for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts, 1).to(x.device)


def input_norm_rows(im: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """Per-image standardisation over (H, W, C) of the whole image, from an
    f32 NHWC shard: the global mean and std (ddof 0, two passes) + 1e-6."""
    count = im[0].numel() * mesh.size
    m = all_reduce_sum(im.sum((1, 2, 3), keepdim=True), mesh) / count
    var = all_reduce_sum(((im - m) ** 2).sum((1, 2, 3), keepdim=True),
                         mesh) / count
    return (im - m) / (var.sqrt() + 1e-6)
