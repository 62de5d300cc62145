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
- ``upsample2x_rows``: 2x bilinear upsampling, half-pixel or
  ``align_corners``, clamps at the global edges, so it too takes one real
  row on each side. Half-pixel output rows ``[2rt, 2rt + 2t)`` read input
  rows ``[rt - 1, rt + t]``, and so do align-corners ones, whose source
  rows ``i (H - 1) / (2H - 1)`` are computed in global rows.
- ``all_reduce_sum`` / ``all_gather_rows`` for the global statistics
  (input normalisation, GroupNorm) and the replicated flows.

Every op is differentiable, with the convention that the global loss is
the sum of the ranks' local losses (the one that makes JAX's ``psum`` its
own transpose): the exchange's backward is its transpose
(``halo.exchange_rows``), ``all_reduce_sum``'s is an all-reduce of the
gradient, ``all_gather_rows``'s a reduce-scatter (this rank's rows of the
gradient, summed over the ranks). The stem on a shard's real rows runs K4
forward and K5 backward on the extended block.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pwcnet_tpu_torch.ops.conv import _same_pads
from pwcnet_tpu_torch.ops.resize import RESIZE_MODES, resize_bilinear
from pwcnet_tpu_torch.parallel.halo import exchange_rows, to_comm
from pwcnet_tpu_torch.parallel.mesh import GridMesh

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
              dilation: int, mesh: GridMesh) -> torch.Tensor:
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
              mesh: GridMesh) -> torch.Tensor:
    """The fused stem on an NHWC image shard (t rows, t divisible by 4):
    (N, t, W, 3) -> (N, t/4, W/4, C2)."""
    t = im.shape[1]
    if t % 4:
        raise ValueError(f"a shard of {t} image rows does not split on the "
                         "level-2 grid")
    return stem_block(exchange_rows(im, *STEM_ROWS, mesh), stem, t,
                      mesh.rank, mesh.size)


def _align_corners_taps(n_in: int, n_out: int, lo: int, hi: int):
    """Output rows ``[lo, hi)`` of an align-corners resize from ``n_in`` to
    ``n_out`` rows: the source rows (i0, i1 = min(i0 + 1, n_in - 1)) and
    the weight of i1, as JAX's ``_interp_matrix`` takes them."""
    scale = np.float32((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    src = np.arange(lo, hi, dtype=np.float32) * scale
    i0 = np.clip(np.floor(src), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy(src - i0.astype(np.float32)))


def _lerp_rows(x: torch.Tensor, dim: int, i0, i1, w1) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = -1
    w1 = w1.to(x.device).view(shape)
    return (x.index_select(dim, i0.to(x.device)) * (1 - w1)
            + x.index_select(dim, i1.to(x.device)) * w1)


def upsample2x_block(ext: torch.Tensor, t: int, rank: int, size: int,
                     mode: str = "half_pixel") -> torch.Tensor:
    """2x bilinear upsample (``mode`` as ``ops.resize.resize_bilinear``) of
    one shard's rows from its exchanged rows ``ext`` (N, 1 + t + 1, W, C):
    (N, 2t, 2W, C), computed in f32 and returned in ext's dtype."""
    if mode not in RESIZE_MODES:
        raise ValueError(f"resize mode must be one of {RESIZE_MODES}, "
                         f"got {mode!r}")
    if mode == "half_pixel":
        block, above = real_rows(ext, 1, 1, t, rank, size)
        y = resize_bilinear(block, (2 * block.shape[1],
                                    2 * block.shape[2]), "half_pixel")
        return y[:, 2 * above:2 * above + 2 * t]
    # Global source rows of output rows [2rt, 2rt + 2t), clamped to the
    # image, then read from ext, whose row 0 is global row rt - 1.
    h, w = size * t, ext.shape[2]
    i0, i1, w1 = _align_corners_taps(h, 2 * h, 2 * rank * t,
                                     2 * (rank + 1) * t)
    base = rank * t - 1
    y = _lerp_rows(ext.float(), 1, i0 - base, i1 - base, w1)
    y = _lerp_rows(y, 2, *_align_corners_taps(w, 2 * w, 0, 2 * w))
    return y.to(ext.dtype)


def upsample2x_rows(x: torch.Tensor, mesh: GridMesh,
                    mode: str = "half_pixel") -> torch.Tensor:
    """2x bilinear upsample of an NHWC shard: (N, t, W, C) -> (N, 2t, 2W,
    C), equal to the rows of the unsharded ``resize_bilinear(x, (2H, 2W),
    mode)``."""
    return upsample2x_block(exchange_rows(x, 1, 1, mesh), x.shape[1],
                            mesh.rank, mesh.size, mode)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    buf = to_comm(x, mesh).clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``mesh`` (a new tensor on x's
    device). Its gradient is the sum of the ranks' gradients."""
    if mesh.size == 1:
        return x.clone()
    return _AllReduceSum.apply(x, mesh)


class _AllGatherRows(torch.autograd.Function):
    """The shards concatenated along rows; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        buf = to_comm(x, mesh)
        parts: List[torch.Tensor] = [torch.empty_like(buf)
                                     for _ in range(mesh.size)]
        dist.all_gather(parts, buf, group=mesh.group)
        return torch.cat(parts, 1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        # gloo has no reduce-scatter: all-reduce, then this rank's rows.
        mesh = ctx.mesh
        t = g.shape[1] // mesh.size
        return _all_reduce(g, mesh)[:, mesh.rank * t:(mesh.rank + 1) * t], \
            None


def all_gather_rows(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The (N, t, ...) shards of every rank, concatenated along rows. Its
    gradient is this rank's rows of the ranks' gradients, summed."""
    if mesh.size == 1:
        return x
    return _AllGatherRows.apply(x, mesh)


def input_norm_rows(im: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """Per-image standardisation over (H, W, C) of the whole image, from an
    f32 NHWC shard: the global mean and std (ddof 0, two passes) + 1e-6."""
    count = im[0].numel() * mesh.size
    m = all_reduce_sum(im.sum((1, 2, 3), keepdim=True), mesh) / count
    var = all_reduce_sum(((im - m) ** 2).sum((1, 2, 3), keepdim=True),
                         mesh) / count
    return (im - m) / (var.sqrt() + 1e-6)
