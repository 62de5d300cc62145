"""GMFlow's single-head attention within the windows of a grid (Xu et al.,
CVPR 2022, arXiv:2111.13680; the released ``gmflow/transformer.py``,
``single_head_split_window_attention`` and ``single_head_full_attention``),
port-only: the JAX package has no attention.

The (H, W) grid of each image is split into S x S windows of (H / S) x
(W / S) tokens, windows in row-major order, tokens row-major in a window.
For a query p and the keys j of its window:

    out[b, p] = sum_j softmax_j(q[b, p] . k[b', j] / sqrt(C) + m(p, j))
                v[b', j],    b' = (b + kv_offset) mod B_k

``shifted``: the windows are those of the grid rolled by (-(H/S)//2,
-(W/S)//2), as the released code rolls before it splits and rolls back
after it merges, and m(p, j) = -100 where p and j lie in different regions
of the rolled frame (Swin's mask: each of the last window row and column
splits in two), else 0. S = 1 is the global attention over all H W
tokens (GMFlow's global matching and global propagation). ``kv_offset``
lets GMFlow's cross-attention of concat(f0, f1) to concat(f1, f0) read one
tensor.

q and k have 128 channels (C); v has 128 (the transformer) or 2 (the
coordinates of the matching, the flow of the propagation). Precision: the
scores summed in f32, softmax in f32, the probabilities rounded to v's
dtype (bf16 for the transformer's bf16 values; f32 for the 2-wide f32
ones), the sums in f32 and the output rounded once to v's dtype. CUDA
tensors take K12 (``csrc/window_attention.cu``: one launch a call,
differentiable through autograd of the plain version); CPU tensors take the
plain version, which gathers each window's tokens by the same index
arithmetic as the kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from pwcnet_tpu_torch.ops.kernels.window_attention_kernel import (
    check_windows, window_attention_fn)

MASK = -100.0   # Swin's score between two regions

# K12 against the plain version, as max|got - want| over max|v|. In bf16
# at width 128 both round each probability to bf16 (the kernel its
# unnormalised exp, the plain version its normalised value: each weighs v
# to within 2**-9 of sum_j p_j |v_j| <= max|v|) and their output once
# (2**-9 of it, at most max|v|), so the two lie within 4 x 2**-9 = 2**-7
# of max|v|. At width 2 and in f32 only the f32 sums' order differs.
BF16_TOL = 2.0 ** -7
F32_TOL = 1e-5


@functools.lru_cache(maxsize=32)
def _windows(h: int, w: int, splits: int, shifted: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S * S, L) pixel index (y W + x) of every window's tokens, and
    their (S * S, L) regions in the rolled frame (0 unless shifted): the
    released labels, 3 * (row slice) + (column slice)."""
    check_windows(h, w, splits, shifted)
    wh, ww = h // splits, w // splits
    sh, sw = (wh // 2, ww // 2) if shifted else (0, 0)
    ry = torch.arange(h).view(splits, wh)        # rolled rows by window
    rx = torch.arange(w).view(splits, ww)
    oy, ox = (ry + sh) % h, (rx + sw) % w          # their unrolled pixels
    idx = oy[:, None, :, None] * w + ox[None, :, None, :]
    hl = (ry >= h - wh).long() + (ry >= h - sh).long() if shifted else \
        torch.zeros_like(ry)
    wl = (rx >= w - ww).long() + (rx >= w - sw).long() if shifted else \
        torch.zeros_like(rx)
    lab = 3 * hl[:, None, :, None] + wl[None, :, None, :]
    n = splits * splits
    return idx.reshape(n, wh * ww), lab.reshape(n, wh * ww)


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         splits: int, shifted: bool = False,
                         kv_offset: int = 0) -> torch.Tensor:
    """Plain version: (Bq, H, W, C) queries, (Bk, H, W, C) keys, (Bk, H, W,
    Vw) values -> (Bq, H, W, Vw) in v's dtype (module docstring)."""
    bq, h, w, c = q.shape
    bk, vw = k.shape[0], v.shape[-1]
    idx, lab = (t.to(q.device) for t in _windows(h, w, splits, shifted))
    kv = (torch.arange(bq, device=q.device) + kv_offset) % bk
    qw = q.reshape(bq, h * w, c)[:, idx].float()         # (Bq, S^2, L, C)
    kw = k.reshape(bk, h * w, c)[kv][:, idx].float()
    vw_ = v.reshape(bk, h * w, vw)[kv][:, idx].float()
    s = torch.matmul(qw, kw.transpose(-1, -2)) / c ** 0.5
    if shifted:
        s = s + torch.where(lab[:, :, None] != lab[:, None, :], MASK, 0.0)
    p = torch.softmax(s, -1).to(v.dtype).float()
    o = torch.matmul(p, vw_).to(v.dtype)
    out = torch.empty((bq, h * w, vw), dtype=v.dtype, device=q.device)
    out[:, idx] = o
    return out.view(bq, h, w, vw)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     splits: int, shifted: bool = False,
                     kv_offset: int = 0) -> torch.Tensor:
    """The plain version on CPU tensors, K12 on CUDA tensors."""
    if q.device.type == "cpu":
        return window_attention_ref(q, k, v, splits, shifted, kv_offset)
    return window_attention_fn(q, k, v, splits, shifted, kv_offset)
