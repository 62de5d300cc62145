"""GMA's global motion aggregation (Jiang et al., ICCV 2021,
arXiv:2104.02409; the released ``core/gma.py``), content-only with one head
(port-only; the JAX package has no attention).

    A[n, i, j] = softmax_j(sum_c q[n, i, c] k[n, j, c] / sqrt(D))
    g[n, i, c] = m[n, i, c] + gamma * sum_j A[n, i, j] v[n, j, c]

over the P pixels of the 1/8 grid: the map ``A`` once a pair from the
context features' queries and keys, the aggregation in every iteration
from the motion features ``m`` and their values ``v``. The products are
summed in f32 and the softmax is f32; the map is stored in the inputs'
dtype (bf16: 2 P^2 bytes, 2.13 GB at a 136x240 grid) and ``g`` is rounded
once to ``m``'s dtype. CUDA tensors take K11 (``csrc/global_attention.cu``:
one launch for the map, one for each aggregation), differentiable through
autograd of the plain versions; CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch

from pwcnet_tpu_torch.ops.kernels.global_attention_kernel import (
    aggregate_fn, attention_map_fn)


def attention_map_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, P, D) queries and keys -> the (N, P, P) map in
    their dtype, a matmul and a softmax in f32."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) \
        * q.shape[-1] ** -0.5
    return torch.softmax(s, -1).to(q.dtype)


def aggregate_ref(attn: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """Plain version: the (N, P, P) map, (N, P, C) values and motion
    features, gamma (1,) -> (N, P, C) ``m + gamma * attn @ v``, summed in
    f32 and rounded once to ``m``'s dtype."""
    out = torch.matmul(attn.float(), v.float())
    return (m.float() + gamma.float() * out).to(m.dtype)


# K11's bf16 results against the plain versions': every value within one
# step (``bf16_steps_off``; an aggregation's values under 2**-8 of its
# largest held at the step of that floor, where the f32 sums' order moves
# them by ~1e-7 of the largest); a map's rows sum to 1 within 2**-9 (half
# a step of a value near 1; the independent roundings of a row's values
# cancel to ~1e-4, while a bias of a fraction of a step in every value, as
# truncation gives, reads 3e-3 to 4e-3); and K11's map through the plain
# aggregation in f32 within two bf16 steps of its largest value of the
# reference map's (one-step flips of 0.15% of the values read 1e-3 to
# 2.7e-3 of it, truncation 5e-3 to 6e-3).
BF16_STEPS = 1.0
AGGREGATE_FLOOR = 2.0 ** -8
ROW_SUM_TOL = 2.0 ** -9
VIA_MAP_TOL = 2.0 ** -7


def bf16_steps_off(got: torch.Tensor, want: torch.Tensor,
                   floor: float = 0.0, rows: int = 2048) -> float:
    """How far K11's bf16 values lie from the plain versions', at most, in
    bf16 steps: each gap over the step of the larger of its two values
    (of ``floor`` where both are smaller). K11 and the plain versions round
    f32 values that differ by f32 rounding alone, so a value may land one
    step away and no further. Over the last axis in blocks of ``rows``
    rows (an f32 copy of a 32400-pixel map takes 4.2 GB)."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    worst = 0.0
    for i in range(0, want.shape[0], rows):
        a, b = got[i:i + rows].float(), want[i:i + rows].float()
        big = torch.maximum(a.abs(), b.abs()).clamp_min(
            max(floor, 2.0 ** -126))
        _, e = torch.frexp(big)
        step = torch.ldexp(torch.ones_like(big), e - 8)
        worst = max(worst, float(((a - b).abs() / step).max()))
    return worst


def row_sum_err(attn: torch.Tensor, rows: int = 2048) -> float:
    """The largest |sum_j A[n, i, j] - 1| of a map's rows, summed in f64
    over blocks of ``rows`` rows."""
    a = attn.reshape(-1, attn.shape[-1])
    return max(float((a[i:i + rows].double().sum(-1) - 1).abs().max())
               for i in range(0, a.shape[0], rows))


def attention_map(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version on CPU tensors, K11 on CUDA tensors."""
    if q.device.type == "cpu":
        return attention_map_ref(q, k)
    return attention_map_fn(q, k)


def aggregate(attn: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
              gamma: torch.Tensor) -> torch.Tensor:
    """The plain version on CPU tensors, K11 on CUDA tensors."""
    if m.device.type == "cpu":
        return aggregate_ref(attn, v, m, gamma)
    return aggregate_fn(attn, v, m, gamma)
