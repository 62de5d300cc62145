"""Wrapper of GMA's global attention CUDA kernels (K11,
``csrc/global_attention.cu``) and their autograd Functions.

A port-only kernel: the JAX package has no attention. The plain versions
are ``pwcnet_tpu_torch.ops.global_attention.attention_map_ref`` and
``aggregate_ref``; each Function's backward is autograd of its plain
version. A forward is one ``map`` launch a pair and one ``aggregate``
launch an iteration, on the current stream; ``aggregate_split`` counts the
bf16 aggregations whose row blocks were too few to fill the card, so that
a cluster of blocks split each row block's keys.
"""

from __future__ import annotations

import ctypes

import torch

from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.ops.kernels.build import load_library
from pwcnet_tpu_torch.ops.kernels.cost_volume_kernel import autograd_of

SOURCE = "pwcnet_tpu_torch/csrc/global_attention.cu"
DIM = 128   # the kernels' head width and value channels (GMA's)

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = trace.counters("launches.global_attention",
                          ("map", "aggregate", "aggregate_split"))

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = load_library("global_attention")
    lib.pwc_attention_map.argtypes = [_P] * 3 + [_I] * 3 + [_L] * 6 + [_I,
                                                                      _P]
    lib.pwc_attention_map.restype = _I
    lib.pwc_attention_aggregate.argtypes = ([_P] * 5 + [_I] * 3 + [_L] * 8
                                            + [_I, _P])
    lib.pwc_attention_aggregate.restype = _I
    lib.pwc_attention_aggregate_cluster.argtypes = [_I] * 3
    lib.pwc_attention_aggregate_cluster.restype = _I
    return lib


def _rows(name: str, t: torch.Tensor, n: int, p: int, width: int,
          dtype: torch.dtype) -> torch.Tensor:
    """``t`` as the kernels read it: (n, p, width) of ``dtype`` with unit
    column stride and, in bf16, row and image strides of whole 16-byte
    chunks from a 16-byte aligned start; where it is not so, a copy whose
    rows are padded to a pitch of 8 (a view of ``width`` columns)."""
    if tuple(t.shape) != (n, p, width):
        raise ValueError(f"{name} {tuple(t.shape)}: {(n, p, width)} "
                         "expected")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    ok = t.stride(2) == 1 and t.stride(1) >= width
    if dtype == torch.bfloat16:
        ok = (ok and t.stride(1) % 8 == 0 and t.stride(0) % 8 == 0
              and t.data_ptr() % 16 == 0)
    if ok:
        return t
    buf = torch.empty((n, p, -(-width // 8) * 8), dtype=dtype,
                      device=t.device)
    buf[..., :width] = t
    return buf[..., :width]


def _check_devices(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    if not (dev.type == "cuda" and all(t.device == dev for t in ts)):
        raise ValueError(f"K11 takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if ts[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"f32 or bf16 expected, got {ts[0].dtype}")


def attention_map_cuda(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """K11's map: (N, P, 128) queries and keys on one CUDA device -> the
    (N, P, P) map ``softmax_j(q_i . k_j / sqrt(128))`` in their dtype,
    with rows of a pitch rounded up to 8 (a view of P columns). No
    autograd: ``attention_map_fn`` is the differentiable entry."""
    _check_devices(q, k)
    n, p = q.shape[:2]
    q = _rows("q", q, n, p, DIM, q.dtype)
    k = _rows("k", k, n, p, DIM, q.dtype)
    pitch = -(-p // 8) * 8
    out = torch.empty((n, p, pitch), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().pwc_attention_map(
            q.data_ptr(), k.data_ptr(), out.data_ptr(), n, p, DIM,
            q.stride(1), k.stride(1), pitch, q.stride(0), k.stride(0),
            p * pitch, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"global attention map launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["map"] += 1
    return out[..., :p]


def aggregate_cuda(attn: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                   gamma: torch.Tensor) -> torch.Tensor:
    """K11's aggregation: the (N, P, P) map, (N, P, 128) values and motion
    features, a (1,) f32 ``gamma``, all on one CUDA device -> (N, P, 128)
    ``m + gamma * attn @ v`` in ``m``'s dtype. No autograd:
    ``aggregate_fn`` is the differentiable entry."""
    _check_devices(attn, v, m, gamma)
    n, p = m.shape[:2]
    dtype = m.dtype
    attn = _rows("attn", attn, n, p, p, dtype)
    v = _rows("v", v, n, p, DIM, dtype)
    m = _rows("m", m, n, p, DIM, dtype)
    gamma = gamma.detach().float().reshape(1).contiguous()
    out = torch.empty((n, p, DIM), dtype=dtype, device=m.device)
    bf16 = int(dtype == torch.bfloat16)
    lib = _lib()
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pwc_attention_aggregate(
            attn.data_ptr(), v.data_ptr(), m.data_ptr(), gamma.data_ptr(),
            out.data_ptr(), n, p, DIM, attn.stride(1), v.stride(1),
            m.stride(1), DIM, attn.stride(0), v.stride(0), m.stride(0),
            p * DIM, bf16, stream)
        split = lib.pwc_attention_aggregate_cluster(n, p, bf16) > 1
    if err:
        raise RuntimeError(f"global attention aggregate launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["aggregate"] += 1
    LAUNCHES["aggregate_split"] += split
    return out


class AttentionMapFunction(torch.autograd.Function):
    """K11's map forward; backward through autograd of
    ``attention_map_ref``."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return attention_map_cuda(q, k)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.global_attention import attention_map_ref
        return tuple(autograd_of(attention_map_ref, ctx.saved_tensors, g,
                                 ctx.needs_input_grad[:2]))


class AggregateFunction(torch.autograd.Function):
    """K11's aggregation forward; backward through autograd of
    ``aggregate_ref``."""

    @staticmethod
    def forward(ctx, attn, v, m, gamma):
        ctx.save_for_backward(attn, v, m, gamma)
        return aggregate_cuda(attn, v, m, gamma)

    @staticmethod
    def backward(ctx, g):
        from pwcnet_tpu_torch.ops.global_attention import aggregate_ref
        return tuple(autograd_of(aggregate_ref, ctx.saved_tensors, g,
                                 ctx.needs_input_grad[:4]))


def attention_map_fn(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The differentiable map on CUDA tensors (K11)."""
    return AttentionMapFunction.apply(q, k)


def aggregate_fn(attn: torch.Tensor, v: torch.Tensor, m: torch.Tensor,
                 gamma: torch.Tensor) -> torch.Tensor:
    """The differentiable aggregation on CUDA tensors (K11)."""
    return AggregateFunction.apply(attn, v, m, gamma)
