"""The port's small-channel folded conv (K7's entry) held against the JAX
package's ``conv2d_folded`` (interpret mode on the CPU), and the CUDA
kernels of the spatial path and of K7 against their plain versions
(``cuda``-marked: they skip without a CUDA device).

On the CPU ``conv2d_folded`` is the plain ``conv_ref``; gradients are
autograd's on both sides. Tolerances as ``tests/test_conv_kernel.py``
states them for the JAX kernel: 2e-4 (forward), 2e-3 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.pallas.conv_kernel import conv2d_folded as jax_folded
from pwcnet_tpu.ops.pallas.conv_kernel import conv_ref as jax_conv_ref
from pwcnet_tpu.ops.pallas.conv_kernel import fold_w as jax_fold_w
from pwcnet_tpu.ops.pallas.conv_kernel import pick_g as jax_pick_g
from pwcnet_tpu_torch.ops.conv_folded import (conv2d_folded, conv_ref,
                                              fold_w, pick_g, unfold_w)
from pwcnet_tpu_torch.ops.cost_volume import (cost_volume_prepadded,
                                              cost_volume_prepadded_ref)
from pwcnet_tpu_torch.ops.kernels import (conv_folded_kernel,
                                          cost_volume_kernel,
                                          warp_corr_kernel)
from pwcnet_tpu_torch.ops.warp_corr import warp_corr_prepadded_ref

from torch_port_util import need_cuda, to_torch


def _w(rng, *shape):
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("stride,ci,co,hw", [
    (2, 3, 16, (32, 64)),
    (1, 16, 16, (16, 64)),
    (2, 16, 32, (32, 128)),
    (1, 32, 32, (16, 64)),
    # 9 * Ci * Co above the 12288 weights K7 once staged at a time
    (1, 64, 64, (16, 64)),
    (2, 96, 64, (16, 32)),
])
def test_conv2d_folded_matches_jax(stride, ci, co, hw, slope):
    rng = np.random.default_rng(0)
    x = rng.random((2, *hw, ci), np.float32)
    w, b = _w(rng, 3, 3, ci, co), _w(rng, co)
    want = np.asarray(jax_folded(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), stride=stride, slope=slope,
                                 interpret=True))
    got = conv2d_folded(to_torch(x), to_torch(w), to_torch(b), stride=stride,
                        slope=slope)
    assert tuple(got.shape) == want.shape  # the same fold G
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_conv2d_folded_in_g_chain_and_grads_match_jax():
    """A stride-2 conv, then a conv on its folded output (in_g > 1), as in
    tests/test_conv_kernel.py: outputs and weight gradients."""
    rng = np.random.default_rng(1)
    x = rng.random((1, 32, 64, 3), np.float32)
    w1, b1 = _w(rng, 3, 3, 3, 16), _w(rng, 16)
    w2, b2 = _w(rng, 3, 3, 16, 16), _w(rng, 16)
    g1 = pick_g(32, 16)
    assert g1 == jax_pick_g(32, 16) > 1

    def jax_loss(ws):
        y = jax_folded(jnp.asarray(x), ws[0], jnp.asarray(b1), stride=2,
                       slope=0.1, interpret=True)
        y = jax_folded(y, ws[1], jnp.asarray(b2), slope=0.1, in_g=g1,
                       interpret=True)
        return jnp.sum(y ** 2), y

    (_, want_y), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(w1), jnp.asarray(w2)))
    tw1, tw2 = to_torch(w1).requires_grad_(), to_torch(w2).requires_grad_()
    y = conv2d_folded(to_torch(x), tw1, to_torch(b1), stride=2, slope=0.1)
    y = conv2d_folded(y, tw2, to_torch(b2), slope=0.1, in_g=g1)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-4, atol=2e-4)
    for got, want in zip((tw1.grad, tw2.grad), want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("w_out,co", [(32, 16), (64, 32), (512, 16),
                                      (24, 16), (256, 3)])
def test_fold_layout_matches_jax(w_out, co):
    assert pick_g(w_out, co) == jax_pick_g(w_out, co)
    rng = np.random.default_rng(2)
    x = rng.random((1, 4, w_out, co), np.float32)
    g = pick_g(w_out, co)
    np.testing.assert_array_equal(fold_w(to_torch(x), g).numpy(),
                                  np.asarray(jax_fold_w(jnp.asarray(x), g)))
    assert torch.equal(unfold_w(fold_w(to_torch(x), g), g), to_torch(x))


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv_ref_matches_jax(dilation):
    rng = np.random.default_rng(3)
    x = rng.random((2, 9, 14, 5), np.float32)
    w, b = _w(rng, 3, 3, 5, 7), _w(rng, 7)
    want = np.asarray(jax_conv_ref(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), dilation=dilation,
                                   slope=0.1))
    got = conv_ref(to_torch(x), to_torch(w), to_torch(b), dilation=dilation,
                   slope=0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    f = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_kernel.cost_volume_prepadded_cuda(f, torch.zeros(
            1, 12, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr_kernel.warp_corr_prepadded_cuda(
            f, torch.zeros(1, 12, 8, 8), torch.zeros(1, 12, 8, 2), 0, 4, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        conv_folded_kernel.conv_folded_cuda(f, torch.zeros(3, 3, 8, 4),
                                            torch.zeros(4))


def test_prepadded_dispatch_is_plain_on_cpu_and_differentiates():
    rng = np.random.default_rng(4)
    f1 = to_torch(rng.standard_normal((1, 4, 6, 5)).astype(np.float32))
    f2e = to_torch(rng.standard_normal((1, 8, 6, 5)).astype(np.float32))
    before = dict(cost_volume_kernel.LAUNCHES)
    a = f1.clone().requires_grad_()
    out = cost_volume_prepadded(a, f2e, max_displacement=2)
    assert torch.equal(out, cost_volume_prepadded_ref(f1, f2e, 2))
    out.sum().backward()
    assert a.grad is not None and cost_volume_kernel.LAUNCHES == before


# -- the kernels on the card -------------------------------------------------

TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (1, 4, 16, 196),
                                   (2, 32, 128, 64)])
def test_cost_volume_prepadded_kernel_matches_plain(shape, dtype):
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    n, t, w, c = shape
    f1 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    f2e = torch.randn((n, t + 8, w, c), device="cuda", generator=g).to(dtype)
    with torch.no_grad():
        got = cost_volume_kernel.cost_volume_prepadded_cuda(f1, f2e).float()
        want = cost_volume_prepadded_ref(f1, f2e).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= TOL[dtype] * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 16.0])  # 16 px: past the halo
@pytest.mark.parametrize("shape,row0,h", [((1, 8, 32, 128), 8, 32),
                                          ((2, 5, 13, 7), 0, 10),
                                          ((1, 64, 256, 32), 64, 128)])
def test_warp_corr_prepadded_kernel_matches_plain(shape, row0, h, scale,
                                                  dtype):
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    n, t, w, c = shape
    d, halo = 4, max(min(16, t), 4)
    f1 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    f2e = torch.randn((n, t + 2 * halo, w, c), device="cuda",
                      generator=g).to(dtype)
    flow = scale * torch.randn((n, t + 2 * d, w, 2), device="cuda",
                               generator=g)
    with torch.no_grad():
        got = warp_corr_kernel.warp_corr_prepadded_cuda(
            f1, f2e, flow, row0, h, halo, d).float()
        want = warp_corr_prepadded_ref(f1, f2e, flow, row0, h, halo,
                                       d).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= TOL[dtype] * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("slope", [None, 0.1])
@pytest.mark.parametrize("n,stride,ci,co,hw", [
    (2, 2, 3, 16, (32, 64)), (2, 1, 16, 16, (16, 64)),
    (2, 2, 16, 32, (30, 70)),
    # ragged against the tiles (64 columns, 8 or 4 rows), N = 1 and 16
    (1, 2, 3, 16, (37, 70)), (16, 1, 16, 16, (9, 67)),
    (1, 2, 16, 32, (13, 100)), (16, 1, 32, 32, (11, 75)),
    (2, 1, 5, 7, (6, 20)), (1, 2, 8, 40, (9, 21)),
    # the most channels the bf16 tile stages, and more (the CUDA-core loop)
    (1, 2, 64, 16, (9, 70)), (2, 1, 96, 8, (9, 21)), (1, 2, 80, 16, (10, 30)),
    # 9 * Ci * Co above 12288: weights staged per chunk of channels
    (2, 1, 64, 64, (9, 70)), (1, 2, 96, 64, (13, 21)),
    (1, 1, 200, 24, (5, 9))])
def test_conv_folded_kernel_matches_plain(n, stride, ci, co, hw, slope,
                                          dtype, tol):
    need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand((n, *hw, ci), device="cuda", generator=g).to(dtype)
    w = 0.1 * torch.randn((3, 3, ci, co), device="cuda", generator=g)
    b = 0.1 * torch.randn((co,), device="cuda", generator=g)
    with torch.no_grad():
        got = conv_folded_kernel.conv_folded_cuda(x, w, b, stride,
                                                  slope).float()
        want = conv_ref(x, w, b, stride=stride, slope=slope).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= tol * want.abs().max()
