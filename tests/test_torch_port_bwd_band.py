"""The plain models of the bf16 tilings of K2, K3 and K6 held against the
JAX package on the CPU.

``corr_bwd_band_ref`` computes df2 of the correlation as the bf16 K3 does
on the tensor cores: m16 tiles of output pixels, each the product of a band
of g (16 x 32, the taps of each source pixel on a diagonal) with a 32-pixel
window of f1, channels zero-padded to a multiple of 16, f32 sums over the
dy values, one rounding. ``corr_bwd_f1_band_ref`` computes df1 as the bf16
K2 does, on the same tile: band row i holds the taps of output pixel i, and
the window is f2's. Both are held against ``jax.vjp`` of the JAX package's
``cost_volume_lax`` at displacements 1..4 and ragged widths, absolute
tolerance 1e-5 in f32 (only the order of the f32 sums differs) and one
bf16 rounding in bf16; K2's also against ``jax.vjp`` of the Pallas
``cost_volume_pallas`` in interpret mode, whose backward runs
``_corr_bwd_f1_kernel`` itself.

The bf16 K6 is K1's band (``corr_band_ref``) with the warp's output as its
B tile: ``corr_band_ref(f1, warp_bilinear(f2, flow))`` is held against
JAX's ``warp_corr_fused`` (its Pallas kernel in interpret mode) and the
prepadded form against ``warp_corr_fused_prepadded`` on the corners of
``_warp_ext_corners``, with flows of exact integers and far-out pixels and
flows that reach past the rows the correlation or the halo covers.
``chip_smoke.py`` then holds the kernels against the plain versions on the
card. Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.cost_volume import cost_volume_lax
from pwcnet_tpu.ops.pallas.cost_volume_kernel import (_bwd_tile_fits,
                                                      cost_volume_pallas)
from pwcnet_tpu.ops.pallas.warp_corr_kernel import (warp_corr_fused,
                                                    warp_corr_fused_prepadded)
from pwcnet_tpu.parallel.halo import _warp_ext_corners
from pwcnet_tpu_torch.ops.cost_volume import (corr_band_ref,
                                              corr_bwd_band_ref,
                                              corr_bwd_f1_band_ref)
from pwcnet_tpu_torch.ops.warp import warp_bilinear, warp_ext_ref

TOL = 1e-5
BF16_STEP = 2.0 ** -8
# chip_smoke.py's ragged correlation shapes (W = 13, 33, 70; C = 5, 196,
# 32) and a width of 17 at C = 196.
RAGGED = [(2, 7, 13, 5), (1, 5, 17, 196), (1, 9, 33, 196), (3, 20, 70, 32)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _bwd_inputs(shape, d, seed):
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((n, h, w, (2 * d + 1) ** 2)).astype(np.float32)
    return f1, f2, g


def _jax_grads(f1, f2, g, d, dtype=jnp.float32, corr=None):
    """(df1, df2) of ``jax.vjp`` of the correlation (default
    ``cost_volume_lax``), as f32 numpy arrays."""
    corr = corr or (lambda a, b: cost_volume_lax(a, b, d))
    _, vjp = jax.vjp(corr, jnp.asarray(f1, dtype), jnp.asarray(f2, dtype))
    return [np.asarray(t.astype(jnp.float32))
            for t in vjp(jnp.asarray(g, dtype))]


# ---------------------------------------------------------------------------
# K3: corr_bwd_band_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 9, 37, 24), (1, 6, 16, 8)])
def test_bwd_band_matches_jax_vjp_per_displacement(shape, d):
    f1, f2, g = _bwd_inputs(shape, d, d)
    got = corr_bwd_band_ref(_t(g), _t(f1), d)
    want = _jax_grads(f1, f2, g, d)[1]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", RAGGED)
def test_bwd_band_matches_jax_vjp_at_ragged_shapes(shape, d):
    f1, f2, g = _bwd_inputs(shape, d, 10 + d)
    got = corr_bwd_band_ref(_t(g), _t(f1), d)
    np.testing.assert_allclose(got.numpy(), _jax_grads(f1, f2, g, d)[1],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 40, 64), (1, 5, 17, 196)])
def test_bwd_band_in_bf16_rounds_once(shape):
    """bf16 inputs: f32 products and sums, then one rounding, so each value
    is within one bf16 step of JAX's f32 df2 of the same bf16 values."""
    f1, f2, g = _bwd_inputs(shape, 4, 30)
    bf = [torch.from_numpy(a).bfloat16() for a in (f1, f2, g)]
    got = corr_bwd_band_ref(bf[2], bf[0])
    assert got.dtype == torch.bfloat16
    want = _jax_grads(*(t.float().numpy() for t in bf), 4)[1]
    got = got.float().numpy()
    assert (np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-6).all()


def test_bwd_band_rejects_a_gradient_of_another_shape():
    f1 = torch.zeros(1, 4, 16, 8)
    with pytest.raises(ValueError, match="expected"):
        corr_bwd_band_ref(torch.zeros(1, 4, 16, 49), f1, 4)


# ---------------------------------------------------------------------------
# K2: corr_bwd_f1_band_ref
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 9, 37, 24), (1, 6, 16, 8)])
def test_f1_band_matches_jax_vjp_per_displacement(shape, d):
    f1, f2, g = _bwd_inputs(shape, d, 20 + d)
    got = corr_bwd_f1_band_ref(_t(g), _t(f2), d)
    want = _jax_grads(f1, f2, g, d)[0]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", RAGGED)
def test_f1_band_matches_jax_vjp_at_ragged_shapes(shape, d):
    f1, f2, g = _bwd_inputs(shape, d, 30 + d)
    got = corr_bwd_f1_band_ref(_t(g), _t(f2), d)
    np.testing.assert_allclose(got.numpy(), _jax_grads(f1, f2, g, d)[0],
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 8, 40, 64), (1, 5, 17, 196)])
def test_f1_band_in_bf16_rounds_once(shape):
    """bf16 inputs: f32 products and sums, then one rounding, so each value
    is within one bf16 step of JAX's f32 df1 of the same bf16 values."""
    f1, f2, g = _bwd_inputs(shape, 4, 31)
    bf = [torch.from_numpy(a).bfloat16() for a in (f1, f2, g)]
    got = corr_bwd_f1_band_ref(bf[2], bf[1])
    assert got.dtype == torch.bfloat16
    want = _jax_grads(*(t.float().numpy() for t in bf), 4)[0]
    got = got.float().numpy()
    assert (np.abs(got - want) <= BF16_STEP * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("shape,d", [((1, 6, 20, 24), 4), ((1, 5, 17, 8), 2)])
def test_f1_band_matches_jax_pallas_kernel(shape, d):
    """Against ``jax.vjp`` of the Pallas correlation in interpret mode: at
    N = 1 (no width packing) and a backward tile that fits, its backward is
    ``_corr_bwd_f1_kernel`` (df1) and ``_corr_bwd_f2_kernel`` (df2), so
    the K3 band model is held against the latter on the way."""
    _, _, w, c = shape
    assert _bwd_tile_fits(w, c, d, 4)  # the Pallas backward, not lax's
    f1, f2, g = _bwd_inputs(shape, d, 40 + d)
    df1, df2 = _jax_grads(f1, f2, g, d, corr=lambda a, b: cost_volume_pallas(
        a, b, max_displacement=d, interpret=True))
    np.testing.assert_allclose(corr_bwd_f1_band_ref(_t(g), _t(f2), d),
                               df1, atol=TOL, rtol=0)
    np.testing.assert_allclose(corr_bwd_band_ref(_t(g), _t(f1), d), df2,
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("g_shape", [(1, 4, 16, 49), (1, 4, 15, 81)])
def test_f1_band_rejects_a_gradient_of_another_shape(g_shape):
    f2 = torch.zeros(1, 4, 16, 8)
    with pytest.raises(ValueError, match="expected"):
        corr_bwd_f1_band_ref(torch.zeros(g_shape), f2, 4)


# ---------------------------------------------------------------------------
# K6 and K6p: corr_band_ref on the warped tensor
# ---------------------------------------------------------------------------

def _flow(rng, n, rows, w, kind, reach):
    """integer_and_far: exact integers in [-3, 3], a quarter of the pixels
    +-1000 px out of the image; beyond: N(0, 1) with a quarter of the pixels
    moved +-(reach + 3) rows."""
    if kind == "integer_and_far":
        flow = rng.integers(-3, 4, (n, rows, w, 2)).astype(np.float64)
        far = rng.random((n, rows, w)) < 0.25
        flow[far] = rng.choice([-1000.0, 1000.0], (far.sum(), 2))
    else:
        flow = rng.standard_normal((n, rows, w, 2))
        far = rng.random((n, rows, w)) < 0.25
        flow[..., 1] += far * rng.choice([-1.0, 1.0], (n, rows, w)) * (
            reach + 3)
    return flow.astype(np.float32)


def _dtypes(dtype):
    return ((jnp.bfloat16, torch.bfloat16, 8e-3) if dtype == "bfloat16"
            else (jnp.float32, torch.float32, TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["integer_and_far", "beyond"])
def test_warped_band_matches_jax_fused(kind, dtype):
    """The bf16 K6's arithmetic: K1's band on the warped f2. Relative to
    the largest value: f32 sums in another order; in bf16 one step of the
    warped values and of the output."""
    d, shape = 3, (1, 11, 37, 24)
    rng = np.random.default_rng(40)
    f1, f2 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    flow = _flow(rng, 1, 11, 37, kind, d)
    jdt, tdt, tol = _dtypes(dtype)
    want = warp_corr_fused(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt),
                           jnp.asarray(flow), max_displacement=d,
                           interpret=True)
    got = corr_band_ref(_t(f1).to(tdt),
                        warp_bilinear(_t(f2).to(tdt), _t(flow)), d)
    assert got.dtype == tdt
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("row0", [0, 9])  # the top shard, an interior one
@pytest.mark.parametrize("kind", ["integer_and_far", "beyond"])
def test_warped_band_prepadded_matches_jax_fused_prepadded(kind, row0):
    """The bf16 K6p's arithmetic: the band on the warped halo-extended
    shard (rows [-d, t + d)) against the JAX fused kernel on the corners of
    _warp_ext_corners; ``beyond`` samples past the exchanged rows (the
    halo-bound clamp). f32."""
    n, t, w, c, d, halo, h = 2, 9, 21, 16, 2, 4, 27
    rng = np.random.default_rng(50 + row0)
    f1 = rng.standard_normal((n, t, w, c)).astype(np.float32)
    f2e = rng.standard_normal((n, t + 2 * halo, w, c)).astype(np.float32)
    flow = _flow(rng, n, t + 2 * d, w, kind, halo)
    g, wm = _warp_ext_corners(jnp.asarray(f2e), jnp.asarray(flow),
                              jnp.int32(row0), h, halo, d)
    want = warp_corr_fused_prepadded(jnp.asarray(f1), g, wm,
                                     max_displacement=d, interpret=True)
    warped = warp_ext_ref(_t(f2e), _t(flow), row0, h, halo, d)
    got = corr_band_ref(_t(f1), warped, d, prepadded=True)
    assert _rel_err(got.numpy(), np.asarray(want)) <= TOL


# ---------------------------------------------------------------------------
# On the card: the bf16 kernels against their plain models
# ---------------------------------------------------------------------------

def _bwd_kernel_vs_model(shape, d, which):
    """The bf16 K2 (which = 1) or K3 (2) against its band model (f32 sums
    in another order, one rounding each: one bf16 step of the largest
    value), and a second call bit for bit the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    f1, f2, g = (_t(a).cuda().bfloat16() for a in _bwd_inputs(shape, d, 60))
    need = (which == 1, which == 2)
    got, again = (ck.cost_volume_bwd_cuda(g, f1, f2, d, *need)[which - 1]
                  for _ in range(2))
    want = (corr_bwd_f1_band_ref(g, f2, d) if which == 1
            else corr_bwd_band_ref(g, f1, d)).float()
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max() <= BF16_STEP * want.abs().max()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", RAGGED + [(8, 12, 14, 128)])
def test_k3_kernel_matches_its_band_model(shape, d):
    _bwd_kernel_vs_model(shape, d, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", RAGGED + [(8, 12, 14, 128)])
def test_k2_kernel_matches_its_band_model(shape, d):
    _bwd_kernel_vs_model(shape, d, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer_and_far", "beyond"])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (1, 9, 33, 196),
                                   (8, 24, 28, 96)])
def test_k6_kernel_matches_its_band_model(shape, kind):
    """The bf16 K6 against K1's band on the plain warp: the warped values
    are the same bits, only the order of the f32 tap sums differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel as wk
    rng = np.random.default_rng(70)
    n, h, w, _ = shape
    f1, f2 = (_t(rng.standard_normal(shape).astype(np.float32)).cuda()
              .bfloat16() for _ in range(2))
    flow = _t(_flow(rng, n, h, w, kind, 4)).cuda()
    got = wk.warp_corr_cuda(f1, f2, flow).float()
    want = corr_band_ref(f1, warp_bilinear(f2, flow)).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= BF16_STEP * want.abs().max()
