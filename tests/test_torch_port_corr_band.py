"""The plain model of the bf16 K1's banded tiling (``corr_band_ref``) held
against the JAX package's lax correlation on the CPU.

``corr_band_ref`` computes the correlation as the kernel does on the
tensor cores: m16 tiles of f1 pixels, each against a 24-pixel window of f2
(4 to each side), channels zero-padded to a multiple of 16, the taps read
off the diagonals. These tests pin that indexing (displacements 1..4,
ragged widths, the halo-row form of the spatial path) before the kernel
runs on a card; ``chip_smoke.py`` then holds the kernel against the plain
version. Inputs are f32 from numpy with a seed; the tolerance is 1e-5
absolute (only the order of the f32 sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.cost_volume import (cost_volume_lax,
                                        cost_volume_prepadded_lax)
from pwcnet_tpu_torch.ops.cost_volume import corr_band_ref, cost_volume_ref

from torch_port_util import to_torch

TOL = 1e-5
# chip_smoke.py's ragged shapes of K1 and K1p, and a width of 17 at C = 196.
K1_RAGGED = [(2, 7, 13, 5), (1, 9, 33, 196), (3, 20, 70, 32),
             (1, 5, 17, 196)]
K1P_RAGGED = [(2, 5, 13, 5), (1, 3, 33, 196), (3, 9, 70, 32)]


def _feats(shape, seed, extra_rows=0):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal((n, h + extra_rows, w, c)).astype(np.float32)
    return f1, f2


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(2, 9, 37, 24), (1, 6, 16, 8)])
def test_band_matches_jax_lax_per_displacement(shape, d):
    f1, f2 = _feats(shape, d)
    got = corr_band_ref(to_torch(f1), to_torch(f2), d)
    want = np.asarray(cost_volume_lax(jnp.asarray(f1), jnp.asarray(f2), d))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", K1_RAGGED)
def test_band_matches_jax_lax_at_ragged_shapes(shape):
    f1, f2 = _feats(shape, 10)
    got = corr_band_ref(to_torch(f1), to_torch(f2))
    want = np.asarray(cost_volume_lax(jnp.asarray(f1), jnp.asarray(f2), 4))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", K1P_RAGGED)
def test_band_prepadded_matches_jax_lax(shape, d):
    f1, f2e = _feats(shape, 20 + d, extra_rows=2 * d)
    got = corr_band_ref(to_torch(f1), to_torch(f2e), d,
                        prepadded=True)
    want = np.asarray(cost_volume_prepadded_lax(
        jnp.asarray(f1), jnp.asarray(f2e), max_displacement=d))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_band_in_bf16_rounds_once_as_the_plain_version():
    """bf16 inputs: f32 products and sums, one rounding; at most one bf16
    step from the plain version (chip_smoke.py's TOL for the kernel)."""
    f1, f2 = (to_torch(a).bfloat16()
              for a in _feats((2, 8, 40, 64), 30))
    got = corr_band_ref(f1, f2).float()
    want = cost_volume_ref(f1, f2).float()
    assert got.dtype == torch.float32 and corr_band_ref(f1, f2).dtype == \
        torch.bfloat16
    assert (got - want).abs().max() <= 8e-3 * want.abs().max()


def test_band_rejects_mismatched_rows():
    f1 = torch.zeros(1, 4, 16, 8)
    with pytest.raises(ValueError, match="expected"):
        corr_band_ref(f1, torch.zeros(1, 4, 16, 8), 2, prepadded=True)
