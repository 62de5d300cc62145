"""The port's whole PWC-Net forward held against the JAX package's.

Both models get the same flax parameters (through the port's weight
bridge) and the same images. The JAX side is ``PWCNet(corr_backend=
"pallas")``, which on the CPU runs the correlation kernel in interpret mode
and the stem as its lax chain; the port runs on ``device="cpu"``, i.e. the
plain versions of its kernels. Every comparison is a relative max error,
``max|got - ref| <= 1e-4 * max|ref|``, taken per level for the pyramid
features, the correlation and the flows: at random init the flows are only
a few hundredths in size, so an absolute tolerance on the flows alone could
not see a wrong pyramid.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.models.pwcnet import (FeaturePyramidExtractor as JaxFPE,
                                      OpticalFlowEstimator as JaxEstimator)
from pwcnet_tpu_torch import PWCNet, predict_flow
from pwcnet_tpu_torch.compat import load_flax_params
from pwcnet_tpu_torch.train.evaluate import pad_to_divisible

RAW_HW = (100, 150)  # padded to (128, 192) by pad_to_divisible
TOL = 1e-4
NCORR = 81


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    raw1 = rng.random((*RAW_HW, 3), np.float32)
    raw2 = np.clip(np.roll(raw1, (2, 3), (0, 1))
                   + 0.05 * rng.standard_normal(raw1.shape), 0, 1
                   ).astype(np.float32)
    im1, _ = pad_to_divisible(raw1[None])
    im2, _ = pad_to_divisible(raw2[None])

    jm = JaxPWCNet(corr_backend="pallas")
    variables = jax.jit(jm.init)(jax.random.key(0), im1, im2)
    rec = {"est_in": []}

    def record(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if ctx.method_name == "__call__":
            if isinstance(ctx.module, JaxEstimator):
                rec["est_in"].append(np.asarray(args[0]))
            elif isinstance(ctx.module, JaxFPE):
                rec["pyramid"] = [np.asarray(p) for p in out]
        return out

    with fnn.intercept_methods(record):
        jflows = jm.apply(variables, im1, im2, train=False)
    jpred = np.asarray(jm.full_res_flow(jflows, im1.shape[1:3]))[
        0, :RAW_HW[0], :RAW_HW[1]]
    # The estimator's input starts with LeakyReLU(corr); invert the
    # activation to recover the correlation itself.
    jcorr = [np.where(x[..., :NCORR] >= 0, x[..., :NCORR],
                      x[..., :NCORR] / np.float32(0.1))
             for x in rec["est_in"]]

    model = PWCNet(device="cpu")
    load_flax_params(model, jax.device_get(variables)["params"])
    inter = {}
    with torch.no_grad():
        tflows = model(torch.from_numpy(im1), torch.from_numpy(im2),
                       intermediates=inter)
    return dict(
        model=model, raw=(raw1, raw2),
        jax=dict(pyramid=rec["pyramid"], corr=jcorr,
                 flows=[np.asarray(f) for f in jflows], pred=jpred),
        port=dict(pyramid=[p.numpy() for p in inter["pyramid"]],
                  corr=[c.numpy() for c in inter["corr"]],
                  flows=[f.numpy() for f in tflows]))


@pytest.mark.parametrize("what", ["pyramid", "corr", "flows"])
@pytest.mark.parametrize("i", range(5))
def test_forward_matches_jax_per_level(run, what, i):
    got, want = run["port"][what][i], run["jax"][what][i]
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL


def test_forward_has_signal(run):
    # The comparison means something only if the flows are not ~0.
    assert np.abs(run["jax"]["flows"][-1]).max() > 1e-2
    assert len(run["port"]["flows"]) == 5


def test_predict_flow_non_divisible_size(run):
    got = predict_flow(run["model"], *run["raw"])
    want = run["jax"]["pred"]
    assert got.shape == (*RAW_HW, 2) and got.dtype == np.float32
    assert _rel_err(got, want) <= TOL


def test_forward_rejects_non_divisible_size():
    model = PWCNet(device="cpu")
    im = torch.zeros(1, 96, 128, 3)
    with pytest.raises(ValueError, match="divisible"):
        model(im, im)


@pytest.mark.parametrize("kwargs", [
    # The spatial path is ported (tests/test_torch_port_spatial.py), but
    # only with half-pixel upsampling. GroupNorm (use_norm) is ported:
    # tests/test_torch_port_norm.py.
    dict(spatial_axis="spatial", resize_mode="align_corners")])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        PWCNet(device="cpu", **kwargs)


def test_fused_backend_constructs_and_dispatches(monkeypatch):
    """corr_backend="fused" (ported): warp_corr at every warped level when
    fused_min_pixels=0, the same flows as the composed path on the CPU.
    tests/test_torch_port_fused.py holds it against the JAX model."""
    import pwcnet_tpu_torch.models.pwcnet as pwcnet_mod
    calls = []
    real = pwcnet_mod.warp_corr
    monkeypatch.setattr(pwcnet_mod, "warp_corr", lambda *a, **k: (
        calls.append(a[0].shape[1:3]), real(*a, **k))[1])
    fused = PWCNet(device="cpu", corr_backend="fused", fused_min_pixels=0)
    assert fused.corr_backend == "fused"
    im = torch.from_numpy(np.random.default_rng(3).random((1, 64, 64, 3),
                                                          np.float32))
    with torch.no_grad():
        got = fused(im, im.flip(2))
        want = PWCNet(device="cpu")(im, im.flip(2))
    assert len(calls) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flow_chain_stays_f32_in_bf16_model():
    model = PWCNet(device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    im = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    with torch.no_grad():
        flows = model(im, im.flip(2))
    assert all(f.dtype == torch.float32 for f in flows)
    assert all(torch.isfinite(f).all() for f in flows)


@pytest.mark.parametrize("cfg", [
    # min_level 1: the pyramid runs as plain ConvBlocks, no fused stem.
    dict(num_levels=3, output_level=2, input_norm=True),
    dict(num_levels=4, output_level=2, input_center=True, residual=False,
         resize_mode="align_corners", search_range=2),
])
def test_options_match_jax(cfg):
    rng = np.random.default_rng(2)
    im1 = rng.random((1, 32, 48, 3), np.float32)
    im2 = rng.random((1, 32, 48, 3), np.float32)
    jm = JaxPWCNet(corr_backend="lax", **cfg)
    variables = jax.jit(jm.init)(jax.random.key(1), im1, im2)
    want = jm.apply(variables, im1, im2, train=False)
    model = PWCNet(device="cpu", **cfg)
    load_flax_params(model, jax.device_get(variables)["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(im1), torch.from_numpy(im2))
    assert len(got) == len(want) == cfg["output_level"] + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), np.asarray(w)) <= TOL


# -- the backend names (corr_backend, stem_backend) ---------------------------

@pytest.fixture(scope="module")
def lax_run():
    """JAX ``PWCNet(corr_backend="lax")`` (its stem on the CPU: the lax
    chain) against the port's ``corr_backend="lax"``, same flax weights."""
    rng = np.random.default_rng(5)
    im1 = rng.random((1, 64, 128, 3), np.float32)
    im2 = np.clip(np.roll(im1, (1, 2), (1, 2))
                  + 0.05 * rng.standard_normal(im1.shape), 0, 1
                  ).astype(np.float32)
    jm = JaxPWCNet(corr_backend="lax")
    variables = jax.jit(jm.init)(jax.random.key(3), im1, im2)
    rec = {"est_in": []}

    def record(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if ctx.method_name == "__call__":
            if isinstance(ctx.module, JaxEstimator):
                rec["est_in"].append(np.asarray(args[0]))
            elif isinstance(ctx.module, JaxFPE):
                rec["pyramid"] = [np.asarray(p) for p in out]
        return out

    with fnn.intercept_methods(record):
        jflows = jm.apply(variables, im1, im2, train=False)
    jcorr = [np.where(x[..., :NCORR] >= 0, x[..., :NCORR],
                      x[..., :NCORR] / np.float32(0.1))
             for x in rec["est_in"]]
    model = PWCNet(device="cpu", corr_backend="lax", stem_backend="lax")
    load_flax_params(model, jax.device_get(variables)["params"])
    inter = {}
    with torch.no_grad():
        tflows = model(torch.from_numpy(im1), torch.from_numpy(im2),
                       intermediates=inter)
    return dict(
        jax=dict(pyramid=rec["pyramid"], corr=jcorr,
                 flows=[np.asarray(f) for f in jflows]),
        port=dict(pyramid=[p.numpy() for p in inter["pyramid"]],
                  corr=[c.numpy() for c in inter["corr"]],
                  flows=[f.numpy() for f in tflows]))


@pytest.mark.parametrize("what", ["pyramid", "corr", "flows"])
@pytest.mark.parametrize("i", range(5))
def test_lax_backend_matches_jax_lax_per_level(lax_run, what, i):
    got, want = lax_run["port"][what][i], lax_run["jax"][what][i]
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL


def test_build_model_takes_corr_backend_lax():
    from pwcnet_tpu_torch.config import PRESETS, apply_overrides
    from pwcnet_tpu_torch.train.loop import build_model
    cfg = apply_overrides(PRESETS["synthetic-proof"],
                          ["model.corr_backend=lax", "model.stem_backend=lax",
                           "model.dtype=float32"])
    model = build_model(cfg, "cpu")
    assert model.corr_backend == "lax"
    assert model.pyramid.stem.backend == "lax"
    im = torch.from_numpy(np.random.default_rng(6).random((1, 64, 64, 3),
                                                          np.float32))
    with torch.no_grad():
        got = model(im, im.flip(2))
        want = PWCNet(device="cpu", generator=torch.Generator().manual_seed(
            cfg.train.seed))(im, im.flip(2))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", ["auto", "pallas", "lax"])
def test_stem_backends_accepted_and_plain_on_cpu(backend):
    from pwcnet_tpu_torch.models.layers import StemConvs
    from pwcnet_tpu_torch.ops.kernels import stem_kernel
    stem = StemConvs(16, 32, backend)
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in stem.parameters():
            p.copy_(torch.from_numpy(
                0.2 * rng.standard_normal(p.shape).astype(np.float32)))
    im = torch.from_numpy(rng.random((2, 16, 24, 3), np.float32))
    with torch.no_grad():
        got = stem(im)
    assert torch.equal(got, stem_kernel.stem_ref(im, stem.params()))


@pytest.mark.parametrize("kwargs", [dict(corr_backend="cuda"),
                                    dict(stem_backend="cuda")])
def test_unknown_backend_names_raise(kwargs):
    with pytest.raises(ValueError, match="backend"):
        PWCNet(device="cpu", **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lax_backends_on_the_card_run_the_plain_ops(dtype):
    """corr_backend="lax", stem_backend="lax" on a CUDA tensor: the plain
    ops (no kernel launch counted), the same flows as the kernels' model
    within the forward's tolerance (f32) or finite (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pwcnet_tpu_torch.ops.kernels import (cost_volume_kernel,
                                              stem_kernel, warp_corr_kernel)
    torch.backends.cudnn.allow_tf32 = False
    mods = (cost_volume_kernel, stem_kernel, warp_corr_kernel)
    lax = PWCNet(device="cuda", corr_backend="lax", stem_backend="lax",
                 dtype=dtype).eval()
    kern = PWCNet(device="cuda", dtype=dtype).eval()
    rng = np.random.default_rng(8)
    im = torch.from_numpy(rng.random((1, 128, 192, 3), np.float32)).cuda()
    with torch.no_grad():
        before = [dict(m.LAUNCHES) for m in mods]
        got = lax(im, im.flip(2))
        torch.cuda.synchronize()
        assert [dict(m.LAUNCHES) for m in mods] == before
        want = kern(im, im.flip(2))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        if dtype == torch.float32:
            assert _rel_err(g.cpu().numpy(), w.cpu().numpy()) <= TOL
