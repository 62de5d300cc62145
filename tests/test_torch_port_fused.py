"""The port's fused warp + correlation (``corr_backend="fused"``) held against
the JAX package's, on the CPU.

The JAX side is ``warp_corr_fused``, which runs its Pallas kernel (K6) in
interpret mode off the TPU; the port's side is the plain version
``warp_corr_ref`` (what K6 is held to on the card by ``chip_smoke.py``) and
the backward glue of ``WarpCorrFunction`` with the plain correlation's
vjp in place of K2 and K3. Inputs come from numpy with a seed. Errors are
relative to the reference's largest magnitude.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax
import pwcnet_tpu.data.synthetic as jsyn
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.models.pwcnet import (FeaturePyramidExtractor as JaxFPE,
                                      OpticalFlowEstimator as JaxEstimator)
from pwcnet_tpu.ops.pallas.warp_corr_kernel import warp_corr_fused
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
import pwcnet_tpu_torch.models.pwcnet as pwcnet_mod
import pwcnet_tpu_torch.ops.warp_corr as warp_corr_mod
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import (_flatten, load_flax_params,
                                                  torch_key)
from pwcnet_tpu_torch.ops.cost_volume import cost_volume_bwd_ref
from pwcnet_tpu_torch.ops.kernels import warp_corr_kernel
from pwcnet_tpu_torch.ops.warp_corr import (fused_is_profitable, warp_corr,
                                            warp_corr_ref)
from pwcnet_tpu_torch.train.schedule import ScheduleConfig, make_optimizer
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step

NCORR = 81


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(shape, seed, flow_kind):
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    if flow_kind == "normal":
        flow = 5.0 * rng.standard_normal((n, h, w, 2))
    else:
        # Exact-integer displacements (the bilinear weights' edge cases),
        # a quarter of the pixels +-1000 px out of the image.
        flow = rng.integers(-3, 4, (n, h, w, 2)).astype(np.float64)
        far = rng.random((n, h, w)) < 0.25
        flow[far] = rng.choice([-1000.0, 1000.0], (far.sum(), 2))
    return f1, f2, flow.astype(np.float32)


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,flow_kind,tol", [
    ((2, 24, 40, 16), "float32", "normal", 1e-5),
    ((1, 17, 33, 24), "float32", "normal", 1e-5),
    ((1, 17, 33, 24), "float32", "integer_and_far", 1e-5),
    # One bf16 step of the warped values and of the output (2**-8).
    ((1, 32, 48, 32), "bfloat16", "normal", 8e-3),
])
def test_warp_corr_ref_matches_jax_fused(shape, dtype, flow_kind, tol):
    f1, f2, flow = _inputs(shape, 0, flow_kind)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = warp_corr_fused(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt),
                           jnp.asarray(flow))
    tdt = getattr(torch, dtype)
    got = warp_corr_ref(_t(f1).to(tdt), _t(f2).to(tdt), _t(flow))
    assert got.dtype == tdt and got.shape == shape[:3] + (NCORR,)
    want = np.asarray(want.astype(jnp.float32))
    assert _rel_err(got.float().numpy(), want) <= tol
    if flow_kind == "integer_and_far":
        # A far pixel's warped features are exactly 0, so is its centre tap.
        far = (np.abs(flow) == 1000).any(-1)
        centre = got.numpy()[..., NCORR // 2]
        assert (centre[far] == 0).all() and (centre[~far] != 0).mean() > 0.5


@pytest.fixture(scope="module")
def bwd_case():
    """Inputs, output gradient and jax.grad of the fused JAX op (its custom
    vjp: the Pallas backward kernels in interpret mode)."""
    shape = (1, 16, 24, 8)
    f1, f2, flow = _inputs(shape, 1, "normal")
    flow = flow * 0.6  # 3 px, as tests/test_warp_corr_fused.py
    cos = np.cos(np.arange(np.prod(shape[:3]) * NCORR, dtype=np.float32)
                 ).reshape(shape[:3] + (NCORR,))

    def loss(a, b, fl):
        return jnp.sum(warp_corr_fused(a, b, fl).astype(jnp.float32) * cos)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(flow))
    return (f1, f2, flow, cos), [np.asarray(w) for w in want]


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_backward_glue_matches_jax_grad(bwd_case, needs):
    """(df1, df2, dflow) of WarpCorrFunction's backward, with the plain
    correlation vjp standing in for K2/K3; a gradient not asked for is
    None."""
    (f1, f2, flow, cos), want = bwd_case
    got = warp_corr_kernel.warp_corr_backward(
        _t(cos), _t(f1), _t(f2), _t(flow), 4, cost_volume_bwd_ref, needs)
    for g, w, need in zip(got, want, needs):
        if not need:
            assert g is None
            continue
        assert g.shape == w.shape
        assert _rel_err(g.numpy(), w) <= 1e-4


def test_warp_corr_dispatches_to_plain_on_cpu_and_differentiates():
    f1, f2, flow = (_t(a) for a in _inputs((1, 6, 7, 5), 2, "normal"))
    before = dict(warp_corr_kernel.LAUNCHES)
    a = [t.clone().requires_grad_() for t in (f1, f2, flow)]
    out = warp_corr(*a)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  warp_corr_ref(f1, f2, flow).numpy())
    grads = torch.autograd.grad(out.square().sum(), a)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    assert warp_corr_kernel.LAUNCHES == before


def test_warp_corr_kernel_wrapper_refuses_cpu_tensors():
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        warp_corr_kernel.warp_corr_cuda(f, f, torch.zeros(1, 4, 4, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("shape,flow_kind", [
    ((2, 7, 13, 5), "normal"), ((1, 28, 64, 96), "normal"),
    ((2, 20, 70, 32), "integer_and_far"), ((1, 16, 8192, 8), "normal")])
def test_warp_corr_kernel_matches_plain(shape, flow_kind, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    f1, f2, flow = (_t(a).cuda() for a in _inputs(shape, 3, flow_kind))
    f1, f2 = f1.to(dtype), f2.to(dtype)
    with torch.no_grad():
        got = warp_corr_kernel.warp_corr_cuda(f1, f2, flow).float()
        want = warp_corr_ref(f1, f2, flow).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= tol * want.abs().max()


def test_fused_is_profitable_semantics(monkeypatch):
    # None means the port's own default, measured on the H100.
    monkeypatch.setattr(warp_corr_mod, "FUSED_MIN_PIXELS", 100)
    assert fused_is_profitable(10, 10) and not fused_is_profitable(9, 11)
    # 0 fuses every warped level; an explicit threshold overrides.
    assert fused_is_profitable(1, 1, 0)
    assert fused_is_profitable(8, 8, 64) and not fused_is_profitable(8, 8, 65)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

HW = (64, 64)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX fused model and its parameters (host arrays: the JAX train
    step donates what it is given)."""
    jm = JaxPWCNet(corr_backend="fused", fused_min_pixels=0)
    dummy = np.zeros((1, *HW, 3), np.float32)
    return jm, jax.device_get(jax.jit(jm.init)(jax.random.key(0), dummy,
                                               dummy))


@pytest.fixture(scope="module")
def model_run(jax_params):
    jm, variables = jax_params
    rng = np.random.default_rng(4)
    im1 = rng.random((1, *HW, 3), np.float32)
    im2 = np.clip(np.roll(im1, (2, 3), (1, 2))
                  + 0.05 * rng.standard_normal(im1.shape), 0, 1
                  ).astype(np.float32)

    @jax.jit
    def forward(v):
        # The pyramid and each estimator's input, recorded while tracing.
        rec = {"est_in": []}

        def record(next_fun, args, kwargs, ctx):
            out = next_fun(*args, **kwargs)
            if ctx.method_name == "__call__":
                if isinstance(ctx.module, JaxEstimator):
                    rec["est_in"].append(args[0])
                elif isinstance(ctx.module, JaxFPE):
                    rec["pyramid"] = out
            return out

        with fnn.intercept_methods(record):
            flows = jm.apply(v, im1, im2, train=False)
        return flows, rec["pyramid"], rec["est_in"]

    jflows, jpyr, est_in = jax.device_get(forward(variables))
    # The estimator's input starts with LeakyReLU(corr); invert it.
    jcorr = [np.where(x[..., :NCORR] >= 0, x[..., :NCORR],
                      x[..., :NCORR] / np.float32(0.1)) for x in est_in]
    model = PWCNet(corr_backend="fused", fused_min_pixels=0, device="cpu")
    load_flax_params(model, variables["params"])
    inter = {}
    with torch.no_grad():
        tflows = model(_t(im1), _t(im2), intermediates=inter)
    return dict(
        jax=dict(pyramid=jpyr, corr=jcorr, flows=jflows),
        port=dict(pyramid=[p.numpy() for p in inter["pyramid"]],
                  corr=[c.numpy() for c in inter["corr"]],
                  flows=[f.numpy() for f in tflows]))


@pytest.mark.parametrize("what", ["pyramid", "corr", "flows"])
@pytest.mark.parametrize("i", range(5))
def test_fused_forward_matches_jax_per_level(model_run, what, i):
    got, want = model_run["port"][what][i], model_run["jax"][what][i]
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-4


WARPED_HW = [(2, 2), (4, 4), (8, 8), (16, 16)]  # levels 5..2 of 64 x 64


@pytest.mark.parametrize("min_pixels", [0, 64, None])
def test_fused_model_dispatch(monkeypatch, min_pixels):
    """warp_corr at the warped levels of at least min_pixels pixels (None:
    the port's FUSED_MIN_PIXELS), warp + correlation elsewhere, the plain
    correlation at the top level."""
    least = (warp_corr_mod.FUSED_MIN_PIXELS if min_pixels is None
             else min_pixels)
    fused_hw = [hw for hw in WARPED_HW if hw[0] * hw[1] >= least]
    seen = []

    def spy(f1, f2, flow, max_displacement):
        seen.append(tuple(f1.shape[1:3]))
        return warp_corr(f1, f2, flow, max_displacement=max_displacement)

    monkeypatch.setattr(pwcnet_mod, "warp_corr", spy)
    model = PWCNet(corr_backend="fused", fused_min_pixels=min_pixels,
                   device="cpu")
    ref = PWCNet(device="cpu")
    im = _t(np.random.default_rng(5).random((1, *HW, 3), np.float32))
    with torch.no_grad():
        got = model(im, im.flip(2))
        want = ref(im, im.flip(2))
    assert seen == fused_hw
    for g, w in zip(got, want):
        assert _rel_err(g.numpy(), w.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

STEP_SCHEDULE = dict(base_lr=1e-4, milestones=(1,), gamma=0.5)
# An optax transformation that keeps the raw gradients as its state and
# updates nothing: the JAX train step then returns its metrics and its
# gradients from one compile.
_KEEP_GRADS = optax.GradientTransformation(
    lambda p: jax.tree.map(jnp.zeros_like, p),
    lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def fused_step(jax_params):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _fused_step(*jax_params)
    finally:
        torch.set_num_threads(n_threads)


def _fused_step(jm, params):
    samples = [jsyn._render(np, HW, jsyn._scale_pos(
        jsyn._host_params(np.random.default_rng(s), "hard"), HW, np))
        for s in (30, 31)]
    batch = {k: np.stack([s[k] for s in samples]).astype(np.float32)
             for k in samples[0]}
    st, jm1 = jax_train_step(jm, _KEEP_GRADS, aug=None)(
        JaxTrainState.create(params, _KEEP_GRADS, jax.random.key(1)), batch)
    jgrads = _flatten(jax.device_get(st.opt_state)["params"])

    model = PWCNet(corr_backend="fused", fused_min_pixels=0, device="cpu")
    load_flax_params(model, params["params"])
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**STEP_SCHEDULE))
    _, tm1 = make_train_step(model, opt, sched)(
        TrainState.create(model, opt, sched, seed=1),
        {k: _t(v) for k, v in batch.items()})
    as_torch = lambda a: a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    return dict(
        jmetrics={k: float(v) for k, v in jm1.items()},
        tmetrics={k: float(v) for k, v in tm1.items()},
        jgrads={torch_key(k): as_torch(v) for k, v in jgrads.items()},
        tgrads={n: p.grad.detach().numpy()
                for n, p in model.named_parameters()})


def test_fused_train_step_metrics_match_jax(fused_step):
    got, want = fused_step["tmetrics"], fused_step["jmetrics"]
    assert got.keys() == want.keys() == {"loss", "train_epe", "grad_norm"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)


def test_fused_train_step_gradients_match_jax(fused_step):
    jg, tg = fused_step["jgrads"], fused_step["tgrads"]
    assert jg.keys() == tg.keys()
    errs = {k: _rel_err(tg[k], jg[k]) for k in jg}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                              key=lambda t: -t[1])[:3]
