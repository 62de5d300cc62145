"""The port's GroupNorm (``ConvBlock(use_norm=True)``) held against flax's
``nn.GroupNorm`` and the JAX package's ``use_norm`` PWC-Net, on the CPU.

The model is small (3 levels, search range 2, as
``tests/test_parity_harness.py``'s). Both models get the same flax
parameters through the port's weight bridge. Tolerances are relative max
errors, ``max|got - ref| <= tol * max|ref|``: the norm alone 1e-5 in f32,
one bf16 step (2**-7 of max) in bf16; the forward 1e-4 per level; one
train step's gradients ``max(1e-4, 3 x floor)`` with ``floor`` the port's
own change of its gradients when frame 1 is scaled by 1 + 1e-6 * N(0, 1),
the f32 floor rule of ``chip_smoke.py``. Under a mesh, JAX's GSPMD takes
the norm's statistics over the whole image, so the port sums them across
its ranks: two ``gloo`` ranks (``parallel.launch.run_ranks``) run the
spatial forward against JAX's ``spatial_forward`` on its 2-device mesh and
against the port's unsharded forward, and one data-parallel step against
one process.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import pwcnet_tpu.data.synthetic as jsyn
import pwcnet_tpu.losses as jl
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.models.pwcnet import FeaturePyramidExtractor as JaxFPE
from pwcnet_tpu.parallel import MeshConfig as JaxMeshConfig
from pwcnet_tpu.parallel import make_mesh as jax_make_mesh
from pwcnet_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import (_flatten, load_flax_params,
                                                  torch_key)
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.models.layers import ConvBlock, GroupNorm, norm_groups
from pwcnet_tpu_torch.parallel.launch import run_ranks, run_steps
from pwcnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                               load_model_weights)
from pwcnet_tpu_torch.train.loop import build_model, train
from pwcnet_tpu_torch.train.schedule import ScheduleConfig, make_optimizer
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step

SMALL = dict(num_levels=3, output_level=2, search_range=2, use_norm=True)
HW = (64, 64)
TOL = 1e-4
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SCHEDULE = dict(base_lr=1e-4, milestones=(1,), gamma=0.5)
FLOOR_FACTOR = 3.0
WORKER_TIMEOUT_S = 240


def _rel_err(got, want):
    got = np.asarray(torch.as_tensor(got).double() if torch.is_tensor(got)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _nchw(x):
    return torch.tensor(np.asarray(x).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    im1 = rng.random((2, *HW, 3), np.float32)
    im2 = np.clip(np.roll(im1, (1, 2), (1, 2))
                  + 0.05 * rng.standard_normal(im1.shape), 0, 1
                  ).astype(np.float32)
    return im1, im2


@pytest.fixture(scope="module")
def jax_model(images):
    jm = JaxPWCNet(corr_backend="pallas", **SMALL)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.key(0), *images))["params"]
    return jm, params


def _port_model(params, **kw):
    model = PWCNet(device="cpu", **{**SMALL, **kw})
    load_flax_params(model, params)
    return model


# ---------------------------------------------------------------------------
# GroupNorm alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("channels,groups", [(16, 8), (4, 4), (2, 2),
                                             (1, 1)])
def test_group_norm_matches_flax(channels, groups, dtype):
    """Inputs of mean 128 and std ~1.3: there E[x^2] - E[x]^2 in f32 loses
    bits to cancellation, and the two-pass variance differs from it by
    more than 1e-5. The values are multiples of 1/4 and a group has a
    power-of-two count, so every sum is exact in any order, and only
    flax's formula itself meets 1e-5."""
    assert norm_groups(channels) == groups
    rng = np.random.default_rng(channels)
    k = rng.integers(-8, 9, (2, 4, 4, channels))
    # An odd sum per group puts E[x]'s lowest bit at 2**-6, so E[x]^2 needs
    # more bits than f32 has and is rounded in every group.
    size = channels // groups
    even = k.reshape(2, 16, groups, size).sum((1, 3)) % 2 == 0
    k[:, 0, 0, ::size] += even
    x = ((512 + k) / 4).astype(np.float32)
    scale = (rng.choice([-1, 1], channels) * (0.5 + rng.random(channels))
             ).astype(np.float32)
    bias = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    gn = fnn.GroupNorm(num_groups=groups, dtype=jnp.float32)
    want = np.asarray(gn.apply(
        {"params": {"scale": scale, "bias": bias}},
        xj.astype(jnp.float32)).astype(jdt).astype(jnp.float32))
    norm = GroupNorm(channels)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(_nchw(np.asarray(xj.astype(jnp.float32))).to(dtype))
    assert got.dtype == dtype
    assert _rel_err(got.float().permute(0, 2, 3, 1), want) <= NORM_TOL[dtype]
    if dtype == torch.float32:
        xg = torch.from_numpy(x).reshape(2, 16, groups, size)
        mean = xg.mean((1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean((1, 3), keepdim=True)
        two_pass = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(x.shape) \
            * torch.from_numpy(scale) + torch.from_numpy(bias)
        assert _rel_err(two_pass, want) > NORM_TOL[dtype]


def test_conv_block_orders_conv_norm_activation():
    block = ConvBlock(3, 8, stride=2, use_norm=True)
    assert [n for n, _ in block.named_children()] == ["conv", "norm"]
    with torch.no_grad():
        block.norm.weight.fill_(2.0)
        x = torch.randn(1, 3, 8, 8, generator=torch.Generator(
            ).manual_seed(0))
        want = F.leaky_relu(block.norm(block.conv(x)), 0.1)
        assert torch.equal(block(x), want)
    assert ConvBlock(3, 8).norm is None


def test_bridge_maps_group_norm_leaves():
    assert torch_key("FeaturePyramidExtractor_0/ConvBlock_3/GroupNorm_0/"
                     "scale") == "pyramid.blocks.3.norm.weight"
    assert torch_key("estimator_l5/ConvStack_0/ConvBlock_1/GroupNorm_0/"
                     "bias") == "estimators.l5.stack.blocks.1.norm.bias"
    assert torch_key("estimator_l5/ConvStack_0/ConvBlock_1/Conv_0/"
                     "kernel") == "estimators.l5.stack.blocks.1.conv.weight"
    for bad in ("FeaturePyramidExtractor_0/ConvBlock_0/GroupNorm_0/mean",
                "context/ConvBlock_0/GroupNorm_0/scale",
                "estimator_l5/Conv_0/scale"):
        with pytest.raises(KeyError):
            torch_key(bad)


# ---------------------------------------------------------------------------
# The use_norm PWC-Net against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def forward(images, jax_model):
    jm, params = jax_model
    rec = {}

    def record(next_fun, args, kwargs, ctx):
        out = next_fun(*args, **kwargs)
        if ctx.method_name == "__call__" and isinstance(ctx.module, JaxFPE):
            rec["pyramid"] = [np.asarray(p) for p in out]
        return out

    with fnn.intercept_methods(record):
        jflows = jm.apply({"params": params}, *images, train=False)
    model = _port_model(params)
    inter = {}
    with torch.no_grad():
        tflows = model(*map(torch.from_numpy, images), intermediates=inter)
    return (dict(pyramid=rec["pyramid"], flows=[np.asarray(f)
                                                for f in jflows]),
            dict(pyramid=[p.numpy() for p in inter["pyramid"]],
                 flows=[f.numpy() for f in tflows]))


@pytest.mark.parametrize("what", ["pyramid", "flows"])
@pytest.mark.parametrize("i", range(3))
def test_use_norm_forward_matches_jax_per_level(forward, what, i):
    want, got = forward[0][what][i], forward[1][what][i]
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL


def test_use_norm_model_has_no_stem_and_every_norm(jax_model):
    """use_norm turns the fused stem off (JAX too); every pyramid and
    estimator block carries a norm, filled from JAX's GroupNorm_0, and the
    context network has none, as in JAX."""
    stemmed = dict(SMALL, num_levels=4)
    assert PWCNet(device="cpu", **stemmed).pyramid.stem is None
    assert PWCNet(device="cpu", **dict(stemmed, use_norm=False)
                  ).pyramid.stem is not None
    model = _port_model(jax_model[1])
    blocks = list(model.pyramid.blocks) + [
        b for e in model.estimators.values() for b in e.stack.blocks]
    assert all(b.norm is not None for b in blocks)
    assert all(b.norm is None for b in model.context.blocks)
    jax_norms = {torch_key(k) for k in _flatten(jax_model[1])
                 if "/GroupNorm_0/" in k}
    assert jax_norms == {k for k in model.state_dict() if ".norm." in k}
    assert len(jax_norms) == 2 * len(blocks)


# ---------------------------------------------------------------------------
# Training: one step against JAX's, train(), checkpoints, DDP
# ---------------------------------------------------------------------------

def _batch(seeds=(20, 21)):
    samples = [jsyn._render(np, HW, jsyn._scale_pos(
        jsyn._host_params(np.random.default_rng(s), "hard"), HW, np))
        for s in seeds]
    return {k: np.stack([s[k] for s in samples]).astype(np.float32)
            for k in samples[0]}


def _port_step(params, batch, im_noise=0.0, seed=0):
    model = _port_model(params, corr_backend="lax")
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**SCHEDULE))
    step = make_train_step(model, opt, sched)
    b = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    if im_noise:
        b["im1"] *= 1 + im_noise * torch.randn(
            b["im1"].shape, generator=torch.Generator().manual_seed(seed))
    _, m = step(TrainState.create(model, opt, sched, seed=1), b)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these CPU ops are small, and under parallel test
    workers more threads only contend; it also makes reruns bitwise
    equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_use_norm_train_step_matches_jax(jax_model, one_thread):
    """One step from the same flax params on the same batch: the metrics
    within 1e-5, every gradient within the f32 floor rule."""
    jm = JaxPWCNet(corr_backend="lax", **SMALL)
    params = jax_model[1]
    batch = _batch()

    def loss_fn(p):
        return jl.multiscale_loss(jm.apply(p, batch["im1"], batch["im2"]),
                                  batch["flow"], batch["valid"])

    jgrads = _flatten(jax.device_get(jax.jit(jax.grad(loss_fn))(
        {"params": params}))["params"])
    tx = jax_optimizer(JaxSchedule(**SCHEDULE))
    st = JaxTrainState.create({"params": params}, tx, jax.random.key(1))
    _, jm_metrics = jax_train_step(jm, tx, aug=None)(st, batch)
    metrics, grads = _port_step(params, batch)
    for k, v in jm_metrics.items():
        assert abs(metrics[k] - float(v)) <= 1e-5 * abs(float(v)), k
    want = {torch_key(k): (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
            for k, v in jgrads.items()}
    assert want.keys() == grads.keys()
    assert any(".norm." in k for k in want)
    floor = max(max(_rel_err(g[k], grads[k]) for k in grads)
                for g in (_port_step(params, batch, 1e-6, s)[1]
                          for s in range(3)))
    tol = max(TOL, FLOOR_FACTOR * floor)
    errs = {k: _rel_err(grads[k], want[k]) for k in want}
    assert max(errs.values()) <= tol, (tol, sorted(
        errs.items(), key=lambda t: -t[1])[:3])


def _tiny_cfg(log_dir, **train_kw):
    cfg = PRESETS["synthetic-proof"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       use_norm=True),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=HW)),
        train=dataclasses.replace(cfg.train, global_batch=1,
                                  log_dir=str(log_dir), summary_interval=1,
                                  **train_kw))


def test_use_norm_checkpoint_round_trip(tmp_path, one_thread):
    """train() with use_norm checkpoints the norms' parameters; the
    directory refills a fresh model, and a resumed run equals an
    uninterrupted one bit for bit."""
    whole = train(_tiny_cfg(tmp_path / "a"), max_steps=3, device="cpu")
    train(_tiny_cfg(tmp_path / "b"), max_steps=2, device="cpu")
    rest = train(_tiny_cfg(tmp_path / "b"), max_steps=1, device="cpu")
    assert rest["step"] == whole["step"] == 3
    assert rest["loss"] == whole["loss"]
    saved = CheckpointManager(str(tmp_path / "a" / "ckpt")).load()["model"]
    norms = [k for k in saved if ".norm." in k]
    assert norms and any(not torch.equal(saved[k], torch.ones_like(saved[k]))
                         for k in norms if k.endswith("weight"))
    model = build_model(_tiny_cfg(tmp_path / "c"), "cpu")
    load_model_weights(model, str(tmp_path / "a" / "ckpt"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


@pytest.fixture(scope="module")
def ranks(images, jax_model, tmp_path_factory):
    """One job of two gloo ranks: the use_norm spatial forward (S = 2,
    pallas and fused), then one data-parallel use_norm step."""
    im1, im2 = images
    sd = _port_model(jax_model[1]).state_dict()
    cfg = _tiny_cfg("unused")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **SMALL),
        train=dataclasses.replace(cfg.train, global_batch=2,
                                  weight_decay=0.0))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tasks = [dict(kind="forward", model=dict(SMALL, corr_backend=b),
                  state_dict=sd, im1=torch.from_numpy(im1[:1]),
                  im2=torch.from_numpy(im2[:1]))
             for b in ("pallas", "fused")]
    tasks.append(dict(kind="step", cfg=cfg, state_dict=sd, batches=[batch]))
    res = run_ranks(2, dict(backend="gloo", device="cpu", threads=1,
                            tasks=tasks),
                    str(tmp_path_factory.mktemp("norm_ranks")),
                    timeout=WORKER_TIMEOUT_S)
    return dict(cfg=cfg, sd=sd, batch=batch, forward=[r[:2] for r in res],
                step=[r[2] for r in res])


@pytest.fixture(scope="module")
def jax_spatial(images, jax_model):
    im1, im2 = images
    mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=2))
    out = {}
    for backend in ("pallas", "fused"):
        model = JaxPWCNet(corr_backend=backend, fused_min_pixels=0, **SMALL)
        flows, _ = jax_spatial_forward(model, {"params": jax_model[1]},
                                       mesh, im1[:1], im2[:1])
        out[backend] = [np.asarray(f) for f in flows]
    return out


@pytest.mark.parametrize("b", [0, 1], ids=["pallas", "fused"])
def test_use_norm_under_a_mesh_matches_jax(ranks, jax_spatial, b):
    """The port's S = 2 forward equals JAX's spatial_forward per level on
    both ranks (its GroupNorm statistics span the whole image, as GSPMD's
    do)."""
    want = jax_spatial[("pallas", "fused")[b]]
    for rank in ranks["forward"]:
        got = rank[b]["flows"]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert _rel_err(g.numpy(), w) <= TOL


def test_use_norm_under_a_mesh_equals_the_unsharded_forward(ranks, images):
    model = PWCNet(device="cpu", **SMALL)
    model.load_state_dict(ranks["sd"])
    with torch.no_grad():
        want = model(*(torch.from_numpy(x[:1]) for x in images))
    for g, w in zip(ranks["forward"][0][0]["flows"], want):
        assert _rel_err(g.numpy(), w.numpy()) <= TOL


def test_use_norm_two_ranks_equal_one_process(ranks, one_thread):
    """Two ranks of one image each against one process on both: the loss
    within 1e-5, the averaged gradients within the f32 floor rule (every
    block's norm keeps its activations near 0, where LeakyReLU's gradient
    jumps)."""
    one = run_steps(ranks["cfg"], ranks["sd"], [ranks["batch"]])
    a, b = ranks["step"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    got, want = a["metrics"][0], one["metrics"][0]
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])

    def rel(grads):
        return max(_rel_err(grads[k], w.numpy())
                   for k, w in one["grads"][0].items())

    floor = 0.0
    for s in range(3):
        noisy = dict(ranks["batch"], im1=ranks["batch"]["im1"] * (
            1 + 1e-6 * torch.randn(ranks["batch"]["im1"].shape,
                                   generator=torch.Generator(
                                       ).manual_seed(s))))
        floor = max(floor, rel(run_steps(ranks["cfg"], ranks["sd"],
                                         [noisy])["grads"][0]))
    assert any(".norm." in k for k in a["grads"][0])
    assert rel(a["grads"][0]) <= max(TOL, FLOOR_FACTOR * floor), floor
