"""The port's train path (``pwcnet_tpu_torch``: losses, schedule, synthetic
batches, train step, checkpoints, ``train()``) held against the JAX
package's, on the CPU in f32.

Inputs come from numpy with a seed and go through both. The whole-step
comparison loads the same flax parameters into both models (the JAX side
uses ``corr_backend="lax"``, which ``tests/test_cost_volume_pallas.py``
pins equal to the Pallas kernel, gradients included).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pwcnet_tpu.data.synthetic as jsyn
import pwcnet_tpu.losses as jl
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_lr_schedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
import pwcnet_tpu_torch.data.synthetic as tsyn
import pwcnet_tpu_torch.losses as tl
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import _flatten, load_flax_params
from pwcnet_tpu_torch.compat.flax_weights import torch_key
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.loop import build_model, train
from pwcnet_tpu_torch.train.schedule import (ScheduleConfig, lr_at,
                                             make_optimizer)
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_eval_step, make_train_step


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _flows(rng, n=2, hw=((4, 6), (8, 12), (16, 24))):
    return [rng.standard_normal((n, h, w, 2)).astype(np.float32) * 0.3
            for h, w in hw]


def _gt(rng, n=2, hw=(64, 96)):
    gt = rng.standard_normal((n, *hw, 2)).astype(np.float32) * 4
    valid = (rng.random((n, *hw)) > 0.3).astype(np.float32)
    return gt, valid


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("hw", [(16, 24), (6, 7), (25, 40)])
def test_downsample_gt_matches_jax(hw, with_valid):
    rng = np.random.default_rng(0)
    gt, valid = _gt(rng)
    v = valid if with_valid else None
    got, got_v = tl.downsample_gt(_t(gt), hw, 20.0,
                                  None if v is None else _t(v))
    want, want_v = jl.downsample_gt(jnp.asarray(gt), hw, 20.0,
                                    None if v is None else jnp.asarray(v))
    assert _rel_err(got.numpy(), want) <= 1e-5
    if with_valid:
        assert _rel_err(got_v.numpy(), want_v) <= 1e-5
    else:
        assert got_v is None and want_v is None


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("kind", ["multiscale", "robust"])
def test_losses_match_jax(kind, with_valid):
    rng = np.random.default_rng(1)
    flows = _flows(rng)
    gt, valid = _gt(rng)
    v = valid if with_valid else None
    tfn, jfn = {"multiscale": (tl.multiscale_loss, jl.multiscale_loss),
                "robust": (tl.robust_loss, jl.robust_loss)}[kind]
    # Three levels, four weights: the first three are used.
    w = (0.32, 0.08, 0.02, 0.01)
    got = tfn([_t(f) for f in flows], _t(gt), None if v is None else _t(v),
              weights=w)
    want = jfn([jnp.asarray(f) for f in flows], jnp.asarray(gt),
               None if v is None else jnp.asarray(v), weights=w)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))


def test_level_weights_extend_to_extra_levels():
    flows = list(range(7))
    assert tl._weights_for(flows, tl.LEVEL_WEIGHTS) == jl._weights_for(
        flows, jl.LEVEL_WEIGHTS) == tl.LEVEL_WEIGHTS + (0.005, 0.005)
    assert tl._weights_for(flows[:2], (1.0, 2.0, 3.0)) == (1.0, 2.0)


@pytest.mark.parametrize("with_valid", [False, True])
def test_epe_and_fl_outliers_match_jax(with_valid):
    rng = np.random.default_rng(2)
    gt, valid = _gt(rng)
    pred = gt + rng.standard_normal(gt.shape).astype(np.float32) * 3
    v = valid if with_valid else None
    got = tl.epe(_t(pred), _t(gt), None if v is None else _t(v)).item()
    want = float(jl.epe(jnp.asarray(pred), jnp.asarray(gt),
                        None if v is None else jnp.asarray(v)))
    assert abs(got - want) <= 1e-6 * want
    fl = tl.fl_outliers(_t(pred), _t(gt)).numpy()
    np.testing.assert_array_equal(
        fl, np.asarray(jl.fl_outliers(jnp.asarray(pred), jnp.asarray(gt))))
    assert 0 < fl.mean() < 1


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 4])
def test_lr_schedule_matches_optax_at_its_boundaries(warmup):
    kw = dict(base_lr=1e-3, milestones=(3, 7, 8), gamma=0.5,
              warmup_steps=warmup)
    want = make_lr_schedule(JaxSchedule(**kw))
    cfg = ScheduleConfig(**kw)
    counts = range(0, 16 + warmup)
    got = [lr_at(cfg, c) for c in counts]
    np.testing.assert_allclose(got, [float(want(c)) for c in counts],
                               rtol=1e-6, atol=0)
    # Driven as the trainer drives it: the rate of the k-th update is the
    # schedule at count k - 1, as optax counts.
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sched = make_optimizer([p], cfg)
    seen = []
    for _ in counts:
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(2)
        opt.step()
        sched.step()
    np.testing.assert_allclose(seen, got, rtol=1e-12, atol=0)


@pytest.mark.parametrize("coupled_l2", [False, True])
def test_optimizer_updates_match_optax(coupled_l2):
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((5, 6)).astype(np.float32)
    sched = JaxSchedule(base_lr=1e-2, milestones=(2,), gamma=0.5)
    tx = jax_optimizer(sched, weight_decay=0.1, coupled_l2=coupled_l2)
    wj, state = jnp.asarray(w0), None
    state = tx.init(wj)
    p = torch.nn.Parameter(_t(w0.copy()))
    opt, sch = make_optimizer([p], ScheduleConfig(base_lr=1e-2,
                                                  milestones=(2,)),
                              weight_decay=0.1, coupled_l2=coupled_l2)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, wj)
        wj = optax.apply_updates(wj, upd)
        p.grad = _t(g.copy())
        opt.step()
        sch.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(wj),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["smooth", "hard"])
def test_render_matches_jax(regime):
    hw = (48, 80)
    p = jsyn._scale_pos(jsyn._host_params(np.random.default_rng(4), regime),
                        hw, np)
    q = tsyn._scale_pos(tsyn._host_params(np.random.default_rng(4), regime),
                        hw)
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], q[k])
    want = jsyn._render(np, hw, p)
    got = tsyn._render(hw, tsyn.to_device(q, "cpu"))
    for k in ("im1", "im2", "flow", "valid"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=5e-5 if k == "flow" else 2e-5)
    if regime == "hard":
        assert 0 < got["valid"].mean() < 1


def test_device_batcher_is_deterministic_in_seed_and_step():
    make = tsyn.make_device_batcher
    a = make(2, (32, 48), seed=3, device="cpu")(5)
    b = make(2, (32, 48), seed=3, device="cpu")(5)
    c = make(2, (32, 48), seed=3, device="cpu")(6)
    assert a["im1"].shape == (2, 32, 48, 3) and a["flow"].shape[-1] == 2
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["im1"], c["im1"])
    rng = np.random.default_rng((3, 2, 5, 1))
    one = tsyn._render((32, 48), tsyn.to_device(
        tsyn._scale_pos(tsyn._host_params(rng), (32, 48)), "cpu"))
    assert torch.equal(a["im1"][1], one["im1"])


# ---------------------------------------------------------------------------
# One whole train step against the JAX package's
# ---------------------------------------------------------------------------

STEP_HW = (128, 128)
STEP_SCHEDULE = dict(base_lr=1e-4, milestones=(1,), gamma=0.5)
# The batch: two hard-regime samples (their invalid bands run the
# mask-weighted GT path). LeakyReLU's gradient jumps at 0, so where a
# pre-activation lies within rounding of 0 two right f32 implementations
# can give gradients a relative 1e-3 apart (seeds 10 and 11 do: one
# estimator weight at 1.1e-3). These seeds have no such activation: every
# gradient agrees within a few 1e-6.
STEP_SEEDS = (20, 21)


@pytest.fixture
def one_thread():
    """Multi-threaded CPU kernels of torch add in a varying order; one
    thread makes two runs of the same steps bitwise equal."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _steps()
    finally:
        torch.set_num_threads(n_threads)


def _steps():
    hw = STEP_HW
    samples = [jsyn._render(np, hw, jsyn._scale_pos(
        jsyn._host_params(np.random.default_rng(s), "hard"), hw, np))
        for s in STEP_SEEDS]
    batch = {k: np.stack([s[k] for s in samples]).astype(np.float32)
             for k in samples[0]}
    assert 0 < batch["valid"].mean() < 1  # the mask-weighted path runs
    jm = JaxPWCNet(corr_backend="lax")
    params = jax.jit(jm.init)(jax.random.key(0), batch["im1"], batch["im2"])
    flat0 = _flatten(jax.device_get(params)["params"])

    def loss_fn(p):
        return jl.multiscale_loss(jm.apply(p, batch["im1"], batch["im2"]),
                                  batch["flow"], batch["valid"])

    jgrads = _flatten(jax.device_get(jax.jit(jax.grad(loss_fn))(params))[
        "params"])
    tx = jax_optimizer(JaxSchedule(**STEP_SCHEDULE))
    jstep = jax_train_step(jm, tx, aug=None)
    st = JaxTrainState.create(params, tx, jax.random.key(1))
    jmetrics = []
    for _ in range(2):
        st, m = jstep(st, batch)
        jmetrics.append({k: float(v) for k, v in m.items()})
    flat2 = _flatten(jax.device_get(st.params)["params"])

    model = PWCNet(device="cpu")
    load_flax_params(model, jax.device_get(params)["params"])
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**STEP_SCHEDULE))
    tstep = make_train_step(model, opt, sched)
    state = TrainState.create(model, opt, sched, seed=1)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tmetrics, tgrads = [], None
    for _ in range(2):
        state, m = tstep(state, tbatch)
        tmetrics.append({k: float(v) for k, v in m.items()})
        if tgrads is None:
            tgrads = {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()}
    tparams = {n: p.detach() for n, p in model.named_parameters()}
    as_torch = lambda a: a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    keyed = lambda flat: {torch_key(k): as_torch(v) for k, v in flat.items()}
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, jgrads=keyed(jgrads),
                tgrads=tgrads, j0=keyed(flat0), j2=keyed(flat2),
                t2=tparams, state=state)


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_metrics_match_jax(steps, i):
    got, want = steps["tmetrics"][i], steps["jmetrics"][i]
    assert got.keys() == want.keys() == {"loss", "train_epe", "grad_norm"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got, want)
    assert steps["state"].step == 2


def test_train_step_gradients_match_jax(steps):
    jg, tg = steps["jgrads"], steps["tgrads"]
    assert jg.keys() == tg.keys()
    errs = {k: _rel_err(tg[k].numpy(), jg[k]) for k in jg}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                              key=lambda t: -t[1])[:3]


def test_train_step_updates_match_jax(steps):
    """The change of every parameter over two AdamW steps, where the first
    step's reference gradient is not near 0 (|g| > 1e-3 * max|g| of its
    tensor): near 0, Adam's m / (sqrt(v) + eps) is about +-1 whatever the
    gradient's last bits, so two right implementations may move such an
    entry by +-lr in opposite directions. The first step then moves the
    masked entries alike (by about lr * sign(g)); the second step's
    gradient is taken at parameters that already differ by up to 2 lr at
    the unmasked entries, and its m / sqrt(v) amplifies a difference where
    g changes sign. So, in units of the second step's rate lr2 = 5e-5:
    99.9% of the masked entries agree within 1e-2, and every one within
    0.5, i.e. no second update goes the other way (measured: median 3e-5,
    99.9th percentile 3e-3, max 0.3)."""
    diffs, masked_out, total = [], 0, 0
    for k, g in steps["jgrads"].items():
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        dj = (steps["j2"][k] - steps["j0"][k])[mask]
        dt = (steps["t2"][k].numpy() - steps["j0"][k])[mask]
        diffs.append(np.abs(dt - dj) / 5e-5)
        masked_out += (~mask).sum()
        total += g.size
    d = np.concatenate(diffs)
    assert np.quantile(d, 0.999) <= 1e-2 and d.max() <= 0.5, (
        np.quantile(d, 0.999), d.max())
    # Most entries are compared (measured: 19% lie under the mask).
    assert masked_out < 0.25 * total


# ---------------------------------------------------------------------------
# train(): checkpoints, resume, what is not ported
# ---------------------------------------------------------------------------

def _tiny_cfg(log_dir, **train_kw):
    cfg = PRESETS["synthetic-proof"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=(64, 64))),
        train=dataclasses.replace(cfg.train, global_batch=1,
                                  log_dir=str(log_dir), summary_interval=1,
                                  **train_kw))


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path,
                                                         one_thread):
    whole = train(_tiny_cfg(tmp_path / "a"), max_steps=4, device="cpu")
    first = train(_tiny_cfg(tmp_path / "b"), max_steps=2, device="cpu")
    rest = train(_tiny_cfg(tmp_path / "b"), max_steps=2, device="cpu")
    assert (first["step"], rest["step"], whole["step"]) == (2, 4, 4)
    assert rest["loss"] == whole["loss"]
    a = CheckpointManager(str(tmp_path / "a" / "ckpt")).load()
    b = CheckpointManager(str(tmp_path / "b" / "ckpt")).load()
    assert a["step"] == b["step"] == 4
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for pa, pb in zip(a["optimizer"]["state"].values(),
                      b["optimizer"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a["scheduler"] == b["scheduler"]
    lines = (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4


def test_init_from_warm_starts_the_weights(tmp_path, one_thread):
    train(_tiny_cfg(tmp_path / "a"), max_steps=2, device="cpu")
    ckpt = str(tmp_path / "a" / "ckpt")
    cfg = _tiny_cfg(tmp_path / "c", init_from=ckpt)
    got = train(cfg, max_steps=1, device="cpu")
    assert got["step"] == 1  # the weights, not the step, come from there
    model = build_model(cfg, "cpu")
    model.load_state_dict(CheckpointManager(ckpt).load()["model"])
    b = tsyn.make_device_batcher(1, (64, 64), seed=cfg.train.seed,
                                 device="cpu")(0)
    with torch.no_grad():
        want = tl.multiscale_loss(model(b["im1"], b["im2"]), b["flow"],
                                  b["valid"]).item()
    assert got["loss"] == want


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    model = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(model.parameters(), ScheduleConfig())
    state = TrainState.create(model, opt, sched, seed=0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step is None
    assert mgr.restore_latest_or(state) is state and state.step == 0
    for step in (1, 2, 3):
        state.step = step
        mgr.save(state)
    assert mgr.steps() == [2, 3] and mgr.latest_step == 3
    assert not list(tmp_path.glob("*.tmp"))
    state.step = 0
    mgr.restore(state, step=2)
    assert state.step == 2


def _changed(cfg, change):
    return dataclasses.replace(cfg, **{
        sec: dataclasses.replace(getattr(cfg, sec), **kw)
        for sec, kw in change.items()})


@pytest.mark.parametrize("change", [
    # Data parallelism is ported (tests/test_torch_port_ddp.py); with the
    # spatial axis it is not, and neither is training across spatial shards
    # (refused before any process group is joined).
    dict(parallel=dict(data=2, spatial=2)),
    dict(parallel=dict(spatial=2)),
    dict(parallel=dict(spatial=2, num_processes=2, process_id=0,
                       coordinator="localhost:1")),
])
def test_train_raises_for_what_is_not_ported(tmp_path, change):
    cfg = _changed(_tiny_cfg(tmp_path), change)
    with pytest.raises(NotImplementedError, match="ROADMAP A[5-9]"):
        train(cfg, max_steps=3, device="cpu")


@pytest.mark.parametrize("change, error, match", [
    (dict(parallel=dict(data=2)), ValueError, "needs 2 processes"),
    (dict(parallel=dict(num_processes=2)), ValueError, "coordinator"),
    (dict(parallel=dict(model=2)), NotImplementedError, "model axis"),
])
def test_train_refuses_a_mesh_it_cannot_form(tmp_path, change, error, match):
    """One process cannot be a data mesh of two; more processes need the
    coordinator; the model axis is reserved."""
    cfg = _changed(_tiny_cfg(tmp_path), change)
    with pytest.raises(error, match=match):
        train(cfg, max_steps=1, device="cpu")


@pytest.mark.parametrize("case", ["device_gen_false", "flyingchairs",
                                  "debug_nans", "profile_dir", "raft",
                                  "raft_inscan", "use_norm"])
def test_train_runs_what_was_not_ported(tmp_path, chairs_dir, case):
    """What raised before the file datasets, the trainer's debug switches,
    RAFT and GroupNorm were ported now trains: synthetic pairs through the
    Loader and the augmentation, a FlyingChairs tree (native decoder), the
    NaN checks (silent on finite data, and off again afterwards), the
    profiler (a trace in profile_dir), RAFT under both sequence losses and
    the use_norm PWC-Net."""
    change = {
        "use_norm": dict(model=dict(use_norm=True)),
        "raft": dict(model=dict(family="raft", raft_iters=2),
                     train=dict(loss="sequence")),
        "raft_inscan": dict(model=dict(family="raft", raft_iters=2),
                            train=dict(loss="sequence_inscan")),
        "device_gen_false": dict(data=dict(device_gen=False,
                                           sample_hw=(64, 64))),
        "flyingchairs": dict(data=dict(name="flyingchairs", root=chairs_dir,
                                       sample_hw=(64, 96))),
        "debug_nans": dict(train=dict(debug_nans=True)),
        "profile_dir": dict(train=dict(profile_dir=str(tmp_path / "prof"))),
    }[case]
    cfg = _changed(_tiny_cfg(tmp_path / "run"), change)
    final = train(cfg, max_steps=2, device="cpu")
    assert final["step"] == 2
    assert np.isfinite([final["loss"], final["train_epe"],
                        final["grad_norm"]]).all()
    assert not torch.is_anomaly_enabled()
    if case == "profile_dir":
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))


def test_train_runs_the_periodic_eval(tmp_path):
    """eval_interval inside the run: val metrics in the log and in the
    returned metrics of the last step, flow images of one val sample."""
    cfg = _tiny_cfg(tmp_path, eval_interval=2, eval_limit=2)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, sample_hw=(64, 64), eval_batch=2))
    final = train(cfg, max_steps=2, device="cpu")
    assert final["step"] == 2 and np.isfinite(final["val_epe"])
    assert 0 <= final["val_fl_all"] <= 100
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in recs if "val_epe" in r]
    assert [r["step"] for r in val] == [2]
    assert {"val_fl_all", "val_epe_s0_10", "val_epe_s10_40",
            "val_epe_s40plus"} <= val[0].keys()
    images = sorted(p.name for p in (tmp_path / "images").iterdir())
    assert images == ["val_flow_gt_2.png", "val_flow_pred_2.png",
                      "val_im1_2.png"]


def test_train_without_device_raises_when_there_is_no_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: train() runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_tiny_cfg(tmp_path), max_steps=1)


def test_train_step_refuses_augmentation(one_thread):
    """The step refuses a crop larger than its batch, and otherwise
    augments: with a deterministic augmentation (hflip always, no vflip,
    no photometric jitter, the crop the whole sample) a step on a batch
    equals, bit for bit, an unaugmented step on the batch flipped by hand
    (u negated)."""
    from pwcnet_tpu_torch.config import AugmentConfig
    rng = np.random.default_rng(9)
    batch = {"im1": _t(rng.random((2, 32, 48, 3), np.float32)),
             "im2": _t(rng.random((2, 32, 48, 3), np.float32)),
             "flow": _t(rng.standard_normal((2, 32, 48, 2)).astype(
                 np.float32)),
             "valid": _t((rng.random((2, 32, 48)) > 0.2).astype(
                 np.float32))}
    flipped = {k: v.flip(2) for k, v in batch.items()}
    flipped["flow"] = flipped["flow"] * torch.tensor([-1.0, 1.0])
    aug = AugmentConfig(crop_hw=(32, 48), hflip_prob=1.0, vflip_prob=0.0,
                        photometric=False)
    metrics = []
    for a, b in ((aug, batch), (None, flipped)):
        model = PWCNet(device="cpu", num_levels=3, output_level=2,
                       generator=torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(model.parameters(), ScheduleConfig())
        step = make_train_step(model, opt, sched, aug=a)
        state = TrainState.create(model, opt, sched, seed=1)
        if a is not None:
            too_big = make_train_step(model, opt, sched, aug=AugmentConfig(
                crop_hw=(64, 48)))
            with pytest.raises(ValueError, match="larger than the samples"):
                too_big(state, batch)
        _, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    assert metrics[0] == metrics[1]


def test_eval_step_counts():
    model = PWCNet(device="cpu")
    rng = np.random.default_rng(5)
    im = _t(rng.random((2, 64, 64, 3), np.float32))
    gt, valid = _gt(rng, hw=(64, 64))
    s, o, c, bins, per = make_eval_step(model)(
        {"im1": im, "im2": im.flip(2), "flow": _t(gt), "valid": _t(valid)})
    assert c.item() == valid.sum()
    assert per.shape == (2, 8) and bins.shape == (2, 3)
    assert torch.allclose(per[:, 0].sum(), s) and torch.allclose(
        bins[1].sum(), c)
    assert 0 <= o.item() <= c.item()
