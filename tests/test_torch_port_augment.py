"""The port's training augmentation and the trainer's file-data path held
against the JAX package's, on the CPU.

JAX draws its augmentation with ``jax.random``, which torch cannot replay.
So ``apply_augment`` is held against JAX's ``augment_batch`` given the
scalars and noise that the test reads out of the same key tree
``_augment_one`` and ``_photometric`` split; the port's own draws are held
by their moments. Then one f32 train step with a deterministic
augmentation against JAX's ``make_train_step(aug=...)``, ``train()`` on a
FlyingChairs tree with a bitwise resume, ``debug_nans`` and
``profile_dir``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pwcnet_tpu.data.augment as jaug
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat import load_flax_params
from pwcnet_tpu_torch.config import PRESETS, AugmentConfig
from pwcnet_tpu_torch.data import augment as taug
from pwcnet_tpu_torch.data import trees
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.loop import nan_checks, train
from pwcnet_tpu_torch.train.schedule import ScheduleConfig, make_optimizer
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step

from torch_port_util import one_thread, random_batch, to_torch

KEYS = ("im1", "im2", "flow", "valid")


def _jax_draws(key, n, hw, cfg):
    """The packed params and the standard normal noise (2, n, th, tw, 3)
    that JAX's ``augment_batch(batch, key, cfg)`` draws, read out of its
    key tree."""
    h, w = hw
    th, tw = cfg.crop_hw
    params = np.zeros((n, taug.N_PARAMS), np.float32)
    noise = np.zeros((2, n, th, tw, 3), np.float32)
    for i, k in enumerate(jax.random.split(key, n)):
        kcrop, khf, kvf, kphoto, _ = jax.random.split(k, 5)
        params[i, taug.Y0] = jax.random.randint(kcrop, (), 0,
                                                max(h - th, 0) + 1)
        params[i, taug.X0] = jax.random.randint(
            jax.random.fold_in(kcrop, 1), (), 0, max(w - tw, 0) + 1)
        params[i, taug.HFLIP] = jax.random.bernoulli(khf, cfg.hflip_prob)
        params[i, taug.VFLIP] = jax.random.bernoulli(kvf, cfg.vflip_prob)
        k1, k2, ka = jax.random.split(kphoto, 3)
        asym = bool(jax.random.bernoulli(ka, cfg.asymmetric_prob))
        params[i, taug.ASYM] = asym
        for f, kf in enumerate((k1, k2 if asym else k1)):
            kb, kc, kg, kcol, kn = jax.random.split(kf, 5)
            col = 1.0 + jax.random.uniform(kcol, (3,), minval=-cfg.color,
                                           maxval=cfg.color)
            params[i, taug.PHOTO[f]:taug.PHOTO[f] + 6] = [
                jax.random.uniform(kb, (), minval=-cfg.brightness,
                                   maxval=cfg.brightness),
                1.0 + jax.random.uniform(kc, (), minval=-cfg.contrast,
                                         maxval=cfg.contrast),
                jax.random.uniform(kg, (), minval=cfg.gamma[0],
                                   maxval=cfg.gamma[1]), *col]
            noise[f, i] = jax.random.normal(kn, (th, tw, 3))
    return params, noise


# Every flip combination with symmetric and with asymmetric jitter, then
# the default probabilities (a mix across the batch) and no jitter.
AUG_CASES = [dict(hflip_prob=h, vflip_prob=v, asymmetric_prob=a)
             for h in (0.0, 1.0) for v in (0.0, 1.0) for a in (0.0, 1.0)] + [
    {}, dict(photometric=False)]


@pytest.mark.parametrize("case", range(len(AUG_CASES)))
def test_apply_augment_matches_jax(case):
    cfg = dataclasses.replace(AugmentConfig(crop_hw=(16, 24)),
                              **AUG_CASES[case])
    rng = np.random.default_rng(case)
    batch = random_batch(rng, 4, (22, 31), 0.3)
    key = jax.random.key(100 + case)
    want = jaug.augment_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              key, jaug.AugmentConfig(**dataclasses.asdict(
                                  cfg)))
    params, noise = _jax_draws(key, 4, (22, 31), cfg)
    got = taug.apply_augment({k: torch.from_numpy(v)
                              for k, v in batch.items()},
                             torch.from_numpy(params), cfg,
                             torch.from_numpy(noise))
    for k in KEYS:
        assert got[k].shape == want[k].shape
        err = np.abs(got[k].numpy() - np.asarray(want[k])).max()
        assert err <= 2e-6, (k, err)
    if "asymmetric_prob" in AUG_CASES[case]:
        assert params[:, taug.ASYM].tolist() == [
            AUG_CASES[case]["asymmetric_prob"]] * 4


def test_draws_have_the_configured_moments():
    cfg = AugmentConfig(crop_hw=(8, 10))
    n = 20_000
    gen = torch.Generator().manual_seed(0)
    p, seed = taug.draw_augment_params(gen, n, (12, 13), cfg)
    p = p.numpy()

    def rate(col, want):
        sigma = np.sqrt(want * (1 - want) / n)
        assert abs(p[:, col].mean() - want) <= 5 * sigma, (col, want)

    rate(taug.HFLIP, cfg.hflip_prob)
    rate(taug.VFLIP, cfg.vflip_prob)
    rate(taug.ASYM, cfg.asymmetric_prob)
    assert sorted(set(p[:, taug.Y0])) == [0, 1, 2, 3, 4]
    assert sorted(set(p[:, taug.X0])) == [0, 1, 2, 3]
    f1, f2 = (p[:, c:c + 6] for c in taug.PHOTO)
    sym = p[:, taug.ASYM] == 0
    np.testing.assert_array_equal(f1[sym], f2[sym])
    for f in (f1, f2[~sym]):
        for j, (lo, hi) in enumerate(
                [(-cfg.brightness, cfg.brightness),
                 (1 - cfg.contrast, 1 + cfg.contrast), cfg.gamma]
                + [(1 - cfg.color, 1 + cfg.color)] * 3):
            v = f[:, j]
            sigma = (hi - lo) / np.sqrt(12 * len(v))
            assert lo <= v.min() and v.max() <= hi, j
            assert abs(v.mean() - (lo + hi) / 2) <= 5 * sigma, j
            assert abs(v.std() - (hi - lo) / np.sqrt(12)) <= 0.02 * (hi - lo)
    # The noise: standard normal, frame 2's equal to frame 1's where the
    # draw is symmetric; a second draw with the same seed is the same.
    small = torch.from_numpy(p[:64])
    z = taug.draw_noise(torch.Generator().manual_seed(seed), small, cfg,
                        "cpu")
    assert z.shape == (2, 64, 8, 10, 3)
    assert abs(float(z.std()) - 1) < 0.05 and abs(float(z.mean())) < 0.05
    s = small[:, taug.ASYM] == 0
    assert torch.equal(z[0][s], z[1][s]) and not torch.equal(z[0][~s],
                                                             z[1][~s])
    assert torch.equal(z, taug.draw_noise(
        torch.Generator().manual_seed(seed), small, cfg, "cpu"))


def test_augment_batch_replays_from_the_generator_state():
    rng = np.random.default_rng(3)
    batch = to_torch(random_batch(rng, 3, (20, 28), 0.3))
    cfg = AugmentConfig(crop_hw=(12, 16))
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    a = taug.augment_batch(batch, gen, cfg)
    gen.set_state(state)
    b = taug.augment_batch(batch, gen, cfg)
    for k in KEYS:
        assert torch.equal(a[k], b[k]) and a[k].shape[1:3] == (12, 16)
        assert not torch.equal(a[k], taug.augment_batch(batch, gen, cfg)[k])


# ---------------------------------------------------------------------------
# One f32 train step with augmentation, against JAX's
# ---------------------------------------------------------------------------

def test_augmented_train_step_matches_jax(one_thread):
    """One step. hflip always, no vflip, no photometric jitter and the
    crop the whole sample: JAX's draws then fix nothing that the port draws
    differently. Tolerances as test_train_step_metrics_match_jax."""
    hw = (64, 64)
    cfg = AugmentConfig(crop_hw=hw, hflip_prob=1.0, vflip_prob=0.0,
                        photometric=False)
    batch = random_batch(np.random.default_rng(11), 2, hw, 0.3)
    small = dict(num_levels=3, output_level=2)
    jm = JaxPWCNet(corr_backend="lax", **small)
    params = jax.jit(jm.init)(jax.random.key(0), batch["im1"], batch["im2"])
    sched = dict(base_lr=1e-4, milestones=(1,), gamma=0.5)
    tx = jax_optimizer(JaxSchedule(**sched))
    jstep = jax_train_step(jm, tx, aug=jaug.AugmentConfig(
        **dataclasses.asdict(cfg)))
    st = JaxTrainState.create(params, tx, jax.random.key(1))
    model = PWCNet(device="cpu", **small)
    load_flax_params(model, jax.device_get(params)["params"])
    opt, tsched = make_optimizer(model.parameters(), ScheduleConfig(**sched))
    tstep = make_train_step(model, opt, tsched, aug=cfg)
    state = TrainState.create(model, opt, tsched, seed=1)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, jmetrics = jstep(st, batch)
    _, tmetrics = tstep(state, tbatch)
    for k in ("loss", "train_epe", "grad_norm"):
        got, want = float(tmetrics[k]), float(jmetrics[k])
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)


# ---------------------------------------------------------------------------
# train() on a FlyingChairs tree; debug_nans; profile_dir
# ---------------------------------------------------------------------------

def _chairs_cfg(root, log_dir, **train_kw):
    cfg = PRESETS["chairs-quick"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       num_levels=3, output_level=2),
        data=dataclasses.replace(cfg.data, root=root, sample_hw=(48, 64),
                                 num_threads=2,
                                 augment=dataclasses.replace(
                                     cfg.data.augment, crop_hw=(32, 48))),
        train=dataclasses.replace(cfg.train, global_batch=2,
                                  log_dir=str(log_dir), summary_interval=1,
                                  eval_interval=2, eval_limit=2, **train_kw))


def test_train_on_a_chairs_tree_resumes_bit_for_bit(tmp_path, one_thread):
    root = trees.write_chairs(str(tmp_path / "chairs"), 9, (48, 64))
    whole = train(_chairs_cfg(root, tmp_path / "a"), max_steps=4,
                  device="cpu")
    first = train(_chairs_cfg(root, tmp_path / "b"), max_steps=2,
                  device="cpu")
    rest = train(_chairs_cfg(root, tmp_path / "b"), max_steps=2,
                 device="cpu")
    assert (first["step"], rest["step"], whole["step"]) == (2, 4, 4)
    assert rest["loss"] == whole["loss"] and np.isfinite(whole["loss"])
    a = CheckpointManager(str(tmp_path / "a" / "ckpt")).load()
    b = CheckpointManager(str(tmp_path / "b" / "ckpt")).load()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    lines = (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()
    assert sum('"val_epe"' in line for line in lines) == 2


def _nan_setup():
    rng = np.random.default_rng(12)
    model = PWCNet(device="cpu", num_levels=3, output_level=2,
                   dtype=torch.float32)
    opt, sched = make_optimizer(model.parameters(), ScheduleConfig())
    step = make_train_step(model, opt, sched)
    batch = to_torch(random_batch(rng, 2, (32, 32), 0.3))
    return model, step, TrainState.create(model, opt, sched, seed=1), batch


@pytest.mark.parametrize("where", ["im1", "flow"])
def test_debug_nans_raises_on_a_nan(where):
    """A NaN pixel raises at the first module whose output it reaches; a
    NaN in the ground truth reaches no module and raises in the backward
    (anomaly mode). The hooks and the anomaly mode end with the block."""
    model, step, state, batch = _nan_setup()
    batch[where][0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match="module" if where == "im1" else "nan values"):
        with nan_checks(model):
            step(state, batch)
    assert not torch.is_anomaly_enabled()
    assert all(not m._forward_hooks for m in model.modules())


def test_debug_nans_off_is_silent():
    model, step, state, batch = _nan_setup()
    batch["im1"][0, 0, 0, 0] = float("nan")
    _, metrics = step(state, batch)
    assert not np.isfinite(float(metrics["loss"]))


def test_profile_dir_writes_a_trace(tmp_path):
    root = trees.write_chairs(str(tmp_path / "chairs"), 4, (48, 64))
    prof = tmp_path / "prof"
    train(_chairs_cfg(root, tmp_path / "run", profile_dir=str(prof)),
          max_steps=1, device="cpu")
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "aten::" in traces[0].read_text()
