"""Step capture (``pwcnet_tpu_torch/capture.py``, the port's counterpart of
``jax.jit``) on the CPU: the static-buffer augmentation, the train step's
captured body, the eval step and the inference forward run from static
buffers, cross-device optimizer state, the cache key, and ``capture=True``
refused without a card. A CUDA graph needs a card, so the data flow of a
capture is run here with the record and the replay made eager calls of the
function on its static buffers (``emulated``); the ``cuda`` tests replay
real graphs and skip here.

Sizes are small: PWC-Net with 3 levels at 64x48 (RAFT 1 iteration), f32,
one CPU thread (multi-threaded CPU torch is not bitwise reproducible).
"""

import copy
import dataclasses
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
import pwcnet_tpu_torch.capture as capture_mod
import pwcnet_tpu_torch.train.evaluate as evaluate_mod
import pwcnet_tpu_torch.train.step as step_mod
from pwcnet_tpu_torch import PWCNet, trace
from pwcnet_tpu_torch.capture import Captured, model_captured, signature
from pwcnet_tpu_torch.compat.flax_weights import load_flax_params
from pwcnet_tpu_torch.config import AugmentConfig
from pwcnet_tpu_torch.data.augment import (N_PARAMS, augment_batch,
                                           augment_device, draw_augment)
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
from pwcnet_tpu_torch.frontend import match_two_view
from pwcnet_tpu_torch.models.raft import RAFT
from pwcnet_tpu_torch.train.evaluate import (evaluate_dataset, infer_flow,
                                             predict_flow)
from pwcnet_tpu_torch.train.schedule import (ScheduleConfig,
                                             load_optimizer_state,
                                             make_capturable,
                                             make_optimizer)
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_eval_step, make_train_step

from torch_port_util import make_model, one_thread, random_batch, to_torch

SMALL = dict(num_levels=3, output_level=2)
FAMILY_KW = {"pwcnet": SMALL, "raft": dict(num_iters=1)}
HW = (64, 48)
SCHEDULE = dict(base_lr=1e-4, milestones=(2,), gamma=0.5)
STEPS = 3


@pytest.fixture
def emulated(monkeypatch):
    """``Captured``'s data flow on the CPU: static buffers made at the
    first call of a signature, inputs copied in, outputs cloned out, the
    train step's eager first call; the graph's record only stores the
    static arguments, and a replay calls the function on them (a real
    replay runs the recorded kernels on the same buffers)."""
    def record(self, key, entry):
        args, kwargs = entry.args()
        for _ in range(self.warmup):
            self.fn(*args, **kwargs)
        entry.graph = "recorded"

    def replay(self, entry):
        args, kwargs = entry.args()
        entry.outputs = self.fn(*args, **kwargs)

    monkeypatch.setattr(Captured, "_record", record)
    monkeypatch.setattr(Captured, "_replay", replay)
    monkeypatch.setattr(Captured, "warm",
                        lambda self, *a, **k: self.fn(*a, **k))
    for mod in (step_mod, evaluate_mod):
        monkeypatch.setattr(mod, "capture_enabled",
                            lambda c, d, distributed=False: bool(c))


# ---------------------------------------------------------------------------
# The augmentation from static buffers
# ---------------------------------------------------------------------------

AUG_CASES = [
    AugmentConfig(crop_hw=(48, 40)),
    AugmentConfig(crop_hw=(48, 40), asymmetric_prob=1.0, hflip_prob=1.0),
    AugmentConfig(crop_hw=(64, 48), asymmetric_prob=0.0, vflip_prob=1.0),
    AugmentConfig(crop_hw=(32, 32), photometric=False),
]


@pytest.mark.parametrize("case", range(len(AUG_CASES)))
def test_static_buffer_augmentation_equals_augment_batch(case):
    """Both draws outside (the scalars on the CPU generator, one randn on
    the noise generator), copied into static buffers, then the device
    transform: bit for bit ``augment_batch`` at the same generator state,
    which both leave in the same state."""
    cfg = AUG_CASES[case]
    batch = to_torch(random_batch(np.random.default_rng(case), 3, HW, 0.2))
    g_want, g_got = (torch.Generator().manual_seed(7 + case)
                     for _ in range(2))
    n_want, n_got = (torch.Generator() for _ in range(2))
    bufs = {k: torch.zeros_like(v) for k, v in batch.items()}
    p_buf = torch.zeros((3, N_PARAMS))
    z_buf = torch.zeros((2, 3, *cfg.crop_hw, 3))
    for _ in range(2):  # the second step from the advanced generators
        want = augment_batch(batch, g_want, cfg, n_want)
        params, z = draw_augment(g_got, 3, HW, cfg, n_got)
        for k, v in batch.items():
            bufs[k].copy_(v)
        p_buf.copy_(params)
        if z is not None:
            z_buf.copy_(z)
        got = augment_device(bufs, p_buf, z_buf if cfg.photometric else None,
                             cfg)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(g_got.get_state(), g_want.get_state())
        assert (z is None) == (not cfg.photometric)


# ---------------------------------------------------------------------------
# The train step's captured body, run from static buffers
# ---------------------------------------------------------------------------

def _run_steps(family, capture, aug, grad_clip=0.0, batch=None, model=None):
    model = model or make_model(family, **FAMILY_KW[family])
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**SCHEDULE))
    loss = "sequence" if family == "raft" else "multiscale"
    step = make_train_step(model, opt, sched, loss_kind=loss, aug=aug,
                           grad_clip=grad_clip, capture=capture)
    state = TrainState.create(model, opt, sched, seed=3)
    metrics = []
    for i in range(STEPS):
        b = batch if batch is not None else to_torch(random_batch(
            np.random.default_rng(100 + i), 2, HW, 0.2))
        state, m = step(state, b)
        metrics.append({k: v.clone() for k, v in m.items()})
    return metrics, state


STEP_CASES = [("pwcnet", None, 0.0),
              ("pwcnet", AugmentConfig(crop_hw=(48, 40)), 0.0),
              ("pwcnet", AugmentConfig(crop_hw=(64, 48)), 1e-3),
              ("raft", None, 0.0)]


@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_captured_train_step_body_equals_the_eager_step(emulated, one_thread,
                                                        case):
    """Three steps: the first eager, the second captured, the third
    replayed, from static buffers (the augmentation's draws copied in):
    metrics, parameters, Adam's moments, the rate and the generator bit
    for bit those of ``capture=False``."""
    family, aug, clip = STEP_CASES[case]
    want_m, want = _run_steps(family, False, aug, clip)
    got_m, got = _run_steps(family, True, aug, clip)
    assert got.step == want.step == STEPS
    for g, w in zip(got_m, want_m):
        assert g.keys() == w.keys() == {"loss", "train_epe", "grad_norm"}
        for k in w:
            assert torch.equal(g[k], w[k]), (k, g, w)
    for (n, p), q in zip(got.model.named_parameters(),
                         want.model.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(got.model.parameters(), want.model.parameters()):
        sg, sw = got.optimizer.state[p], want.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sg[k], sw[k]), k
    assert got.optimizer.param_groups[0]["lr"] == \
        want.optimizer.param_groups[0]["lr"]
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_captured_train_step_matches_jax(emulated, one_thread):
    """The emulated captured step against JAX's jitted step on one batch,
    at test_torch_port_train.py's tolerances (metrics within 1e-5 of
    JAX's, over the first two steps, as test_train_step_metrics_match_jax
    compares them)."""
    batch = random_batch(np.random.default_rng(5), 2, HW, 0.2)
    jm = JaxPWCNet(corr_backend="lax", **SMALL)
    params = jax.jit(jm.init)(jax.random.key(0), batch["im1"], batch["im2"])
    model = PWCNet(device="cpu", **SMALL)
    load_flax_params(model, jax.device_get(params)["params"])
    tx = jax_optimizer(JaxSchedule(**SCHEDULE))
    jstep = jax_train_step(jm, tx, aug=None)
    st = JaxTrainState.create(params, tx, jax.random.key(1))
    want = []
    for _ in range(2):
        st, m = jstep(st, batch)
        want.append({k: float(v) for k, v in m.items()})
    got, _ = _run_steps("pwcnet", True, None, batch=to_torch(batch),
                        model=model)
    for g, w in zip(got, want):
        for k in w:
            assert abs(float(g[k]) - w[k]) <= 1e-5 * abs(w[k]), (k, g, w)


def test_captured_train_step_keeps_a_graph_per_signature(emulated,
                                                         one_thread):
    """A new batch shape is a new signature: its first step is eager, its
    second captured; the first shape's entry is replayed again after it."""
    model = make_model("pwcnet", **SMALL)
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**SCHEDULE))
    step = make_train_step(model, opt, sched, capture=True)
    state = TrainState.create(model, opt, sched, seed=3)
    calls = []
    real = Captured.__call__

    def counted(self, *a, **k):
        calls.append(tuple(a[0]["im1"].shape[:3]))
        return real(self, *a, **k)

    shapes = [(2, 64, 48), (2, 64, 48), (1, 32, 48), (1, 32, 48),
              (2, 64, 48)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Captured, "__call__", counted)
        for n, h, w in shapes:
            state, _ = step(state, to_torch(random_batch(
                np.random.default_rng(h), n, (h, w), 0.2)))
    assert calls == [(2, 64, 48), (1, 32, 48), (2, 64, 48)]
    assert state.step == len(shapes)


def test_captured_counts_captures_and_replays(emulated):
    """``capture.<name>.captures`` counts the signatures recorded,
    ``.replays`` the calls of a known one; the spans name the key, the
    record, the load, the replay."""
    f = Captured(lambda x: x * 2, warmup=1, name="count test")
    counts = trace.counters("capture.count_test")
    trace.reset()
    with trace.enabled():
        for n in (3, 3, 4, 3, 4):
            assert torch.equal(f(torch.ones(n)), torch.full((n,), 2.0))
    assert (counts["captures"], counts["replays"]) == (2, 3)
    new = ["capture.key", "capture.record", "capture.replay"]
    known = ["capture.key", "capture.load", "capture.replay"]
    assert [r.name for r in trace.records()] == new + known + new + known * 2
    trace.reset()


def test_train_logs_graph_captures_and_replays(emulated, one_thread,
                                               tmp_path):
    """Each summary of ``train()`` holds the run's graph captures and
    replays so far (the first step eager, the second captured, the rest
    replayed); with spans on, each step is a ``trainer.feed`` span holding
    the device batcher's and a ``train_step`` span holding the replay's."""
    from pwcnet_tpu_torch.config import PRESETS
    from pwcnet_tpu_torch.train.loop import train
    cfg = PRESETS["synthetic-proof"]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=(64, 64))),
        train=dataclasses.replace(cfg.train, global_batch=1,
                                  log_dir=str(tmp_path), summary_interval=1))
    trace.reset()
    with trace.enabled():
        final = train(cfg, max_steps=3, device="cpu", capture=True)
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["graph_captures"], r["graph_replays"]) for r in recs] == [
        (0, 0), (1, 0), (1, 1)]
    assert (final["graph_captures"], final["graph_replays"]) == (1, 1)
    assert [r.name for r in trace.records() if r.parent < 0] == [
        "trainer.feed", "train_step"] * 3
    assert "device_batcher" in trace.totals("trainer.feed")[0]
    assert {"train_step.schedule", "capture.replay"} <= set(
        trace.totals("train_step")[-1])
    trace.reset()


# ---------------------------------------------------------------------------
# The eval step and the inference forward from static buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["pwcnet", "raft"])
def test_captured_eval_and_inference_equal_eager(emulated, one_thread,
                                                 family):
    """``evaluate_dataset`` (two batch shapes: the synthetic samples' and a
    second size), ``predict_flow`` and ``match_two_view`` give the same
    numbers captured and eager; each model's graphs are its own, one
    entry per padded shape."""
    model = make_model(family, **FAMILY_KW[family])
    ds = SyntheticFlow(length=3, hw=HW, split="val")
    rows = {c: evaluate_dataset(model, ds, batch=2, capture=c,
                                return_per_sample=True)
            for c in (False, True)}
    assert rows[True][0] == rows[False][0]
    assert torch.equal(rows[True][1], rows[False][1])
    s = ds[0]
    for hw in (HW, (40, 72)):
        im1, im2 = s["im1"][:hw[0], :hw[1]], s["im2"][:hw[0], :hw[1]]
        assert np.array_equal(predict_flow(model, im1, im2, capture=True),
                              predict_flow(model, im1, im2, capture=False))
    got = match_two_view(model, s["im1"], s["im2"], capture=True)
    want = match_two_view(model, s["im1"], s["im2"], capture=False)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    per = capture_mod._BY_MODEL[model]
    assert len(per["eval step"].entries) == 1
    # batch 1 at two padded shapes, and the front-end's batch of two
    assert len(per["inference forward"].entries) == 3


def test_captured_outputs_are_fresh_tensors(emulated):
    """A replay's outputs are clones: a kept result survives the next
    call (``evaluate_dataset`` keeps every batch's per-sample rows)."""
    model = make_model("pwcnet", **SMALL)
    a, b = (torch.rand((1, *HW, 3), generator=torch.Generator().manual_seed(
        s)) for s in (1, 2))
    first = infer_flow(model, a, b, capture=True)
    kept = first.clone()
    second = infer_flow(model, b, a, capture=True)
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)


# ---------------------------------------------------------------------------
# The cache key, the model's cache
# ---------------------------------------------------------------------------

def test_signature_separates_shapes_dtypes_static_args_and_models():
    model = make_model("pwcnet", **SMALL)
    x = torch.zeros((1, *HW, 3))
    base = signature(model, x, x, train=False)
    assert signature(model, x.clone(), torch.ones_like(x), train=False) \
        == base
    different = {
        "shape": signature(model, x, torch.zeros((2, *HW, 3)), train=False),
        "dtype": signature(model, x, x.double(), train=False),
        "static": signature(model, x, x, train=True),
        "kwarg": signature(model, x, x),
        "positional": signature(model, x, x, False),
        "rebuilt": signature(make_model("pwcnet", **SMALL), x, x, train=False),
    }
    with torch.no_grad():
        different["grad_mode"] = signature(model, x, x, train=False)
    with torch.inference_mode():
        different["inference"] = signature(model, x, x, train=False)
    keys = list(different.values())
    assert base not in keys and len(set(keys)) == len(keys), different
    # load_state_dict copies in place: the same key. A moved parameter
    # (new storage, as .to() gives) is a new key.
    model.load_state_dict(make_model("pwcnet", 1, **SMALL).state_dict())
    assert signature(model, x, x, train=False) == base
    p = next(model.parameters())
    p.data = p.data.clone()
    assert signature(model, x, x, train=False) != base
    with pytest.raises(TypeError, match="hashable"):
        signature(model, x, np.zeros(2))
    assert signature(x, [1, (2, "a")]) == signature(x, [1, (2, "a")])


def test_model_cache_lives_with_the_model(emulated):
    """A model's graphs go with the model, also after it ran through the
    captured inference forward and eval step: an entry holds its module
    argument weakly."""
    model = make_model("pwcnet", **SMALL)
    f = lambda m, a: a  # noqa: E731
    c = model_captured(model, "f", f)
    assert model_captured(model, "f", f) is c
    assert model_captured(make_model("pwcnet", **SMALL), "f", f) is not c
    x = torch.rand((1, *HW, 3), generator=torch.Generator().manual_seed(0))
    infer_flow(model, x, x, capture=True)
    make_eval_step(model, capture=True)(to_torch(random_batch(
        np.random.default_rng(0), 1, HW, 0.2)))
    per = capture_mod._BY_MODEL[model]
    assert len(per["inference forward"].entries) == 1
    assert len(per["eval step"].entries) == 1
    gone = weakref.ref(model)
    n = len(capture_mod._BY_MODEL)
    del model, per, c
    gc.collect()
    assert gone() is None
    assert len(capture_mod._BY_MODEL) < n


def test_make_capturable_leaves_cpu_optimizers_alone():
    """``capturable`` is CUDA-only: on CPU parameters ``make_capturable``
    changes nothing, and an eager step never calls it."""
    model = make_model("pwcnet", **SMALL)
    opt, _ = make_optimizer(model.parameters(), ScheduleConfig(**SCHEDULE))
    before = copy.deepcopy(opt.state_dict())
    make_capturable(opt)
    assert opt.state_dict()["param_groups"] == before["param_groups"]
    g = opt.param_groups[0]
    assert g["capturable"] is False and isinstance(g["lr"], float)


# ---------------------------------------------------------------------------
# Optimizer state across devices
# ---------------------------------------------------------------------------

# The card keeps the rate as an f32 tensor, and a CPU optimizer loading
# the card's state steps with that f32 value: with a rate exact in f32
# the two loads step alike bit for bit.
F32_SCHEDULE = dict(SCHEDULE, base_lr=2.0 ** -13)


def _opt_after_a_step(seed=0):
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.linspace(-1, 1, p.numel()).view_as(p) + i)
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**F32_SCHEDULE))
    _grad(model, seed)
    opt.step()
    sched.step()
    return model, opt, sched


def _grad(model, seed):
    gen = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)


def _card_format(sd):
    """The state dict a capturable optimizer writes on the card, as
    ``torch.load(map_location="cpu")`` reads it: ``capturable``, a tensor
    ``lr``, float32 ``step`` tensors."""
    sd = copy.deepcopy(sd)
    for g in sd["param_groups"]:
        g["capturable"] = True
        g["lr"] = torch.tensor(g["lr"])
    for st in sd["state"].values():
        st["step"] = st["step"].float()
    return sd


def test_card_optimizer_state_loads_and_steps_on_the_cpu():
    model, opt, _ = _opt_after_a_step()
    sd = opt.state_dict()
    stepped = []
    for saved in (sd, _card_format(sd)):
        m2, opt2, _ = _opt_after_a_step(seed=9)
        m2.load_state_dict(model.state_dict())
        load_optimizer_state(opt2, saved)
        g = opt2.param_groups[0]
        assert g["capturable"] is False and isinstance(g["lr"], float)
        assert not any(t.is_cuda for st in opt2.state.values()
                       for t in st.values())
        _grad(m2, seed=4)
        opt2.step()
        stepped.append([p.detach().clone() for p in m2.parameters()])
    for a, b in zip(*stepped):
        assert torch.equal(a, b)


def test_cpu_optimizer_state_loads_into_a_card_optimizer():
    """The other direction, into an optimizer built as on the card
    (``capturable``, a tensor lr; it cannot step on the CPU): the target
    keeps its own options and its tensors, filled in place."""
    _, opt, sched = _opt_after_a_step()
    sd = opt.state_dict()
    model = torch.nn.Linear(4, 3)
    lr = torch.tensor(1.0)
    target = torch.optim.AdamW(model.parameters(), lr=lr, capturable=True)
    moments = {}
    for p in model.parameters():
        target.state[p] = {"step": torch.tensor(5.0),
                           "exp_avg": torch.zeros_like(p),
                           "exp_avg_sq": torch.zeros_like(p)}
        moments[p] = dict(target.state[p])
    load_optimizer_state(target, sd)
    g = target.param_groups[0]
    assert g["capturable"] is True and g["lr"] is lr
    assert float(lr) == sd["param_groups"][0]["lr"]
    assert isinstance(g["initial_lr"], float)
    for p, q in zip(model.parameters(), opt.param_groups[0]["params"]):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert target.state[p][k] is moments[p][k]
            assert torch.equal(target.state[p][k].float(),
                               opt.state[q][k].float())
        assert target.state[p]["step"].dtype == torch.float32


def test_train_state_restores_a_card_checkpoint_on_the_cpu(tmp_path):
    model, opt, sched = _opt_after_a_step()
    state = TrainState.create(model, opt, sched, seed=1)
    sd = state.state_dict()
    sd["optimizer"] = _card_format(sd["optimizer"])
    torch.save(sd, tmp_path / "step.pt")
    m2, opt2, sched2 = _opt_after_a_step(seed=9)
    fresh = TrainState.create(m2, opt2, sched2, seed=2)
    fresh.load_state_dict(torch.load(tmp_path / "step.pt",
                                     weights_only=True))
    assert fresh.optimizer.param_groups[0]["capturable"] is False
    for p, q in zip(m2.parameters(), model.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh.optimizer.state[p][k],
                               opt.state[q][k])


# ---------------------------------------------------------------------------
# capture=True without a card
# ---------------------------------------------------------------------------

def _entry_points():
    model = make_model("pwcnet", **SMALL)
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(**SCHEDULE))
    x = np.zeros((*HW, 3), np.float32)
    t = torch.zeros((1, *HW, 3))
    return {
        "train_step": lambda: make_train_step(model, opt, sched,
                                              capture=True),
        "eval_step": lambda: make_eval_step(model, capture=True),
        "predict_flow": lambda: predict_flow(model, x, x, capture=True),
        "infer_flow": lambda: infer_flow(model, t, t, capture=True),
        "match_two_view": lambda: match_two_view(model, x, x,
                                                 capture=True),
        "captured": lambda: Captured(lambda a: a * 2)(t),
    }


@pytest.mark.parametrize("name", ["captured", "eval_step", "infer_flow",
                                  "match_two_view", "predict_flow",
                                  "train_step"])
def test_capture_on_the_cpu_raises(name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_capture_is_off_by_default_on_the_cpu_and_under_a_mesh():
    assert capture_mod.capture_enabled(None, "cpu") is False
    assert capture_mod.capture_enabled(False, "cpu") is False
    assert capture_mod.capture_enabled(None, "cuda", distributed=True) \
        is False
    assert capture_mod.capture_enabled(None, "cuda") is True
    with pytest.raises(ValueError, match="eagerly"):
        capture_mod.capture_enabled(True, "cuda", distributed=True)


def test_debug_nans_with_capture_is_refused(tmp_path):
    from pwcnet_tpu_torch.config import PRESETS
    from pwcnet_tpu_torch.train.loop import train
    cfg = PRESETS["synthetic-proof"]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, debug_nans=True, log_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="debug_nans"):
        train(cfg, max_steps=1, device="cpu", capture=True)


# ---------------------------------------------------------------------------
# On a card: a replay equals the eager step and forward
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """The card, with deterministic algorithms while the test runs: two
    eager train steps differ under cuDNN's deterministic mode alone (the
    gathers' and the resize's backward add atomically)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pwcnet", "raft"])
def test_cuda_replayed_train_step_equals_eager(card, family):
    """Four steps, captured and eager, bit for bit; the eager step takes
    the captured one's optimizer arithmetic (``make_capturable``), so that
    the capture alone is compared."""
    dev = card
    runs = []
    for capture in (False, True):
        gen = torch.Generator().manual_seed(0)
        model = (RAFT(num_iters=2, device=dev, generator=gen)
                 if family == "raft" else PWCNet(device=dev, generator=gen))
        opt, sched = make_optimizer(model.parameters(),
                                    ScheduleConfig(**SCHEDULE))
        if not capture:
            make_capturable(opt)
        step = make_train_step(
            model, opt, sched, capture=capture,
            loss_kind="sequence" if family == "raft" else "multiscale",
            aug=AugmentConfig(crop_hw=(128, 192)))
        state = TrainState.create(model, opt, sched, seed=3)
        ms = []
        for i in range(4):
            b = {k: v.to(dev) for k, v in to_torch(random_batch(
                np.random.default_rng(i), 2, (192, 256), 0.2)).items()}
            state, m = step(state, b)
            ms.append({k: float(v) for k, v in m.items()})
        runs.append((ms, [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pwcnet", "raft"])
def test_cuda_replayed_forward_equals_eager(card, family):
    dev = card
    model = (RAFT(device=dev, dtype=torch.bfloat16) if family == "raft"
             else PWCNet(device=dev, dtype=torch.bfloat16))
    gen = torch.Generator().manual_seed(1)
    a, b = (torch.rand((1, 448, 1024, 3), generator=gen).to(dev)
            for _ in range(2))
    for x, y in ((a, b), (b, a), (a, b)):
        assert torch.equal(infer_flow(model, x, y, capture=True),
                           infer_flow(model, x, y, capture=False))


@pytest.mark.cuda
def test_cuda_only_a_captured_step_makes_the_optimizer_capturable(card):
    """An eager step keeps torch's default Adam (a float rate, ``step`` on
    the host); a captured one makes it ``capturable`` with a device rate,
    which the scheduler fills between replays."""
    dev = card
    forms = {}
    for capture in (False, None):
        model = PWCNet(device=dev, generator=torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(model.parameters(),
                                    ScheduleConfig(**SCHEDULE))
        step = make_train_step(model, opt, sched, capture=capture)
        state = TrainState.create(model, opt, sched, seed=3)
        for i in range(3):
            b = {k: v.to(dev) for k, v in to_torch(random_batch(
                np.random.default_rng(i), 2, (128, 192), 0.2)).items()}
            state, _ = step(state, b)
        g = opt.param_groups[0]
        st = opt.state[g["params"][0]]
        forms[capture] = (g["capturable"], torch.is_tensor(g["lr"]),
                          st["step"].device.type)
        # SCHEDULE halves the rate from the update with count 2 on.
        assert float(g["lr"]) == pytest.approx(0.5e-4, rel=1e-6)
    assert forms[False] == (False, False, "cpu")
    assert forms[None] == (True, True, "cuda")
