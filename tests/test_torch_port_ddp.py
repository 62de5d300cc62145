"""The port's data parallelism (``DistributedDataParallel`` over a
grid's data axis) held against one process and against the JAX package's
2-device mesh step, on the CPU.

The ranks are two ``gloo`` worker processes
(``pwcnet_tpu_torch.parallel.launch.run_ranks``, one torch thread each),
started once with every data-parallel task in one job; one more job of two
ranks shows that ``nccl`` refuses two ranks on one card. The JAX side runs
on the fake 8-device CPU mesh of ``tests/conftest.py``.

Tolerances: loss ``rtol=1e-5`` and parameters ``rtol=2e-4, atol=2e-6``,
those of ``tests/test_dist.py``. Parameters after two AdamW steps are held
to them entry by entry at ``PARAM_SHARE`` of the entries: an entry whose
gradient is within rounding of 0 takes an Adam step of about +-lr whose
sign the gradient's last bits decide, and the second step's gradients then
move where a LeakyReLU input crossed 0. Of the 1,812,376 entries of this
PWC-Net, two steps leave outside those tolerances: 29 between JAX's own
2-device and one-device steps, 23 between the port's two ranks and one
process, 1015 between the port's two ranks and JAX's 2-device step (all
measured; RAFT's and the augmented step's: none). Every entry stays within
``UPDATE_BOUND`` of the other side.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.parallel import MeshConfig as JaxMeshConfig
from pwcnet_tpu.parallel import make_mesh as jax_make_mesh
from pwcnet_tpu.parallel import replicated as jax_replicated
from pwcnet_tpu.parallel import shard_batch as jax_shard_batch
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
from pwcnet_tpu_torch.compat.flax_weights import _flatten, load_flax_params
from pwcnet_tpu_torch.config import PRESETS, AugmentConfig
from pwcnet_tpu_torch.data.augment import (augment_batch, draw_augment_params,
                                           fold_in)
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow, make_device_batcher
from pwcnet_tpu_torch.parallel import mesh as mesh_mod
from pwcnet_tpu_torch.parallel import (GridMesh, MeshConfig,
                                       initialize_distributed,
                                       local_batch_size, make_mesh,
                                       shard_batch)
from pwcnet_tpu_torch.parallel.launch import run_ranks, run_steps
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
from pwcnet_tpu_torch.train.loop import _log_idle_cards, build_model, train

from torch_port_util import jax_tree_to_port, one_thread, params_agree

WORLD = 2
HW = (64, 64)
BATCH = 4  # global: 2 rows a rank
LR = 1e-4
PARAM_SHARE = 0.999
UPDATE_BOUND = 4 * LR  # two Adam steps of at most ~lr each, either sign
LOSS_RTOL = 1e-5
WORKER_TIMEOUT_S = 240
AUG = AugmentConfig(crop_hw=(48, 48))


def _cfg(family="pwcnet", log_dir="unused", **train_kw):
    """synthetic-proof in f32 at 64x64: PWC-Net with 3 levels (as
    tests/test_dist.py's model) or RAFT with 2 iterations; AdamW at 1e-4
    without weight decay."""
    cfg = PRESETS["synthetic-proof"]
    model = dataclasses.replace(cfg.model, dtype="float32")
    if family == "raft":
        model = dataclasses.replace(model, family="raft", raft_iters=2)
    else:
        model = dataclasses.replace(model, num_levels=3, output_level=2,
                                    search_range=2)
    return dataclasses.replace(
        cfg, model=model,
        data=dataclasses.replace(cfg.data, sample_hw=HW, augment=dataclasses
                                 .replace(cfg.data.augment, crop_hw=HW)),
        train=dataclasses.replace(
            cfg.train, loss="sequence" if family == "raft" else "multiscale",
            weight_decay=0.0, global_batch=BATCH, log_dir=str(log_dir),
            summary_interval=1, **train_kw))


def _batches(n_steps, first=0):
    ds = SyntheticFlow(split="train", hw=HW)
    out = []
    for s in range(n_steps):
        rows = [ds[first + BATCH * s + i] for i in range(BATCH)]
        out.append({k: torch.from_numpy(np.stack([r[k] for r in rows]))
                    for k in ("im1", "im2", "flow", "valid")})
    return out


@pytest.fixture(scope="module")
def setup(one_thread):
    """Initial weights (JAX's init for PWC-Net, the port's for RAFT), the
    global batches, and the by-hand augmented batch of the augmentation
    case: rank r's rows augmented on fold_in(the state's generator, r)."""
    jm = JaxPWCNet(num_levels=3, output_level=2, search_range=2,
                   corr_backend="lax")
    batches = _batches(2)
    b0 = {k: v.numpy() for k, v in batches[0].items()}
    jparams = jax.device_get(jax.jit(jm.init)(
        jax.random.key(0), b0["im1"][:1], b0["im2"][:1]))
    pwc = build_model(_cfg(), "cpu")
    load_flax_params(pwc, jparams["params"])
    raft_sd = build_model(_cfg("raft"), "cpu").state_dict()
    aug_cfg = dataclasses.replace(_cfg(), data=dataclasses.replace(
        _cfg().data, augment=AUG))
    seed = aug_cfg.train.seed + 1  # the TrainState's generator
    rows = [augment_batch(shard_batch(_fake_mesh(r), batches[0]),
                          fold_in(torch.Generator().manual_seed(seed), r),
                          AUG) for r in range(WORLD)]
    by_hand = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    return dict(jm=jm, jparams=jparams, pwc_sd=pwc.state_dict(),
                raft_sd=raft_sd, batches=batches, aug_cfg=aug_cfg,
                by_hand=by_hand)


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """One job of WORLD gloo ranks: PWC-Net 2 steps, RAFT 1 step, PWC-Net
    1 augmented step, train() 2 steps from scratch, train() resuming a
    one-process checkpoint, evaluate_dataset, the data mesh itself."""
    root = tmp_path_factory.mktemp("ddp")
    resumed = root / "resumed"
    train(_cfg(log_dir=resumed, checkpoint_interval=1), max_steps=1,
          device="cpu")
    tasks = [
        dict(kind="step", cfg=_cfg(), state_dict=setup["pwc_sd"],
             batches=setup["batches"]),
        dict(kind="step", cfg=_cfg("raft"), state_dict=setup["raft_sd"],
             batches=setup["batches"][:1]),
        dict(kind="step", cfg=setup["aug_cfg"], state_dict=setup["pwc_sd"],
             batches=setup["batches"][:1], aug=True),
        dict(kind="train", cfg=_cfg(log_dir=root / "run",
                                    checkpoint_interval=2), max_steps=2),
        dict(kind="train", cfg=_cfg(log_dir=resumed), max_steps=1,
             digest=True),
        dict(kind="eval", cfg=_cfg(), state_dict=setup["pwc_sd"],
             dataset=SyntheticFlow(split="val", hw=HW), batch=2, limit=4),
        dict(kind="mesh"),
    ]
    res = run_ranks(WORLD, dict(backend="gloo", device="cpu", threads=1,
                                tasks=tasks), str(root / "job"),
                    timeout=WORKER_TIMEOUT_S)
    names = ("pwc", "raft", "aug", "train", "resumed", "eval", "mesh")
    return {name: [r[i] for r in res] for i, name in enumerate(names)}, root


def test_the_data_mesh_of_two_ranks(ranks):
    res, _ = ranks
    assert [m["rank"] for m in res["mesh"]] == [0, 1]
    assert {(m["size"], m["device"], m["backend"]) for m in res["mesh"]} \
        == {(2, "cpu", "gloo")}


@pytest.mark.parametrize("case", ["pwc", "raft", "aug", "train"])
def test_ranks_end_bit_identical(ranks, case):
    res, _ = ranks
    a, b = (r["params"] for r in res[case])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if case != "train":
        assert [r["metrics"] for r in res[case]][0] == res[case][1][
            "metrics"]
        assert torch.equal(res[case][0]["generator"],
                           res[case][1]["generator"])


@pytest.mark.parametrize("family", ["pwc", "raft"])
def test_two_ranks_equal_one_process(setup, ranks, family):
    """The same global batches, the same weights: one process on the whole
    batch against two ranks on their halves."""
    res, _ = ranks
    cfg, sd, n = ((_cfg(), setup["pwc_sd"], 2) if family == "pwc"
                  else (_cfg("raft"), setup["raft_sd"], 1))
    one = run_steps(cfg, sd, setup["batches"][:n])
    got = res[family][0]
    assert len(got["metrics"]) == n
    for g, w in zip(got["metrics"], one["metrics"]):
        assert abs(g["loss"] - w["loss"]) <= LOSS_RTOL * abs(w["loss"])
    # The first step's averaged gradients, as the one-step check of
    # tests/test_torch_port_train.py holds them against JAX's.
    errs = {k: (got["grads"][0][k] - w).abs().max().item()
            / w.abs().max().item() for k, w in one["grads"][0].items()}
    assert max(errs.values()) <= 1e-4, max(errs.values())
    params_agree(got["params"], one["params"], PARAM_SHARE, UPDATE_BOUND)


def test_two_ranks_equal_jax_mesh_step(setup, ranks):
    """JAX's make_train_step on a 2-device data mesh from the same flax
    params, the same optimizer (AdamW 1e-4, no decay) and batches."""
    res, _ = ranks
    tx = jax_optimizer(JaxSchedule(base_lr=LR), weight_decay=0.0)
    mesh = jax_make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    state = jax.device_put(JaxTrainState.create(
        jax.tree.map(jnp.asarray, setup["jparams"]), tx, jax.random.key(1)),
        jax_replicated(mesh))
    step = jax_train_step(setup["jm"], tx, aug=None, mesh=mesh)
    jmetrics = []
    for b in setup["batches"]:
        state, m = step(state, jax_shard_batch(
            mesh, {k: v.numpy() for k, v in b.items()}))
        jmetrics.append(float(m["loss"]))
    got = res["pwc"][0]
    for g, w in zip(got["metrics"], jmetrics):
        assert abs(g["loss"] - w) <= LOSS_RTOL * abs(w)
    want = jax_tree_to_port(_flatten(jax.device_get(state.params)[
        "params"]))
    assert want.keys() == got["params"].keys()
    params_agree(got["params"], want, PARAM_SHARE, UPDATE_BOUND)


def test_augmentation_is_folded_per_rank(setup, ranks):
    """Two ranks with augmentation on equal one process stepping without
    augmentation on the batch augmented by hand, rank r's rows on
    fold_in(the state's generator, r); the two ranks' draws differ, and
    each rank's generator advanced by the one shared draw."""
    res, _ = ranks
    one = run_steps(setup["aug_cfg"], setup["pwc_sd"], [setup["by_hand"]])
    got = res["aug"][0]
    assert abs(got["metrics"][0]["loss"] - one["metrics"][0]["loss"]) \
        <= LOSS_RTOL * abs(one["metrics"][0]["loss"])
    params_agree(got["params"], one["params"], PARAM_SHARE, UPDATE_BOUND)
    seed = setup["aug_cfg"].train.seed + 1
    draws = [draw_augment_params(fold_in(torch.Generator().manual_seed(
        seed), r), 2, HW, AUG) for r in range(WORLD)]
    assert not torch.equal(draws[0][0], draws[1][0])
    assert draws[0][1] != draws[1][1]
    shared = torch.Generator().manual_seed(seed)
    torch.randint(0, 2 ** 62, (1,), generator=shared)
    assert torch.equal(got["generator"], shared.get_state())


def test_one_process_augments_as_before(setup, one_thread):
    """Without a mesh the step draws on the state's generator itself, as
    it did before data parallelism: bit for bit the unaugmented step on
    augment_batch(batch, that generator)."""
    cfg = setup["aug_cfg"]
    b = setup["batches"][0]
    by_hand = augment_batch(b, torch.Generator().manual_seed(
        cfg.train.seed + 1), AUG)
    got = run_steps(cfg, setup["pwc_sd"], [b], aug=True)
    want = run_steps(cfg, setup["pwc_sd"], [by_hand])
    assert got["metrics"] == want["metrics"]
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k


def test_rank_0_alone_writes_and_one_process_resumes(ranks, one_thread):
    """train() on two ranks: process 0 alone writes metrics.jsonl and the
    checkpoint, whose keys are the model's own (no DDP "module." prefix);
    one process resumes from it with the ranks' weights."""
    res, root = ranks
    run = root / "run"
    assert [r["final"]["step"] for r in res["train"]] == [2, 2]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    ckpt = CheckpointManager(str(run / "ckpt"))
    assert ckpt.steps() == [2]
    saved = ckpt.load()["model"]
    assert not any(k.startswith("module.") for k in saved)
    for k, v in res["train"][0]["params"].items():
        assert torch.equal(saved[k], v), k
    final = train(_cfg(log_dir=run), max_steps=1, device="cpu")
    assert final["step"] == 3 and np.isfinite(final["loss"])


def test_two_ranks_resume_a_one_process_checkpoint(ranks):
    res, _ = ranks
    assert [r["final"]["step"] for r in res["resumed"]] == [2, 2]
    assert res["resumed"][0]["params"] == res["resumed"][1]["params"]
    assert len(res["resumed"][0]["params"]) == 64  # a SHA-256 in hex


def test_evaluate_dataset_on_two_ranks_equals_one_process(setup, ranks,
                                                         one_thread):
    res, _ = ranks
    model = build_model(_cfg(), "cpu").eval()
    model.load_state_dict(setup["pwc_sd"])
    want = evaluate_dataset(model, SyntheticFlow(split="val", hw=HW),
                            batch=2, limit=4)
    for got in res["eval"]:
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got[k], w)


def _fake_mesh(rank):
    """A data mesh of WORLD ranks without a process group: enough for what
    reads only the rank and the size."""
    return GridMesh.line(0, None, rank, WORLD, "cpu", "gloo")


def test_shard_batch_and_local_batch_size():
    b = {"x": np.arange(8), "y": torch.arange(16).view(8, 2)}
    parts = [shard_batch(_fake_mesh(r), b) for r in range(WORLD)]
    assert [p["x"].tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert torch.equal(torch.cat([p["y"] for p in parts]), b["y"])
    assert shard_batch(None, b) is b
    assert local_batch_size(8, _fake_mesh(0)) == 4
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(7, _fake_mesh(0))


def test_device_batcher_rows_make_the_global_batch():
    whole = make_device_batcher(4, (32, 32), device="cpu")(3)
    parts = [make_device_batcher(4, (32, 32), device="cpu",
                                 mesh=_fake_mesh(r))(3) for r in range(WORLD)]
    for k, v in whole.items():
        assert torch.equal(torch.cat([p[k] for p in parts]), v), k


def test_eval_batch_must_divide_over_the_ranks():
    model = build_model(_cfg(), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        evaluate_dataset(model, SyntheticFlow(split="val", hw=HW), batch=3,
                         mesh=_fake_mesh(0))


def test_nccl_refuses_two_ranks_on_one_card(tmp_path):
    """Two ranks that both name cuda:0 under nccl raise, naming gloo,
    before any NCCL communicator exists (the exchange of places runs over
    gloo, so this runs on a machine without a card)."""
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        run_ranks(WORLD, dict(backend="gloo", device="cpu", threads=1,
                              tasks=[dict(kind="mesh", backend="nccl",
                                          device="cuda:0")]),
                  str(tmp_path), timeout=WORKER_TIMEOUT_S)
    with pytest.raises(ValueError, match="CUDA device per rank.*gloo"):
        mesh_mod._one_card_per_rank(torch.device("cpu"), WORLD)


def test_mesh_and_process_group_arguments(monkeypatch):
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(MeshConfig(data=2), backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh(MeshConfig(data=2, spatial=2), backend="gloo",
                  device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(None, 2, None)
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("localhost:1", 2, 0, backend="mpi")
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(mesh_mod.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    initialize_distributed(backend="gloo")
    assert calls == [(("gloo",), {"init_method": "env://"})]


def test_a_lone_process_says_how_to_use_idle_cards(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    lone = mesh_mod.GridMesh(None, 0, 1, torch.device("cuda", 0), None)
    with caplog.at_level(logging.WARNING):
        _log_idle_cards(_cfg(), lone)
    assert "leaves 3 of this machine's 4 cards idle" in caplog.text
    assert "--nproc_per_node=4" in caplog.text
