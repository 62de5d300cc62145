"""The port's (data, spatial, model) grid and its differentiable spatial
path held against the JAX package, on the CPU.

The ranks are ``gloo`` worker processes
(``pwcnet_tpu_torch.parallel.launch.run_ranks``, one torch thread each):
one job of four ranks and one of two carry every task. The JAX side runs
on the fake 8-device CPU mesh of ``tests/conftest.py``.

Tolerances (relative max errors, ``max|got - ref| <= tol * max|ref|``
unless stated): the exchange's gradient 1e-6 (sums of a few values); the
halo island's gradients JAX's own ``rtol=1e-4, atol=1e-5``
(``tests/test_halo.py``); the sharded model's gradients 1e-4 per tensor,
or, in the cases that ``GRAD_RULE`` names, ``3 x floor``: the floor is the
port's unsharded change of the same gradients when frame 1 is scaled by
1 + 1e-6 * N(0, 1) (three draws), the rule of ``chip_smoke.py``
(LeakyReLU's gradient jumps at inputs within rounding of 0, and the
sharded convolutions sum in another order), or when its CPU ops run on
other thread counts (the sums' order alone). Flows
1e-4 per level. Train steps: the loss ``rtol=1e-5`` and the parameters
``tests/test_torch_port_ddp.py``'s ``PARAM_SHARE`` / ``UPDATE_BOUND``
rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.ops.resize import resize_bilinear as jax_resize
from pwcnet_tpu.parallel import MeshConfig as JaxMeshConfig
from pwcnet_tpu.parallel import SPATIAL_AXIS as JAX_AXIS
from pwcnet_tpu.parallel import exchange_halo as jax_exchange_halo
from pwcnet_tpu.parallel import make_mesh as jax_make_mesh
from pwcnet_tpu.parallel import replicated as jax_replicated
from pwcnet_tpu.parallel import shard_batch as jax_shard_batch
from pwcnet_tpu.parallel import warp_corr_spatial as jax_warp_corr_spatial
from pwcnet_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from pwcnet_tpu.train.schedule import ScheduleConfig as JaxSchedule
from pwcnet_tpu.train.schedule import make_optimizer as jax_optimizer
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import _flatten, load_flax_params
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.data.pipeline import Loader
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow, make_device_batcher
from pwcnet_tpu_torch.parallel import GridMesh, shard_batch
from pwcnet_tpu_torch.parallel.launch import run_ranks
from pwcnet_tpu_torch.parallel.mesh import grid_ranks
from pwcnet_tpu_torch.parallel.spatial_ops import upsample2x_block
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
from pwcnet_tpu_torch.train.loop import build_model, train_with_state
from pwcnet_tpu_torch.train.schedule import optimizer_from_config
from pwcnet_tpu_torch.train.state import TrainState

from torch_port_util import (ext_rows, jax_sharded, jax_tree_to_port,
                             one_thread, params_agree, rel_err, to_torch,
                             torch_threads)

TOL = 1e-4
FLOOR_FACTOR = 3.0
ORDER_THREADS = (2, 4, 8)
HW = (64, 48)       # the images of the gradient and forward cases
SMALL = dict(num_levels=3, output_level=2, search_range=2)
TRAIN_HW = (64, 64)
BATCH = 4           # global: 2 rows a data index
LR = 1e-4
PARAM_SHARE = 0.999
UPDATE_BOUND = 4 * LR
LOSS_RTOL = 1e-5
WORKER_TIMEOUT_S = 300
GRID = dict(data=2, spatial=2)
# (name, mesh of the grad task, PWCNet options); "s2" cases run on the 2x2
# grid, each data row its own S = 2 sharded forward.
GRAD_CASES = {
    "s4": (dict(data=1, spatial=4), dict(corr_backend="pallas")),
    "s2": (GRID, dict(corr_backend="pallas")),
    "s2_fused": (GRID, dict(corr_backend="fused", fused_min_pixels=0)),
    "s2_norm": (GRID, dict(corr_backend="pallas", use_norm=True)),
    "s2_input_norm": (GRID, dict(corr_backend="pallas", input_norm=True)),
}
# A planted fault for the gradient gate's control: every exchange with the
# rows it receives detached (chip_smoke.py's, imported on the ranks by the
# launcher's "patch" option).
HALO_GRAD_DROPPED = {
    f"pwcnet_tpu_torch.parallel.{m}.exchange_rows":
    "chip_smoke.exchange_rows_halo_grad_dropped"
    for m in ("halo", "spatial_ops")}
# The exchange cases of tests/test_halo.py: halo 2 on 4-row shards, and
# halo 5 on 2-row shards (three hops).
EXCHANGES = ((16, 2), (8, 5))
WARP_BACKENDS = ("lax", "pallas", "fused")
pytestmark = pytest.mark.usefixtures("one_thread")


def _train_cfg(log_dir, family="pwcnet", init_from=None, **parallel):
    """synthetic-proof in f32 at 64x64 (PWC-Net with 3 levels, or RAFT
    with 2 iterations), AdamW at 1e-4 without weight decay, a summary every
    step: tests/test_torch_port_ddp.py's configuration, on a grid."""
    cfg = PRESETS["synthetic-proof"]
    model = dataclasses.replace(cfg.model, dtype="float32")
    if family == "raft":
        model = dataclasses.replace(model, family="raft", raft_iters=2)
    else:
        model = dataclasses.replace(model, **SMALL)
    return dataclasses.replace(
        cfg, model=model,
        data=dataclasses.replace(
            cfg.data, sample_hw=TRAIN_HW,
            augment=dataclasses.replace(cfg.data.augment,
                                        crop_hw=TRAIN_HW)),
        parallel=dataclasses.replace(cfg.parallel, **parallel),
        train=dataclasses.replace(
            cfg.train, loss="sequence" if family == "raft" else "multiscale",
            weight_decay=0.0, global_batch=BATCH, log_dir=str(log_dir),
            summary_interval=1, init_from=init_from))


def _loader_cfg(log_dir, **parallel):
    """The same on the host Loader's batches, augmented in the step."""
    cfg = _train_cfg(log_dir, **parallel)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_gen=False))


@pytest.fixture(scope="module")
def draws():
    """The exchange cases' inputs and cotangents, and the halo island's
    f1, f2 and flow (1x16x12x4, as tests/test_halo.py's)."""
    rng = np.random.default_rng(1)
    out = {}
    for h, halo in EXCHANGES:
        out[h] = (rng.standard_normal((1, h, 3, 2)).astype(np.float32),
                  rng.standard_normal((1, h + 8 * halo, 3, 2)).astype(
                      np.float32))
    out["warp"] = [rng.standard_normal(shape).astype(np.float32) for shape
                   in ((1, 16, 12, 4), (1, 16, 12, 4), (1, 16, 12, 2))]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs from numpy seeds, flax params (plain and use_norm), their
    port state dicts, and a port checkpoint of the plain 64x64 train model
    made from JAX's init (``train.init_from`` of the train cases)."""
    rng = np.random.default_rng(0)
    im1 = rng.random((1, *HW, 3), np.float32)
    im2 = rng.random((1, *HW, 3), np.float32)
    params, sds = {}, {}
    for name, norm in (("plain", False), ("norm", True)):
        jm = JaxPWCNet(corr_backend="lax", use_norm=norm, **SMALL)
        params[name] = jax.device_get(
            jax.jit(jm.init)(jax.random.key(0), im1, im2))["params"]
        model = PWCNet(device="cpu", use_norm=norm, **SMALL)
        load_flax_params(model, params[name])
        sds[name] = model.state_dict()
    root = tmp_path_factory.mktemp("grid")
    jm = JaxPWCNet(corr_backend="lax", **SMALL)
    batches = [make_device_batcher(BATCH, TRAIN_HW, seed=_train_cfg(
        "-").train.seed, device="cpu")(s) for s in range(2)]
    jtrain = jax.device_get(jax.jit(jm.init)(
        jax.random.key(1), batches[0]["im1"][:1].numpy(),
        batches[0]["im2"][:1].numpy()))
    cfg = _train_cfg(root / "init")
    model = build_model(cfg, "cpu")
    load_flax_params(model, jtrain["params"])
    opt, sched = optimizer_from_config(model.parameters(), cfg.train)
    CheckpointManager(str(root / "init" / "ckpt")).save(
        TrainState.create(model, opt, sched, seed=1))
    # tests/test_torch_port_ddp.py's step case: JAX's init from key 0 and
    # the synthetic train split's first pairs.
    ds = SyntheticFlow(split="train", hw=TRAIN_HW)
    step_batches = [{k: torch.from_numpy(np.stack([
        ds[BATCH * s + i][k] for i in range(BATCH)]))
        for k in ("im1", "im2", "flow", "valid")} for s in range(2)]
    jstep = jax.device_get(jax.jit(jm.init)(
        jax.random.key(0), step_batches[0]["im1"][:1].numpy(),
        step_batches[0]["im2"][:1].numpy()))
    model = build_model(cfg, "cpu")
    load_flax_params(model, jstep["params"])
    return dict(im1=im1, im2=im2, params=params, sds=sds, root=root,
                jtrain=jtrain, batches=batches,
                init_from=str(root / "init" / "ckpt"), jstep=jstep,
                step_batches=step_batches, step_sd=model.state_dict())


def _grad_case_model(case):
    opts = dict(GRAD_CASES[case][1])
    return "norm" if opts.get("use_norm") else "plain", opts


@pytest.fixture(scope="module")
def world4(setup, draws):
    """One job of four gloo ranks carrying every four-rank task."""
    root = setup["root"]
    tasks = [dict(kind="exchange", x=to_torch(draws[h][0]), top=halo,
                  bottom=halo, grad=to_torch(draws[h][1]))
             for h, halo in EXCHANGES]
    f1, f2, flow = (to_torch(a) for a in draws["warp"])
    for backend in WARP_BACKENDS:
        tasks.append(dict(kind="warp_corr_grad", f1=f1, f2=f2, flow=flow,
                          max_displacement=1, halo_rows=4, backend=backend,
                          fused_min_pixels=0))
    im1, im2 = to_torch(setup["im1"]), to_torch(setup["im2"])
    for case, (mesh, opts) in GRAD_CASES.items():
        name, opts = _grad_case_model(case)
        tasks.append(dict(kind="grad", mesh=mesh, model=dict(SMALL, **opts),
                          state_dict=setup["sds"][name], im1=im1, im2=im2))
    tasks.append(dict(kind="grad", mesh=GRAD_CASES["s4"][0],
                      model=dict(SMALL, **GRAD_CASES["s4"][1]),
                      state_dict=setup["sds"]["plain"], im1=im1, im2=im2,
                      patch=HALO_GRAD_DROPPED))
    for mesh in (GRID, dict(data=1, spatial=4)):
        tasks.append(dict(kind="forward", mesh=mesh,
                          state_dict=setup["sds"]["plain"], im1=im1, im2=im2,
                          model=dict(SMALL, resize_mode="align_corners")))
    tasks += [
        dict(kind="mesh", mesh=GRID),
        dict(kind="train", cfg=_train_cfg(
            root / "grid_train", init_from=setup["init_from"], **GRID),
            max_steps=2),
        dict(kind="train", cfg=_loader_cfg(root / "grid_loader", **GRID),
             max_steps=2),
        dict(kind="step", mesh=GRID, cfg=_train_cfg("-"),
             state_dict=setup["step_sd"], batches=setup["step_batches"]),
        dict(kind="eval", mesh=GRID, cfg=_train_cfg("-"),
             state_dict=_port_train_sd(setup),
             dataset=SyntheticFlow(split="val", hw=TRAIN_HW), batch=2,
             limit=4, per_sample=True),
    ]
    res = run_ranks(4, dict(backend="gloo", device="cpu", threads=1,
                            tasks=tasks), str(root / "job4"),
                    timeout=WORKER_TIMEOUT_S)
    names = ([f"exchange{h}" for h, _ in EXCHANGES]
             + [f"warp_{b}" for b in WARP_BACKENDS]
             + [f"grad_{c}" for c in GRAD_CASES] + ["grad_control"]
             + ["align_grid", "align_s4", "mesh", "train", "loader", "step",
                "eval"])
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


def _port_train_sd(setup):
    model = build_model(_train_cfg("-"), "cpu")
    load_flax_params(model, setup["jtrain"]["params"])
    return model.state_dict()


@pytest.fixture(scope="module")
def world2(setup):
    """One job of two gloo ranks: the model axis, train() on spatial = 2
    (PWC-Net and RAFT), and train() on a data mesh of two on the Loader's
    batches (the 2x2 grid's Loader run without its spatial replicas)."""
    root = setup["root"]
    tasks = [
        dict(kind="mesh", mesh=dict(data=1, spatial=1, model=2)),
        dict(kind="train", cfg=_train_cfg(
            root / "s2_pwc", init_from=setup["init_from"], data=1,
            spatial=2), max_steps=2),
        dict(kind="train", cfg=_train_cfg(root / "s2_raft", "raft", data=1,
                                          spatial=2), max_steps=1),
        dict(kind="train", cfg=_loader_cfg(root / "d2_loader", data=2),
             max_steps=2),
    ]
    res = run_ranks(2, dict(backend="gloo", device="cpu", threads=1,
                            tasks=tasks), str(root / "job2"),
                    timeout=WORKER_TIMEOUT_S)
    names = ("mesh", "pwc", "raft", "loader")
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


# -- (A) the exchange's gradient ---------------------------------------------

@pytest.mark.parametrize("case", range(len(EXCHANGES)))
def test_exchange_rows_gradient_is_jax_transpose(world4, draws, case):
    """Each rank's gradient of its rows for its block of a random cotangent
    equals JAX's ``jax.vjp`` of ``exchange_halo`` under shard_map on four
    devices (halo 2; halo 5 on 2-row shards: three hops), and the hand
    transpose: each global row gets the cotangent of every place it was
    sent to, and the cotangent of the zero rows past the edges goes
    nowhere."""
    h, halo = EXCHANGES[case]
    x, g = draws[h]
    mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=4))
    f = jax.shard_map(lambda a: jax_exchange_halo(a, halo),
                      in_specs=P(None, JAX_AXIS), out_specs=P(None, JAX_AXIS))
    with jax.set_mesh(mesh):
        out, vjp = jax.vjp(jax.jit(f), jax_sharded(mesh, x))
        (want,) = vjp(jax_sharded(mesh, g))
    want = np.asarray(want)
    t, blk = h // 4, h // 4 + 2 * halo
    by_hand = np.zeros_like(x)
    for r in range(4):
        for j in range(blk):
            row = r * t - halo + j
            if 0 <= row < h:
                by_hand[:, row] += g[:, r * blk + j]
    ranks = world4[f"exchange{h}"]
    got = np.concatenate([r["dx"].numpy() for r in ranks], 1)
    assert rel_err(got, want) <= 1e-6
    assert rel_err(got, by_hand) <= 1e-6
    outs = np.concatenate([r["out"].numpy() for r in ranks], 1)
    np.testing.assert_array_equal(outs, np.asarray(out))


# -- (B) the halo island's gradients -----------------------------------------

@pytest.mark.parametrize("backend", WARP_BACKENDS)
def test_warp_corr_spatial_gradients_match_jax(world4, draws, backend):
    """tests/test_halo.py's setup (1x16x12x4, d = 1, halo_rows = 4, S =
    4): the gradients of sum(out**2) w.r.t. f1 and f2 equal JAX's
    ``jax.grad`` of its ``warp_corr_spatial`` with the same backend
    (fused_min_pixels=0), at JAX's tolerance."""
    f1, f2, flow = draws["warp"]
    mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=4))

    def loss(a, b):
        return jnp.sum(jax_warp_corr_spatial(
            a, b, jax_sharded(mesh, flow), max_displacement=1, halo_rows=4,
            backend=backend, fused_min_pixels=0) ** 2)

    with jax.set_mesh(mesh):
        g1, g2 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jax_sharded(mesh, f1), jax_sharded(mesh, f2))
    ranks = world4[f"warp_{backend}"]
    for key, want in (("df1", g1), ("df2", g2)):
        got = np.concatenate([r[key].numpy() for r in ranks], 1)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


# -- (C) the sharded model's gradients ---------------------------------------

@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's ``jax.grad`` of the unsharded model (lax backend), loss the
    sum over levels and pixels of flow**2, w.r.t. the params and both
    images; per model variant."""
    out = {}
    for variant, kw in (("plain", {}), ("norm", dict(use_norm=True)),
                        ("input_norm", dict(input_norm=True))):
        jm = JaxPWCNet(corr_backend="lax", **SMALL, **kw)
        p = setup["params"]["norm" if kw.get("use_norm") else "plain"]

        def loss(params, a, b, jm=jm):
            return sum(jnp.sum(f ** 2) for f in jm.apply(params, a, b))

        gp, g1, g2 = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            {"params": p}, setup["im1"], setup["im2"])
        out[variant] = dict(params=jax_tree_to_port(_flatten(
            jax.device_get(gp)["params"])), im1=np.asarray(g1),
            im2=np.asarray(g2))
    return out


def _port_grads(setup, opts, im_noise=0.0, seed=0):
    """The port's unsharded gradients of the same loss on the CPU."""
    name = "norm" if opts.get("use_norm") else "plain"
    model = PWCNet(device="cpu", **SMALL, **opts)
    model.load_state_dict(setup["sds"][name])
    im1, im2 = to_torch(setup["im1"]).clone(), to_torch(setup["im2"])
    if im_noise:
        im1 *= 1 + im_noise * torch.randn(
            im1.shape, generator=torch.Generator().manual_seed(seed))
    im1.requires_grad_()
    im2 = im2.clone().requires_grad_()
    sum((f ** 2).sum() for f in model(im1, im2)).backward()
    return {**{n: p.grad for n, p in model.named_parameters()},
            "im1": im1.grad, "im2": im2.grad}


def _moved_grads(setup, opts, rule):
    """The port's unsharded gradients, and the same moved as ``rule``
    moves them: "floor", frame 1 scaled by 1 + 1e-6 * N(0, 1) (three
    draws); "order", the CPU ops on 2, 4 and 8 threads instead of 1, so
    that their sums run in other orders."""
    with torch_threads(1):
        base = _port_grads(setup, opts)
        if rule == "floor":
            return base, [_port_grads(setup, opts, 1e-6, s)
                          for s in range(3)]
    moved = []
    for n in ORDER_THREADS:
        with torch_threads(n):
            moved.append(_port_grads(setup, opts))
    return base, moved


# The rule of each case. "1e-4": 1e-4 of max per tensor (measured: at most
# 1.7e-6, the images). "floor" and "order": max(1e-4, 3 x floor), where the
# port's own f32 floor, as ``_moved_grads`` measures it, is above 1e-4.
# "floor": with use_norm (floor 3.6e-3; the context net's first conv reads
# 3.6e-3) and input_norm (floor 7.9e-3; the image reads 8.7e-3): a
# LeakyReLU input within rounding of 0 flips when the sums change order.
# "order": at S = 4 the context net's gradients read 4.1e-4 to 1.42e-3 of
# max (block 3's weight) and the images 3.1e-4 and 1.7e-4, the same in
# every run, alone or under six xdist workers. They are the difference
# between two orders of the same f32 sums: the port's unsharded gradients
# at 1 thread equal the S = 4 ones to 1.8e-6, and at 2 threads JAX's to
# 1.6e-6; 1 against 2 threads reads 1.42e-3 (8 threads: 1.8e-3).
# Frame 1 scaled by 1 + 1e-6 * N(0, 1) moves them by at most 2.1e-6, so
# the "floor" measurement does not see this.
GRAD_RULE = {"s4": "order", "s2": "1e-4", "s2_fused": "1e-4",
             "s2_norm": "floor", "s2_input_norm": "floor"}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_sharded_model_gradients_match_jax(setup, world4, jax_grads, case):
    """The sharded forward's gradients (each rank's loss on its rows,
    parameters summed over the spatial axis, image rows gathered) equal
    JAX's gradients of the unsharded model, for the parameters and both
    images, on both data rows of the grid, within the case's rule."""
    mesh, opts = GRAD_CASES[case]
    norms = {k: v for k, v in opts.items() if k in ("use_norm",
                                                     "input_norm")}
    variant = ("norm" if opts.get("use_norm") else
               "input_norm" if opts.get("input_norm") else "plain")
    want = jax_grads[variant]
    tols = dict.fromkeys([*want["params"], "im1", "im2"], TOL)
    if GRAD_RULE[case] != "1e-4":
        base, moved = _moved_grads(setup, norms, GRAD_RULE[case])
        floors = {k: max(rel_err(g[k], base[k]) for g in moved)
                  for k in base}
        assert max(floors.values()) > TOL, floors  # the rule is needed
        tols = {k: max(TOL, FLOOR_FACTOR * floors[k]) for k in tols}
    ranks = world4[f"grad_{case}"]
    s = mesh["spatial"]
    for row in range(mesh["data"]):  # each data row's own sharded run
        group = ranks[row * s:(row + 1) * s]
        errs = _sharded_errs(group, want)
        over = {k: (e, tols[k]) for k, e in errs.items() if e > tols[k]}
        assert not over, over
        for r in group[1:]:  # the summed parameter gradients, replicated
            for k, v in group[0]["params"].items():
                assert torch.equal(r["params"][k], v), k


def _sharded_errs(group, want):
    """Per tensor, the rel. error of a grad task's gradients (the summed
    parameter gradients of rank 0, the gathered image rows) against
    ``want``."""
    errs = {k: rel_err(group[0]["params"][k].numpy(), w)
            for k, w in want["params"].items()}
    for im in ("im1", "im2"):
        got = np.concatenate([r[im].numpy() for r in group], 1)
        errs[im] = rel_err(got, want[im])
    return errs


def test_dropped_halo_gradient_fails_the_gradient_gate(world4, jax_grads):
    """The control of the gate above: the S = 4 case with every exchange's
    received rows detached (the halo's gradient dropped) has the same
    forward, and its gradients fail the 1e-4 gate, the images' and most
    parameters' among them."""
    errs = _sharded_errs(world4["grad_control"], jax_grads["plain"])
    over = sorted(k for k, e in errs.items() if e > TOL)
    assert {"im1", "im2"} <= set(over), errs
    assert len(over) > len(errs) // 2, errs


# -- (D) align_corners under a mesh ------------------------------------------

@pytest.mark.parametrize("case", ["align_grid", "align_s4"])
def test_spatial_forward_align_corners_matches_jax(setup, world4, case):
    """spatial_forward with resize_mode="align_corners" on the 2x2 grid (S
    = 2 on each data row) and at S = 4 equals JAX's spatial_forward on the
    same mesh shape per level and at full resolution, on every rank."""
    shape = (2, 2) if case == "align_grid" else (1, 4)
    mesh = jax_make_mesh(JaxMeshConfig(data=shape[0], spatial=shape[1]),
                         devices=jax.devices()[:4])
    jm = JaxPWCNet(corr_backend="lax", resize_mode="align_corners", **SMALL)
    flows, full = jax_spatial_forward(jm, {"params": setup["params"][
        "plain"]}, mesh, setup["im1"], setup["im2"])
    for rank in world4[case]:
        assert len(rank["flows"]) == len(flows)
        for g, w in zip(rank["flows"], flows):
            assert rel_err(g.numpy(), np.asarray(w)) <= TOL
        assert rel_err(rank["full"].numpy(), np.asarray(full)) <= TOL
    assert np.abs(np.asarray(flows[-1])).max() > 1e-3


@pytest.mark.parametrize("s", [1, 2, 4])
def test_upsample_align_corners_rule_matches_jax_resize(s):
    """upsample2x_block(mode="align_corners") on each shard's exchanged
    rows equals its rows of JAX's align-corners resize of the whole flow
    (source rows in global coordinates, clamped at the global edges)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 6, 2)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), (32, 12), "align_corners"))
    t = 16 // s
    for r in range(s):
        got = upsample2x_block(to_torch(ext_rows(x, r * t, t, 1, 1)), t, r, s,
                               "align_corners")
        np.testing.assert_allclose(got.numpy(),
                                   want[:, 2 * r * t:2 * (r + 1) * t],
                                   atol=1e-6)


# -- (E) the grid ------------------------------------------------------------

@pytest.mark.parametrize("world, shape", [(4, (2, 2, 1)), (2, (1, 1, 2))],
                         ids=["data2_spatial2", "model2"])
def test_grid_layout_matches_jax_mesh(world4, world2, world, shape):
    """Each rank's indices and the world ranks of its data and spatial
    groups are JAX's ``make_mesh(...).devices`` layout: rank r sits where
    device r sits."""
    res = (world4 if world == 4 else world2)["mesh"]
    jmesh = jax_make_mesh(JaxMeshConfig(*shape), devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    assert ids.shape == shape
    for rank, got in enumerate(res):
        idx = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert got["rank"] == rank and got["size"] == world
        assert tuple(got["shape"]) == shape
        assert tuple(got["index"]) == idx
        assert tuple(got["data_ranks"]) == tuple(ids[:, idx[1], idx[2]])
        assert tuple(got["spatial_ranks"]) == tuple(ids[idx[0], :, idx[2]])
        assert got["backend"] == "gloo"


# -- (F) train() on the grid -------------------------------------------------

def _jax_grid_steps(jparams, batches):
    """JAX's make_train_step on its data=2, spatial=2 mesh of four devices
    (AdamW 1e-4, no decay, as tests/test_torch_port_ddp.py's): the losses
    and the final parameters under the port's names."""
    jm = JaxPWCNet(corr_backend="lax", **SMALL)
    tx = jax_optimizer(JaxSchedule(base_lr=LR), weight_decay=0.0)
    mesh = jax_make_mesh(JaxMeshConfig(**GRID), devices=jax.devices()[:4])
    state = jax.device_put(JaxTrainState.create(
        jax.tree.map(jnp.asarray, jparams), tx, jax.random.key(1)),
        jax_replicated(mesh))
    step = jax_train_step(jm, tx, aug=None, mesh=mesh)
    losses = []
    for b in batches:
        state, m = step(state, jax_shard_batch(
            mesh, {k: v.numpy() for k, v in b.items()}))
        losses.append(float(m["loss"]))
    return losses, jax_tree_to_port(_flatten(jax.device_get(
        state.params)["params"]))


def _outside(got, want):
    """Entries outside rtol=2e-4, atol=2e-6."""
    return sum(int((np.abs(np.asarray(got[k], np.float64) - w)
                    > 2e-6 + 2e-4 * np.abs(w)).sum())
               for k, w in ((k, np.asarray(w, np.float64))
                            for k, w in want.items()))


def test_step_on_the_grid_matches_jax_mesh_step(setup, world4):
    """tests/test_torch_port_ddp.py's two steps (JAX's init, the same
    batches and AdamW), run by the port on the 2x2 grid, against JAX's
    make_train_step on its 2x2 mesh: the losses within 1e-5 and the
    parameters under PARAM_SHARE / UPDATE_BOUND; every rank ends with the
    same parameters and metrics."""
    ranks = world4["step"]
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    losses, want = _jax_grid_steps(setup["jstep"], setup["step_batches"])
    for g, w in zip(ranks[0]["metrics"], losses):
        assert abs(g["loss"] - w) <= LOSS_RTOL * abs(w)
    params_agree(ranks[0]["params"], want, PARAM_SHARE, UPDATE_BOUND)


def test_train_on_the_grid_matches_jax_mesh_step(setup, world4):
    """train() on the 2x2 grid from JAX's weights (train.init_from, JAX's
    init from key 1), two steps on the device batcher's batches, against
    JAX's make_train_step on its 2x2 mesh on the same batches: the last
    loss within 1e-5 and every parameter within UPDATE_BOUND; the grid is
    as close to JAX as one process's train() is (measured: 2214 and 2213
    of the 1,812,376 entries outside rtol=2e-4, atol=2e-6; JAX's own
    one-device step is 359 entries from its 2x2 step: with this init more
    entries than the ddp test's 0.1% take Adam's first step on a gradient
    within rounding of 0), and within PARAM_SHARE of one process (measured:
    1 entry outside). Every rank ends bit-identical."""
    ranks = world4["train"]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    losses, want = _jax_grid_steps(setup["jtrain"], setup["batches"])
    got = ranks[0]["final"]
    assert got["step"] == 2
    assert abs(got["loss"] - losses[-1]) <= LOSS_RTOL * abs(losses[-1])
    _, one = _one_state(_train_cfg(setup["root"] / "one_grid",
                                   init_from=setup["init_from"]), 2)
    params_agree(ranks[0]["params"], one, PARAM_SHARE, UPDATE_BOUND)
    for k, w in want.items():
        assert np.abs(ranks[0]["params"][k].numpy() - w).max() \
            <= UPDATE_BOUND, k
    total = sum(w.size for w in want.values())
    assert _outside(ranks[0]["params"], want) <= _outside(one, want) \
        + (1 - PARAM_SHARE) / 10 * total


@pytest.mark.parametrize("family", ["pwc", "raft"])
def test_train_spatial2_equals_one_process(setup, world2, family):
    """train() with parallel.spatial=2, data=1 on two ranks (replicas of
    one data row) equals one process's train() of the same config, and the
    two ranks end bit-identical."""
    root = setup["root"]
    if family == "pwc":
        cfg, steps = _train_cfg(root / "one_pwc",
                                init_from=setup["init_from"]), 2
    else:
        cfg, steps = _train_cfg(root / "one_raft", "raft"), 1
    one, params = _one_state(cfg, steps)
    ranks = world2[family]
    for r in ranks[1:]:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    got = ranks[0]["final"]
    assert got["step"] == one["step"] == steps
    assert abs(got["loss"] - one["loss"]) <= LOSS_RTOL * abs(one["loss"])
    params_agree(ranks[0]["params"], params, PARAM_SHARE, UPDATE_BOUND)


def _one_state(cfg, steps):
    """One process's train() of ``cfg`` on the CPU: its final metrics and
    parameters."""
    final, state = train_with_state(cfg, steps, device="cpu")
    return final, {n: p.detach() for n, p in
                   state.model.named_parameters()}


def test_grid_loader_run_equals_the_data_mesh_run(world4, world2):
    """train() on the Loader's batches with augmentation: the 2x2 grid
    equals the data mesh of two (the grid without its spatial replicas),
    so each data row's replicas took that row's rows and drew its
    augmentation (fold_in of the data index). A split by world rank would
    give each rank one row and four draws."""
    grid, data = world4["loader"], world2["loader"]
    for r in grid[1:]:
        for k, v in grid[0]["params"].items():
            assert torch.equal(r["params"][k], v), k
    got, want = grid[0]["final"], data[0]["final"]
    assert got["step"] == want["step"] == 2
    for k in ("loss", "train_epe", "grad_norm"):
        assert abs(got[k] - want[k]) <= LOSS_RTOL * abs(want[k]), k
    params_agree(grid[0]["params"], data[0]["params"], PARAM_SHARE,
                 UPDATE_BOUND)


# -- (G) the eval on the grid ------------------------------------------------

def test_evaluate_dataset_on_the_grid_equals_one_process(setup, world4):
    """evaluate_dataset on the 2x2 grid equals one process's on the same 4
    val pairs (each sample counted once, not once a spatial replica), and
    every rank gathers the per-sample rows in the one-process order."""
    model = build_model(_train_cfg("-"), "cpu").eval()
    model.load_state_dict(_port_train_sd(setup))
    ds = SyntheticFlow(split="val", hw=TRAIN_HW)
    want, rows = evaluate_dataset(model, ds, batch=2, limit=4,
                                  return_per_sample=True)
    assert want == evaluate_dataset(model, ds, batch=2, limit=4)
    assert want["num_samples"] == 4 and rows.shape == (4, 8)
    for rank in world4["eval"]:
        got = rank["result"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got[k], w)
        assert rank["per_sample"].shape == rows.shape
        np.testing.assert_allclose(rank["per_sample"].numpy(),
                                   rows.numpy(), rtol=1e-6)


# -- (H) the feed ------------------------------------------------------------

def _fake_grid(rank, shape=(2, 2, 1)):
    """A grid rank without process groups: enough for what reads only the
    indices and sizes."""
    return GridMesh(None, rank, int(np.prod(shape)), torch.device("cpu"),
                    "gloo", None, shape, None, None,
                    grid_ranks(shape, 0, rank), grid_ranks(shape, 1, rank))


def test_spatial_replicas_of_a_data_row_take_the_same_rows():
    """shard_batch, the device batcher and the Loader (with the data index
    and size that train() passes it) give the two spatial replicas of a
    data row the same rows, and the data rows together make the global
    batch."""
    grid = [_fake_grid(r) for r in range(4)]
    assert [g.data_mesh.rank for g in grid] == [0, 0, 1, 1]
    assert [g.spatial_mesh.rank for g in grid] == [0, 1, 0, 1]
    batch = {"x": torch.arange(8).view(4, 2)}
    parts = [shard_batch(g, batch)["x"] for g in grid]
    assert torch.equal(parts[0], parts[1]) and torch.equal(parts[2],
                                                           parts[3])
    assert torch.equal(torch.cat([parts[0], parts[2]]), batch["x"])
    whole = make_device_batcher(BATCH, (32, 32), device="cpu")(1)
    rows = [make_device_batcher(BATCH, (32, 32), device="cpu", mesh=g)(1)
            for g in grid]
    for k, v in whole.items():
        assert torch.equal(rows[0][k], rows[1][k]), k
        assert torch.equal(torch.cat([rows[1][k], rows[3][k]]), v), k
    ds = SyntheticFlow(split="train", hw=(32, 32), length=16)
    loaders = [Loader(ds, BATCH, sample_hw=(32, 32), seed=3, num_threads=1,
                      process_index=g.data_mesh.rank,
                      process_count=g.data_mesh.size) for g in grid]
    one = Loader(ds, BATCH, sample_hw=(32, 32), seed=3, num_threads=1)
    try:
        for step in (0, 5):
            got = [ld.indices_for_step(step) for ld in loaders]
            np.testing.assert_array_equal(got[0], got[1])
            np.testing.assert_array_equal(got[2], got[3])
            np.testing.assert_array_equal(np.concatenate([got[0], got[2]]),
                                          one.indices_for_step(step))
    finally:
        for ld in loaders + [one]:
            ld.close()


# -- the command line on a grid ----------------------------------------------

SMALL_OVERRIDES = ["model.num_levels=3", "model.output_level=2",
                   "model.search_range=2", "model.dtype=float32"]


@pytest.mark.parametrize("command", ["predict", "eval"])
def test_cli_on_a_grid_equals_one_process(tmp_path, monkeypatch, command):
    """``predict`` with ``parallel.spatial=2`` (the pair's rows sharded
    over two processes) and ``eval`` with ``parallel.model=2`` (two
    replicas), each two processes joined by the parallel.* overrides under
    ``--backend gloo``, against the same command in one process: the flow
    within 1e-4 of max, the eval's numbers within 1e-6; process 0 alone
    prints and writes."""
    import io
    import json
    import os
    import subprocess
    import sys
    from contextlib import redirect_stdout
    from pathlib import Path

    from pwcnet_tpu_torch import cli
    from pwcnet_tpu_torch.io import read_flo, write_png
    from pwcnet_tpu_torch.parallel.launch import free_port
    rng = np.random.default_rng(8)
    for name in ("a.png", "b.png"):
        write_png(str(tmp_path / name),
                  (rng.random((*HW, 3)) * 255).astype(np.uint8))
    if command == "predict":
        opts = ["predict", "--im1", str(tmp_path / "a.png"), "--im2",
                str(tmp_path / "b.png")]
        overrides = SMALL_OVERRIDES
        grid = ["parallel.spatial=2", "parallel.data=1"]
    else:
        opts = ["eval", "--preset", "synthetic-proof"]
        overrides = SMALL_OVERRIDES + ["data.sample_hw=(64,64)",
                                       "data.eval_batch=2",
                                       "train.eval_limit=4"]
        grid = ["parallel.model=2", "parallel.data=1"]

    def out(name):  # options before the overrides: argparse takes them last
        return ["--out", str(tmp_path / name)] if command == "predict" \
            else []
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(opts + out("one.flo") + overrides) == 0
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PWCNET_PLATFORM": "cpu", "PYTHONPATH": str(root),
           "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "pwcnet_tpu_torch.cli", *opts,
            *out("grid.flo"), "--backend", "gloo", *overrides, *grid,
            "parallel.num_processes=2",
            f"parallel.coordinator=localhost:{free_port()}"]
    procs = [subprocess.Popen(argv + [f"parallel.process_id={r}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, cwd=root, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[1][0].strip() == ""
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got.keys() == want.keys()
    if command == "predict":
        flow, ref = read_flo(str(tmp_path / "grid.flo")), read_flo(
            str(tmp_path / "one.flo"))
        assert flow.shape == ref.shape == (*HW, 2)
        assert rel_err(flow, ref) <= TOL
    else:
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got[k], w)
