"""The port's RAFT (``pwcnet_tpu_torch/models/raft.py``), its warp table,
sequence loss, train step and weight bridge held against the JAX package's,
on the CPU in f32.

Inputs come from numpy with a seed and go through both. The JAX model runs
with ``corr_backend="lax"``, the plain reference of its correlation kernel
(``tests/test_raft.py::test_pallas_backend_matches_lax`` pins the two
equal); the port runs on ``device="cpu"``, i.e. the plain versions of its
kernels. Every comparison of tensors is a relative max error,
``max|got - ref| <= tol * max|ref|``, with the tolerance stated where it is
used. The trained checkpoint ``runs/raft-synthetic/params_step20000_bf16.npz``
is compared on a smooth ``SyntheticFlow`` pair: there a 1e-6 relative
change of the input moves every iteration's flow by at most 1e-6 of its
max, so 1e-4 holds with a wide margin (on an integer-shifted pair the flow
converges onto the integer and the warp's coverage threshold flips).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pwcnet_tpu.losses as jl
from pwcnet_tpu.models import raft as jraft
from pwcnet_tpu.ops.warp import warp_bilinear_from_table as j_from_table
from pwcnet_tpu.ops.warp import warp_table as j_table
from pwcnet_tpu.train.state import TrainState as JaxTrainState
from pwcnet_tpu.train.step import make_train_step as jax_train_step
import pwcnet_tpu_torch.losses as tl
from pwcnet_tpu_torch.compat.flax_weights import (_flatten, load_flax_params,
                                                  read_flax_npz, torch_key)
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
from pwcnet_tpu_torch.models import raft as traft
from pwcnet_tpu_torch.ops.warp import warp_bilinear_from_table, warp_table
from pwcnet_tpu_torch.train.schedule import ScheduleConfig, make_optimizer
from pwcnet_tpu_torch.train.state import TrainState
from pwcnet_tpu_torch.train.step import make_train_step

from torch_port_util import jax_npz_params, nchw, rel_err, to_torch

NPZ = (Path(__file__).resolve().parents[1] / "runs" / "raft-synthetic"
       / "params_step20000_bf16.npz")
TOL = 1e-4  # f32 forwards, per iteration, relative to max|ref|


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _load_sub(module, params, prefix, strip):
    """Load a JAX submodule's params into the port's submodule through the
    bridge's rules: ``params`` placed under the flax path ``prefix``, the
    port key's ``strip`` prefix removed."""
    state = {}
    for path, v in _flatten(params).items():
        key = torch_key(f"{prefix}/{path}")
        assert key.startswith(strip)
        v = np.asarray(v)
        state[key[len(strip):]] = to_torch(
            v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
    module.load_state_dict(state)


def _images(rng, n=1, hw=(64, 96)):
    """A smooth random pair: frame 2 is frame 1 moved by a sub-pixel shift
    plus noise (no integer shift)."""
    base = rng.random((n, hw[0] + 8, hw[1] + 8, 3)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (1, 2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax,
                                   base)
    im1 = base[:, 4:-4, 4:-4]
    im2 = 0.6 * base[:, 5:-3, 3:-5] + 0.4 * base[:, 4:-4, 4:-4]
    return im1.astype(np.float32), np.clip(
        im2 + 0.01 * rng.standard_normal(im2.shape), 0, 1).astype(np.float32)


# -- convex upsampling and the warp table -----------------------------------

@pytest.mark.parametrize("factor", [8, 4])
def test_convex_upsample_matches_jax(factor):
    rng = np.random.default_rng(factor)
    flow = rng.standard_normal((2, 4, 6, 2)).astype(np.float32) * 3
    logits = rng.standard_normal((2, 4, 6, 9 * factor ** 2)).astype(
        np.float32) * 2
    got = traft.convex_upsample(to_torch(flow), to_torch(logits),
                                factor).numpy()
    want = np.asarray(jraft.convex_upsample(jnp.asarray(flow),
                                            jnp.asarray(logits), factor))
    assert got.shape == want.shape == (2, 4 * factor, 6 * factor, 2)
    assert rel_err(got, want, floor=1e-30) <= 1e-6


@pytest.mark.parametrize("kind", ["normal", "far", "nan"])
def test_warp_from_table_matches_jax(kind):
    """The forward bit for bit, and d(feat) of a weighted sum within 1e-5:
    normal flows, flows of +-1e4 px on a quarter of the pixels, and NaN
    flows (NaN where JAX is NaN, equal elsewhere)."""
    rng = np.random.default_rng(["normal", "far", "nan"].index(kind))
    feat = rng.standard_normal((2, 7, 9, 6)).astype(np.float32)
    flow = (3 * rng.standard_normal((2, 7, 9, 2))).astype(np.float32)
    if kind == "far":
        far = rng.random((2, 7, 9)) < 0.25
        flow[far] = 1e4 * np.sign(rng.standard_normal((far.sum(), 2)))
    if kind == "nan":
        flow[0, 2, 3, 0] = flow[1, 5, 1, 1] = np.nan
    g = rng.standard_normal(feat.shape).astype(np.float32)

    def jfn(f):
        return j_from_table(j_table(f), f.shape, jnp.asarray(flow))

    want = np.asarray(jfn(jnp.asarray(feat)))
    f = to_torch(feat).requires_grad_()
    got = warp_bilinear_from_table(warp_table(f), feat.shape, to_torch(flow))
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()),
                                  np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got.detach().numpy()),
                                  np.nan_to_num(want))
    assert np.isnan(want).any() == (kind == "nan")
    if kind == "nan":
        return
    (got * to_torch(g)).sum().backward()
    want_d = np.asarray(jax.grad(lambda f: (jfn(f) * g).sum())(
        jnp.asarray(feat)))
    assert rel_err(f.grad.numpy(), want_d, floor=1e-30) <= 1e-5


# -- submodules, weights bridged --------------------------------------------

def test_resblock_and_encoder_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 24, 32)).astype(np.float32)
    jb = jraft.ResBlock(48, stride=2)
    pb = jax.jit(jb.init)(jax.random.key(1), x)["params"]
    tb = traft.ResBlock(32, 48, 2)
    _load_sub(tb, pb, "fnet/ResBlock_0", "fnet.blocks.0.")
    got = _nhwc(tb(nchw(x)))
    want = np.asarray(jb.apply({"params": pb}, x))
    assert rel_err(got, want, floor=1e-30) <= 1e-5

    im = rng.random((2, 64, 96, 3)).astype(np.float32)
    je = jraft.RAFTEncoder(dim=160)
    pe = jax.jit(je.init)(jax.random.key(2), im)["params"]
    te = traft.RAFTEncoder(160)
    _load_sub(te, pe, "cnet", "cnet.")
    got = _nhwc(te(nchw(im)))
    assert got.shape == (2, 8, 12, 160)
    want = np.asarray(je.apply({"params": pe}, im))
    assert rel_err(got, want, floor=1e-30) <= 1e-5


@pytest.mark.parametrize("fuse_zr", [False, True])
def test_sep_conv_gru_matches_jax(fuse_zr):
    rng = np.random.default_rng(2)
    h = np.tanh(rng.standard_normal((2, 8, 12, 96))).astype(np.float32)
    x = rng.standard_normal((2, 8, 12, 160)).astype(np.float32)
    jg = jraft.SepConvGRU(hidden=96, fuse_zr=fuse_zr)
    pg = jax.jit(jg.init)(jax.random.key(3), h, x)["params"]
    tg = traft.SepConvGRU(96, 160, fuse_zr)
    assert len(tg.convs) == len(pg) == (4 if fuse_zr else 6)
    _load_sub(tg, pg, "SepConvGRU_0", "gru.")
    got = _nhwc(tg(nchw(h), nchw(x)))
    want = np.asarray(jg.apply({"params": pg}, h, x))
    assert rel_err(got, want, floor=1e-30) <= 1e-5


def test_motion_encoder_matches_jax():
    rng = np.random.default_rng(3)
    corr = rng.standard_normal((2, 8, 12, 162)).astype(np.float32)
    flow = 3 * rng.standard_normal((2, 8, 12, 2)).astype(np.float32)
    jm = jraft.MotionEncoder()
    pm = jax.jit(jm.init)(jax.random.key(4), corr, flow)["params"]
    tm = traft.MotionEncoder(162)
    _load_sub(tm, pm, "MotionEncoder_0", "menc.")
    got = _nhwc(tm(nchw(corr), nchw(flow)))
    want = np.asarray(jm.apply({"params": pm}, corr, flow))
    assert got.shape == want.shape == (2, 8, 12, 96)
    assert rel_err(got, want, floor=1e-30) <= 1e-5


# -- the whole forward ------------------------------------------------------

@pytest.fixture(scope="module")
def init_pair():
    """JAX RAFT (3 iterations, radius 4) at init on a 64x96 pair, its
    params, and the port's RAFT with them."""
    im1, im2 = _images(np.random.default_rng(4))
    jm = jraft.RAFT(num_iters=3, corr_radius=4, corr_backend="lax")
    params = jax.jit(jm.init)(jax.random.key(0), im1, im2)
    model = traft.RAFT(num_iters=3, corr_radius=4, device="cpu")
    load_flax_params(model, jax.device_get(params)["params"])
    return jm, params, model, (im1, im2)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax_per_iteration(init_pair, train):
    jm, params, model, (im1, im2) = init_pair
    want = jax.jit(lambda p, a, b: jm.apply(p, a, b, train=train))(
        params, im1, im2)
    with torch.no_grad():
        got = model(to_torch(im1), to_torch(im2), train=train)
    assert len(got) == len(want) == (3 if train else 1)
    for g, w in zip(got, want):
        assert g.shape == (1, 64, 96, 2) and g.dtype == torch.float32
        assert rel_err(g.numpy(), w, floor=1e-30) <= TOL
    assert np.abs(np.asarray(want[-1])).max() > 1e-2  # the flows carry signal


@pytest.fixture(scope="module")
def trained():
    model = traft.RAFT(device="cpu")
    load_flax_params(model, read_flax_npz(str(NPZ)))
    return model


def test_trained_checkpoint_matches_jax_per_iteration(trained):
    """12 iterations of the trained weights on a smooth synthetic val pair:
    every iteration within 1e-4 of max|ref| (measured 7e-7), and the final
    flow a good one."""
    s = SyntheticFlow(split="val", hw=(128, 160))[0]
    im1, im2 = s["im1"][None], s["im2"][None]
    jm = jraft.RAFT(corr_backend="lax")
    want = jax.jit(lambda p, a, b: jm.apply(p, a, b, train=True))(
        jax_npz_params(NPZ), im1, im2)
    with torch.no_grad():
        got = trained(to_torch(im1), to_torch(im2))
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_err(g.numpy(), w, floor=1e-30) <= TOL, i
    epe = np.sqrt(((got[-1][0].numpy() - s["flow"]) ** 2).sum(-1)).mean()
    assert epe < 0.5, epe  # measured 0.268 px


def test_predict_flow_and_evaluate_dataset_match_jax(trained):
    """predict_flow pads a 120x150 pair to the divisor 16 and crops back;
    evaluate_dataset over two synthetic val samples: both within 1e-4 of
    JAX's with the same weights."""
    from pwcnet_tpu.data.synthetic import SyntheticFlow as JaxSyntheticFlow
    from pwcnet_tpu.train.evaluate import evaluate_dataset as jax_evaluate
    from pwcnet_tpu.train.evaluate import predict_flow as jax_predict
    from pwcnet_tpu_torch.train.evaluate import (evaluate_dataset,
                                                 predict_flow)
    s = SyntheticFlow(split="val", hw=(128, 160))[3]
    im1, im2 = s["im1"][:120, :150], s["im2"][:120, :150]
    jm = jraft.RAFT(corr_backend="lax")
    params = jax_npz_params(NPZ)
    got = predict_flow(trained, im1, im2)
    want = jax_predict(jm, params, im1, im2)
    assert got.shape == want.shape == (120, 150, 2)
    assert rel_err(got, want, floor=1e-30) <= TOL
    ev = evaluate_dataset(trained, SyntheticFlow(split="val", hw=(128, 160)),
                          batch=2, limit=2)
    jev = jax_evaluate(jm, params, JaxSyntheticFlow(split="val",
                                                    hw=(128, 160)),
                       batch=2, limit=2)
    assert ev["num_samples"] == 2
    for k in ("epe", "epe_s0_10", "num_valid_px"):
        assert abs(ev[k] - jev[k]) <= TOL * abs(jev[k]), (k, ev, jev)


def test_read_flax_npz_reads_bf16_bits():
    tree = read_flax_npz(str(NPZ))
    k = tree["mask_head_2"]["kernel"]
    assert k.dtype == torch.bfloat16 and tuple(k.shape) == (1, 1, 128, 576)
    want = jax_npz_params(NPZ)["params"]["mask_head_2"]["kernel"]
    np.testing.assert_array_equal(k.float().numpy(), want)
    assert len(_flatten(tree)) == 70


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
def test_sequence_loss_matches_jax(with_valid):
    """Coarse flows upsampled to the GT (magnitude-scaled), the max_flow
    and validity masks, and full-resolution flows as RAFT gives them."""
    rng = np.random.default_rng(5)
    gt = (30 * rng.standard_normal((2, 32, 48, 2))).astype(np.float32)
    gt[:, :4, :4, 0] = 500.0
    valid = (rng.random((2, 32, 48)) > 0.2).astype(np.float32)
    v = valid if with_valid else None
    for hw in ((4, 6), (32, 48)):
        flows = [rng.standard_normal((2, *hw, 2)).astype(np.float32) * 3
                 for _ in range(3)]
        got = tl.sequence_loss([to_torch(f) for f in flows], to_torch(gt),
                               None if v is None else to_torch(v))
        want = float(jl.sequence_loss([jnp.asarray(f) for f in flows],
                                      jnp.asarray(gt),
                                      None if v is None else jnp.asarray(v)))
        assert abs(got.item() - want) <= 1e-5 * abs(want)


def test_inscan_loss_equals_sequence_loss(init_pair):
    """The loss summed inside the loop (gt=) equals sequence_loss on the
    returned flows, and JAX's in-scan loss; the final flow is the last."""
    jm, params, model, (im1, im2) = init_pair
    rng = np.random.default_rng(6)
    gt = (2 * rng.standard_normal((1, 64, 96, 2))).astype(np.float32)
    gt[:, :8, :8, 0] = 500.0
    valid = np.ones((1, 64, 96), np.float32)
    valid[:, -4:] = 0
    with torch.no_grad():
        flows = model(to_torch(im1), to_torch(im2))
        final, loss = model(to_torch(im1), to_torch(im2), gt=to_torch(gt),
                            valid=to_torch(valid))
        ref = tl.sequence_loss(flows, to_torch(gt), to_torch(valid))
    assert abs(loss.item() - ref.item()) <= 1e-5 * ref.item()
    np.testing.assert_array_equal(final[0].numpy(), flows[-1].numpy())
    _, want = jax.jit(lambda p, a, b: jm.apply(
        p, a, b, gt=jnp.asarray(gt), valid=jnp.asarray(valid)))(
        params, im1, im2)
    assert abs(loss.item() - float(want)) <= 1e-5 * float(want)


# -- one f32 train step -----------------------------------------------------

@pytest.fixture(scope="module")
def step_setup():
    ds = SyntheticFlow(split="train", hw=(64, 64))
    samples = [ds[i] for i in (3, 4)]
    batch = {k: np.stack([s[k] for s in samples]).astype(np.float32)
             for k in ("im1", "im2", "flow", "valid")}
    jm = jraft.RAFT(num_iters=3, corr_backend="lax")
    params = jax.jit(jm.init)(jax.random.key(7), batch["im1"], batch["im2"])
    return jm, params, batch


@pytest.mark.parametrize("kind", ["sequence", "sequence_inscan"])
def test_train_step_matches_jax(step_setup, kind):
    """loss, train_epe and grad_norm within 1e-5, every gradient within
    1e-4 of its max (JAX's gradients from jax.grad of the same loss)."""
    jm, params, batch = step_setup
    tx = optax.sgd(0.0)
    # The JAX step donates its state: give it a copy of the params.
    _, jmet = jax_train_step(jm, tx, aug=None, loss_kind=kind)(
        JaxTrainState.create(jax.tree_util.tree_map(jnp.copy, params), tx,
                             jax.random.key(1)), batch)

    def loss_fn(p):
        if kind == "sequence":
            return jl.sequence_loss(jm.apply(p, batch["im1"], batch["im2"]),
                                    batch["flow"], batch["valid"])
        return jm.apply(p, batch["im1"], batch["im2"], gt=batch["flow"],
                        valid=batch["valid"])[1]

    jgrads = _flatten(jax.device_get(jax.jit(jax.grad(loss_fn))(params))[
        "params"])

    model = traft.RAFT(num_iters=3, device="cpu")
    load_flax_params(model, jax.device_get(params)["params"])
    opt, sched = make_optimizer(model.parameters(),
                                ScheduleConfig(base_lr=1e-4))
    _, tmet = make_train_step(model, opt, sched, loss_kind=kind)(
        TrainState.create(model, opt, sched, seed=1),
        {k: to_torch(v) for k, v in batch.items()})
    for k in ("loss", "train_epe", "grad_norm"):
        want = float(jmet[k])
        assert abs(float(tmet[k]) - want) <= 1e-5 * abs(want), (k, tmet)
    tgrads = dict(model.named_parameters())
    errs = {}
    for path, g in jgrads.items():
        tg = tgrads[torch_key(path)].grad.numpy()
        errs[path] = rel_err(tg, g.transpose(3, 2, 0, 1) if g.ndim == 4
                              else g, floor=1e-30)
    assert len(errs) == len(tgrads)
    assert max(errs.values()) <= 1e-4, sorted(errs.items(),
                                              key=lambda t: -t[1])[:3]


# -- what raises, and full_res_flow ----------------------------------------

def test_divisor_raises_as_jax_does():
    bad = np.zeros((1, 72, 64, 3), np.float32)  # 72 = 8 (mod 16)
    with pytest.raises(ValueError, match="divisible by 16"):
        jax.jit(jraft.RAFT(num_iters=1).init)(jax.random.key(0), bad, bad)
    with pytest.raises(ValueError, match="divisible by 16"):
        traft.RAFT(num_iters=1, device="cpu")(to_torch(bad), to_torch(bad))


def test_full_res_flow_rescales_u_and_v_apart():
    flow = np.ones((1, 8, 16, 2), np.float32)
    got = traft.RAFT(num_iters=1, device="cpu").full_res_flow(
        [to_torch(flow)], (16, 64)).numpy()
    want = np.asarray(jraft.RAFT(num_iters=1).full_res_flow(
        [jnp.asarray(flow)], (16, 64)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[..., 0], 4.0)
    np.testing.assert_allclose(got[..., 1], 2.0)


def test_fused_backend_raises_as_jax_does():
    im = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="fused"):
        jax.jit(jraft.RAFT(num_iters=1, corr_backend="fused").init)(
            jax.random.key(0), im, im)
    with pytest.raises(ValueError, match="fused"):
        traft.RAFT(corr_backend="fused", device="cpu")


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_weight_bridge_raises_on_a_missing_or_extra_key(change):
    tree = read_flax_npz(str(NPZ))
    if change == "missing":
        del tree["flow_head_2"]["bias"]
    else:
        tree["mask_head_3"] = {"bias": torch.zeros(2)}
    with pytest.raises(KeyError):
        load_flax_params(traft.RAFT(num_iters=1, device="cpu"), tree)
