"""Published RAFT in the port (``models/raft_allpairs.py``: the all-pairs
pyramid, ``ops/corr_pyramid.py``, and its lookup, ``ops/corr_lookup.py``)
held against the benchmark's plain float32 reference of the released code
(``flowbench/reference/raft_allpairs.py``), on the CPU.

The JAX package has no all-pairs RAFT, so the reference is the plain
PyTorch one. Tensors are compared by relative max error, ``max|got - ref|
<= tol * max|ref|``, with the tolerance stated where it is used. The
kernels (K8, K9) are held to the plain ops on a card (the ``cuda`` tests).
"""

import json

import numpy as np
import pytest
import torch

from flowbench.reference import raft_allpairs as ref
from flowbench.reference.ops import Precision
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.models.raft_allpairs import RAFTAllPairs
from pwcnet_tpu_torch.ops.corr_lookup import corr_lookup_ref
from pwcnet_tpu_torch.ops.corr_pyramid import corr_pyramid_ref

from torch_port_util import make_model, rel_err, shifted_pair

HW = (64, 128)      # the model cases' frames
CFG = dict(feature_dim=256, hidden_dim=128, context_dim=128, corr_radius=4,
           corr_levels=4, iters=3, pad_divisor=8)
TOL = 1e-4           # the f32 model and plain ops against the reference
# The bf16 model against the f32 reference: 0.006-0.0094 of max|ref| on
# three seeds at 64x128; the reference in fp8 lies 0.09-0.16 away.
BF16_TOL = 0.03


def _weights(seed: int) -> dict:
    """Seeded parameters with every norm off the identity: conv weights of
    std sqrt(1 / fan_in), batch norm's weights near 1, small biases and
    means, running variances in [1, 2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in sorted(ref.param_shapes(CFG).items()):
        x = torch.randn(shape, generator=g)
        if k.endswith(".running_var"):
            out[k] = 1 + torch.rand(shape, generator=g)
        elif k.endswith(".weight") and len(shape) == 1:
            out[k] = 1 + 0.3 * x
        elif k.endswith(".weight"):
            out[k] = x * float(np.prod(shape[1:])) ** -0.5
        else:
            out[k] = 0.1 * x
    return out


# -- the plain ops against the reference's CorrBlock ---------------------------

@pytest.mark.parametrize("shape,levels", [((2, 7, 9, 16), 2),
                                          ((1, 17, 19, 32), 4),
                                          ((1, 8, 16, 256), 4)])
def test_corr_pyramid_ref_matches_the_reference(shape, levels):
    g = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn(shape, generator=g) for _ in range(2))
    got = corr_pyramid_ref(f1, f2, levels)
    want = ref.corr_pyramid(f1.permute(0, 3, 1, 2), f2.permute(0, 3, 1, 2),
                            levels)
    n, h, w, _ = shape
    assert [tuple(t.shape) for t in got] == [
        (n, h * w, h >> lv, w >> lv) for lv in range(levels)]
    for a, b in zip(got, want):
        assert rel_err(a, b.reshape(a.shape), floor=1e-30) <= TOL


def _coords(n, h, w, g, spread):
    """Fractional coordinates around the grid, some far outside it."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    c = torch.stack([xs, ys], -1)[None].repeat(n, 1, 1, 1)
    c = c + spread * torch.randn(c.shape, generator=g)
    c[:, 0, 0] = torch.tensor([-40.0, 3.5])       # left of every level
    c[:, -1, -1] = torch.tensor([w + 30.25, h + 0.5])
    return c


@pytest.mark.parametrize("shape,levels,r", [((2, 7, 9, 16), 2, 4),
                                            ((1, 17, 19, 32), 4, 4),
                                            ((1, 8, 16, 8), 4, 3)])
def test_corr_lookup_ref_matches_the_reference(shape, levels, r):
    g = torch.Generator().manual_seed(2)
    n, h, w, _ = shape
    f1, f2 = (torch.randn(shape, generator=g) for _ in range(2))
    pyr = corr_pyramid_ref(f1, f2, levels)
    coords = _coords(n, h, w, g, 3.0)
    got = corr_lookup_ref(pyr, coords, r)
    want = ref.lookup([t.reshape(n * h * w, 1, *t.shape[-2:]) for t in pyr],
                      coords.permute(0, 3, 1, 2), r)
    assert got.shape == (n, h, w, levels * (2 * r + 1) ** 2)
    assert rel_err(got, want.permute(0, 2, 3, 1), floor=1e-30) <= TOL
    # Outside every level the samples are zero; the window's first index
    # moves x (RAFT's meshgrid(dy, dx) added to (x, y)).
    assert got[:, 0, 0, :(2 * r + 1) ** 2].abs().max() == 0
    lvl0 = pyr[0].reshape(n, h, w, h, w)
    x, y = 2, 3
    c = torch.zeros(n, h, w, 2)
    c[..., 0], c[..., 1] = float(x), float(y)
    on_grid = corr_lookup_ref(pyr, c, r)
    k = 2 * r + 1
    a, b = r + 1, r - 1        # the point (x + 1, y - 1)
    # grid_sample's normalization moves an integer point by ~1e-7.
    assert torch.allclose(on_grid[..., a * k + b], lvl0[..., y - 1, x + 1],
                          rtol=0, atol=1e-5)


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_f32_model_matches_the_reference(backend):
    w = _weights(3)
    im1, im2 = shifted_pair(3, HW, torch_batch=True)
    with torch.no_grad():
        got = make_model("raft_allpairs", state_dict=w, num_iters=3,
                         corr_backend=backend)(im1, im2, train=False)
        want = ref.forward(w, CFG, im1, im2)
    assert len(got) == 1 and got[0].shape == (1, 64, 128, 2)
    assert rel_err(got[0], want[0], floor=1e-30) <= TOL


def test_bf16_model_is_within_rounding_and_fp8_is_not():
    w = _weights(4)
    im1, im2 = shifted_pair(4, HW, torch_batch=True)
    with torch.no_grad():
        want = ref.forward(w, CFG, im1, im2)[0]
        got = make_model("raft_allpairs", state_dict=w, num_iters=3,
                         dtype=torch.bfloat16)(im1, im2, train=False)[0]
        fp8 = ref.forward(w, CFG, im1, im2, Precision("fp8"))[0]
    assert got.dtype == torch.float32
    assert (rel_err(got, want, floor=1e-30) <= BF16_TOL
            < rel_err(fp8, want, floor=1e-30))


def test_f32_gradients_match_the_references_autograd():
    """Gradients of a fixed projection of the final flow, 2 iterations.
    A conv's bias before an instance norm has no gradient in exact
    arithmetic: each leaf's error is taken over the larger of its own max
    and 1e-3 of the largest leaf's."""
    w = _weights(5)
    cfg = dict(CFG, iters=2)
    im1, im2 = shifted_pair(5, HW, torch_batch=True)
    proj = torch.randn((1, 64, 128, 2), generator=torch.Generator()
                       .manual_seed(5))
    model = make_model("raft_allpairs", state_dict=w, num_iters=2)
    (model(im1, im2, train=False)[0] * proj).sum().backward()
    p = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                     "running_var")))
         for k, v in w.items()}
    (ref.forward(p, cfg, im1, im2)[0] * proj).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == {k for k, v in p.items() if v.requires_grad}
    top = max(float(p[k].grad.abs().max()) for k in grads)
    for k, prm in grads.items():
        err = float((prm.grad - p[k].grad).abs().max())
        scale = max(float(p[k].grad.abs().max()), 1e-3 * top)
        assert err <= TOL * scale, (k, err, scale)


def test_train_forward_returns_every_iteration_and_the_inscan_loss():
    w = _weights(6)
    im1, im2 = shifted_pair(6, HW, torch_batch=True)
    model = make_model("raft_allpairs", state_dict=w, num_iters=3)
    flows = model(im1, im2, train=True)
    assert len(flows) == 3 and all(f.shape == (1, 64, 128, 2) for f in flows)
    gt = torch.zeros((1, 64, 128, 2))
    last, loss = model(im1, im2, train=True, gt=gt)
    want = sum(0.8 ** (2 - i) * f.abs().sum(-1).mean()
               for i, f in enumerate(flows))
    assert torch.allclose(last[0], flows[-1])
    assert torch.allclose(loss, want, rtol=1e-5)


def test_state_dict_keys_are_the_references():
    model = RAFTAllPairs(num_iters=1, device="cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        ref.param_shapes(CFG)
    assert 5.2e6 < sum(p.numel() for p in model.parameters()) < 5.4e6


def test_shapes_the_model_refuses():
    model = RAFTAllPairs(num_iters=1, device="cpu")
    with pytest.raises(ValueError, match="divisible by 8"):
        model(torch.zeros(1, 60, 64, 3), torch.zeros(1, 60, 64, 3))
    with pytest.raises(ValueError, match="no level 3"):
        model(torch.zeros(1, 56, 64, 3), torch.zeros(1, 56, 64, 3))
    with pytest.raises(ValueError, match="backend"):
        RAFTAllPairs(device="cpu", corr_backend="fused")


# -- the trainer's routing and the entry point --------------------------------

def test_build_model_routes_the_family():
    import dataclasses

    from pwcnet_tpu_torch.config import apply_overrides
    from pwcnet_tpu_torch.train.loop import build_model
    cfg = apply_overrides(PRESETS["chairs-1chip"], [
        "model.family=raft_allpairs", "model.raft_iters=5",
        "model.raft_radius=3", "model.dtype=float32"])
    model = build_model(cfg, "cpu")
    assert isinstance(model, RAFTAllPairs)
    assert (model.num_iters, model.corr_levels, model.corr_radius) == (5, 4,
                                                                       3)
    assert model.menc.convc1.weight.shape[1] == 4 * 7 ** 2
    assert model.dtype == torch.float32 and model.pad_divisor == 8
    bad = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, family="raft_local"))
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(bad, "cpu")


def test_predict_flow_pads_to_8_and_crops():
    from pwcnet_tpu_torch.train.evaluate import pad_to_divisible, predict_flow
    w = _weights(7)
    model = make_model("raft_allpairs", state_dict=w, num_iters=2)
    rng = np.random.default_rng(7)
    im1 = rng.random((60, 100, 3)).astype(np.float32)
    im2 = np.roll(im1, 2, 1)
    flow = predict_flow(model, im1, im2)
    assert flow.shape == (60, 100, 2) and flow.dtype == np.float32
    p1, _ = pad_to_divisible(im1[None], 8)
    p2, _ = pad_to_divisible(im2[None], 8)
    assert p1.shape == (1, 64, 104, 3)
    with torch.no_grad():
        full = model(torch.from_numpy(p1), torch.from_numpy(p2),
                     train=False)[0]
    np.testing.assert_array_equal(flow, full[0, :60, :100].numpy())


@pytest.mark.parametrize("loss", ["sequence", "sequence_inscan"])
def test_train_runs_the_family(tmp_path, loss):
    """``train()`` takes the family from the config: two steps of 64x64
    crops (a 1/8 grid of 8x8, levels 8, 4, 2 and 1) under either sequence
    loss, the gradients through both Functions' backward (the plain ops'
    autograd on the CPU), a finite loss and a checkpoint of the family's
    parameters."""
    import dataclasses

    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model, train
    cfg = PRESETS["synthetic-proof"]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, family="raft_allpairs",
                                       raft_iters=2, dtype="float32"),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=(64, 64))),
        train=dataclasses.replace(cfg.train, global_batch=1, loss=loss,
                                  log_dir=str(tmp_path), summary_interval=1))
    final = train(cfg, max_steps=2, device="cpu")
    assert final["step"] == 2
    assert np.isfinite([final["loss"], final["train_epe"],
                        final["grad_norm"]]).all() and final["grad_norm"] > 0
    saved = CheckpointManager(str(tmp_path / "ckpt")).load()["model"]
    assert saved.keys() == ref.param_shapes(CFG).keys()
    # Batch norm stays in its eval form: its statistics are not trained.
    init = build_model(cfg, "cpu").state_dict()
    stats = [k for k in saved if k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(saved[k], init[k]) for k in stats)
    assert not torch.equal(saved["fnet.conv1.weight"],
                           init["fnet.conv1.weight"])


def test_cli_predict_takes_the_family(tmp_path, capsys, monkeypatch):
    """``predict`` with ``model.family=raft_allpairs`` writes the flow that
    ``predict_flow`` gives on the model ``build_model`` makes of the same
    overrides, here on the repo's 128x160 parity pair."""
    from pathlib import Path

    from pwcnet_tpu_torch import cli
    from pwcnet_tpu_torch.config import Config, apply_overrides
    from pwcnet_tpu_torch.data.base import read_image
    from pwcnet_tpu_torch.io.flow_io import read_flo
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    from pwcnet_tpu_torch.train.loop import build_model
    pair = Path(__file__).resolve().parent / "fixtures" / "parity"
    im1, im2 = str(pair / "im1.png"), str(pair / "im2.png")
    overrides = ["model.family=raft_allpairs", "model.raft_iters=2",
                 "model.dtype=float32"]
    out = tmp_path / "flow.flo"
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    assert cli.main(["predict", "--im1", im1, "--im2", im2, "--out",
                     str(out), *overrides]) == 0
    assert json.loads(capsys.readouterr().out)["shape"] == [128, 160, 2]
    model = build_model(apply_overrides(Config(), overrides), "cpu").eval()
    assert isinstance(model, RAFTAllPairs)
    want = predict_flow(model, read_image(im1), read_image(im2))
    np.testing.assert_allclose(read_flo(str(out)), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# -- the kernels on a card -----------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,levels", [((1, 55, 128, 256), 4),
                                          ((2, 17, 19, 32), 4),
                                          ((1, 7, 9, 16), 2)])
def test_k8_matches_its_plain_op(shape, levels, dtype):
    from pwcnet_tpu_torch.ops.kernels.corr_pyramid_kernel import (
        corr_pyramid_cuda)
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(8)
    f1, f2 = (torch.randn(shape, generator=g, device=dev).to(dtype)
              for _ in range(2))
    got = corr_pyramid_cuda(f1, f2, levels)
    want = corr_pyramid_ref(f1, f2, levels)
    # f32: the sum order; bf16: one rounding step of the output.
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    for a, b in zip(got, want):
        assert a.shape == b.shape and rel_err(a, b, floor=1e-30) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,levels", [((1, 55, 128, 256), 4),
                                          ((2, 17, 19, 32), 4),
                                          ((1, 7, 9, 16), 2)])
def test_k9_matches_its_plain_op(shape, levels, dtype):
    from pwcnet_tpu_torch.ops.kernels.corr_lookup_kernel import (
        corr_lookup_cuda)
    dev = _cuda()
    g = torch.Generator().manual_seed(9)
    n, h, w, _ = shape
    pyr = [t.to(dev) for t in corr_pyramid_ref(
        *(torch.randn(shape, generator=g).to(dtype) for _ in range(2)),
        levels)]
    coords = _coords(n, h, w, g, 4.0).to(dev)
    got = corr_lookup_cuda(pyr, coords, 4)
    want = corr_lookup_ref(pyr, coords, 4)
    # f32: grid_sample's normalization moves a point by a few f32 steps of
    # its coordinate; bf16: one rounding step of the output.
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8
    assert got.shape == want.shape and rel_err(got, want, floor=1e-30) <= tol
