"""GMA in the port (``models/gma.py``: published RAFT with global motion
aggregation, ``ops/global_attention.py``) held against the benchmark's plain
float32 reference of the released code (``flowbench/reference/gma.py``), on
the CPU; K11 (``csrc/global_attention.cu``) against the plain versions on a
card (the ``cuda`` tests).

The JAX package has no GMA, so the reference is the plain PyTorch one.
Tensors are compared by relative max error, ``max|got - ref| <= tol *
max|ref|``, with each tolerance stated where it is used. This file imports
no JAX: on a card it runs with ``--noconftest``.
"""

import json

import numpy as np
import pytest
import torch

from flowbench.reference import gma as ref
from flowbench.reference import raft_allpairs as rap
from flowbench.reference.ops import F32, Precision
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.models.gma import GMA
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc
from pwcnet_tpu_torch.models.raft_allpairs import RAFTAllPairs
from pwcnet_tpu_torch.ops.global_attention import (aggregate_ref,
                                                   attention_map_ref)

from torch_port_util import (make_model, need_cuda, one_thread,  # noqa: F401
                             rel_err, shifted_pair)

HW = (64, 128)      # the model cases' frames: a 1/8 grid of 8x16, P = 128
CFG = dict(feature_dim=256, hidden_dim=128, context_dim=128, corr_radius=4,
           corr_levels=4, iters=3, pad_divisor=8, dim_head=128)
# The f32 port against the f32 reference: the sums' order alone, at most
# 1.1e-6 of max in the map, 0 in one aggregation and 9e-7 in the whole
# forward (seeds 1-3, 17-19). The reference with its attention alone rounded
# to bf16 lies 4.9e-3 to 6.5e-3 away in the map, 4.4e-4 to 5e-4 in an
# aggregation and 5.3e-4 to 1.5e-3 in the flow (the third asserted below).
TOL = 1e-5
MODEL_TOL = 1e-4
# The bf16 model against the f32 reference at 64x128, 3 iterations (as
# published RAFT's test: its readings 0.006-0.0094); the reference in fp8
# lies further than this.
BF16_TOL = 0.03


def _weights(seed: int, cfg=CFG) -> dict:
    """Seeded parameters with every norm off the identity: conv weights of
    std sqrt(1 / fan_in), batch norm's weights near 1, small biases and
    means, running variances in [1, 2), ``gamma`` 1 + |0.01 x| (the
    benchmark's law; the released init, 0, would take the aggregation
    out of every answer)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in sorted(ref.param_shapes(cfg).items()):
        x = torch.randn(shape, generator=g)
        if k.endswith(".running_var"):
            out[k] = 1 + torch.rand(shape, generator=g)
        elif k == "aggregator.gamma":
            out[k] = 1 + 0.01 * x.abs()
        elif k.endswith(".weight") and len(shape) == 1:
            out[k] = 1 + 0.3 * x
        elif k.endswith(".weight"):
            out[k] = x * float(np.prod(shape[1:])) ** -0.5
        else:
            out[k] = 0.1 * x
    return out


def _context(seed, hw=(8, 16)):
    """Context features as the model makes them: ReLU of normal values,
    channels-last."""
    g = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn((1, 128, *hw), generator=g)).contiguous(
        memory_format=torch.channels_last)


# -- the parts against the reference ---------------------------------------

@pytest.mark.parametrize("row_block", [4096, 48])
def test_map_matches_the_reference(monkeypatch, row_block):
    """The port's map (to_qk, split, scaled softmax) against the
    reference's, whose row blocks (48 rows: three blocks of a 128-pixel
    grid, the last one short) must not change it."""
    monkeypatch.setattr(ref, "ROW_BLOCK", row_block)
    w = _weights(1)
    gma = make_model("gma")
    gma.load_state_dict(w)
    inp = _context(1)
    with torch.no_grad():
        got = gma.att(inp)
        want = ref.attention(w, inp)
        bf16 = ref.attention(w, inp, Precision("bfloat16"))
    assert got.shape == (1, 128, 128)
    assert torch.allclose(got.sum(-1), torch.ones(1, 128), atol=1e-6)
    assert rel_err(got, want) <= TOL < rel_err(bf16, want)


def test_one_aggregation_matches_the_reference():
    w = _weights(2)
    gma = make_model("gma")
    gma.load_state_dict(w)
    inp, m = _context(2), _context(3)
    with torch.no_grad():
        attn = ref.attention(w, inp)
        got = gma.aggregator(attn, m)
        want = ref.aggregate(w, attn, m)
        bf16 = ref.aggregate(w, attn, m, Precision("bfloat16"))
    assert got.shape == m.shape
    assert rel_err(got, want) <= TOL < rel_err(bf16, want)


def test_plain_ops_compose_as_stated():
    """``aggregate_ref`` is ``m + gamma * attn @ v`` summed in f32 and
    rounded once; the bf16 map is the f32 map rounded once."""
    g = torch.Generator().manual_seed(4)
    q, k, v, m = (torch.randn((2, 40, 128), generator=g) for _ in range(4))
    a32 = attention_map_ref(q, k)
    a16 = attention_map_ref(q.bfloat16(), k.bfloat16())
    want = torch.softmax(q.bfloat16().float() @ k.bfloat16().float()
                         .transpose(1, 2) / 128 ** 0.5, -1)
    assert torch.equal(a16, want.bfloat16())
    gamma = torch.tensor([1.5])
    got = aggregate_ref(a32.bfloat16(), v.bfloat16(), m.bfloat16(), gamma)
    exact = (m.bfloat16().double() + 1.5 * a32.bfloat16().double()
             @ v.bfloat16().double())
    assert got.dtype == torch.bfloat16
    assert rel_err(got, exact) <= 2.0 ** -8


# -- the model ---------------------------------------------------------------

def _forward(w, backend="pallas", iters=3, dtype=torch.float32, hw=HW,
             seed=3):
    im1, im2 = shifted_pair(seed, hw, torch_batch=True)
    model = make_model("gma", num_iters=iters, corr_backend=backend,
                       dtype=dtype)
    model.load_state_dict(w)
    with torch.no_grad():
        return model(im1, im2, train=False)[0], im1, im2


def test_f32_model_matches_the_reference_and_bf16_attention_does_not(
        monkeypatch):
    w = _weights(3)
    got, im1, im2 = _forward(w)
    with torch.no_grad():
        want = ref.forward(w, CFG, im1, im2)[0]
        attention, aggregate = ref.attention, ref.aggregate
        monkeypatch.setattr(ref, "attention", lambda p, inp, prec=F32:
                            attention(p, inp, Precision("bfloat16")))
        monkeypatch.setattr(ref, "aggregate", lambda p, a, m, prec=F32:
                            aggregate(p, a, m, Precision("bfloat16")))
        bf16_attention = ref.forward(w, CFG, im1, im2)[0]
    assert got.shape == (1, 64, 128, 2)
    assert rel_err(got, want) <= MODEL_TOL < rel_err(bf16_attention, want)


def test_gamma_reaches_the_flow():
    """With gamma 0 the aggregation drops out of the reference's answer,
    and the answer moves by far more than rounding (the benchmark's
    ``no_global`` control)."""
    w = _weights(5)
    im1, im2 = shifted_pair(5, HW, torch_batch=True)
    w0 = dict(w, **{"aggregator.gamma": torch.zeros(1)})
    with torch.no_grad():
        a = ref.forward(w, CFG, im1, im2)[0]
        b = ref.forward(w0, CFG, im1, im2)[0]
    assert rel_err(b, a) > 0.05


def test_lax_and_pallas_agree_on_the_cpu(one_thread):
    """On CPU tensors both backends run the same plain ops."""
    w = _weights(6)
    assert torch.equal(_forward(w, "pallas")[0], _forward(w, "lax")[0])


def test_bf16_model_is_within_rounding_and_fp8_is_not():
    w = _weights(7)
    got, im1, im2 = _forward(w, dtype=torch.bfloat16)
    with torch.no_grad():
        want = ref.forward(w, CFG, im1, im2)[0]
        fp8 = ref.forward(w, CFG, im1, im2, Precision("fp8"))[0]
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= BF16_TOL < rel_err(fp8, want)


def test_f32_gradients_match_the_references_autograd():
    """One training step's gradients, of a fixed projection of the final
    flow, 2 iterations, against autograd of the reference. A conv's bias
    before an instance norm has no gradient in exact arithmetic: each
    leaf's error is taken over the larger of its own max and 1e-3 of the
    largest leaf's."""
    w = _weights(8)
    cfg = dict(CFG, iters=2)
    im1, im2 = shifted_pair(8, HW, torch_batch=True)
    proj = torch.randn((1, 64, 128, 2), generator=torch.Generator()
                       .manual_seed(8))
    model = make_model("gma", num_iters=2)
    model.load_state_dict(w)
    (model(im1, im2, train=False)[0] * proj).sum().backward()
    p = {k: v.clone().requires_grad_(not k.endswith(("running_mean",
                                                     "running_var")))
         for k, v in w.items()}
    (ref.forward(p, cfg, im1, im2)[0] * proj).sum().backward()
    grads = dict(model.named_parameters())
    assert set(grads) == {k for k, v in p.items() if v.requires_grad}
    assert float(grads["aggregator.gamma"].grad.abs()) > 0
    top = max(float(p[k].grad.abs().max()) for k in grads)
    for k, prm in grads.items():
        err = float((prm.grad - p[k].grad).abs().max())
        scale = max(float(p[k].grad.abs().max()), 1e-3 * top)
        assert err <= MODEL_TOL * scale, (k, err, scale)


def _allpairs_before_the_hook(model, im1, im2):
    """``RAFTAllPairs.forward(train=False)`` as it was before its loop took
    the aggregation hook, written out."""
    from pwcnet_tpu_torch.ops.corr_lookup import corr_lookup
    from pwcnet_tpu_torch.ops.corr_pyramid import corr_pyramid
    n = im1.shape[0]
    cl = torch.channels_last
    im1 = (2 * im1.float() - 1).to(model.dtype)
    im2 = (2 * im2.float() - 1).to(model.dtype)
    fmap = model.fnet(_nchw(torch.cat([im1, im2], 0)).contiguous(
        memory_format=cl))
    ctx = model.cnet(_nchw(im1).contiguous(memory_format=cl))
    hidden = torch.tanh(ctx[:, :model.hidden].float()).to(model.dtype)
    context = torch.relu(ctx[:, model.hidden:])
    f1, f2 = _nhwc(fmap[:n]).contiguous(), _nhwc(fmap[n:]).contiguous()
    pyramid = corr_pyramid(f1, f2, model.corr_levels)
    hh, ww = f1.shape[1:3]
    ys, xs = torch.meshgrid(torch.arange(hh, dtype=torch.float32),
                            torch.arange(ww, dtype=torch.float32),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], -1)[None].expand(n, hh, ww, 2)
    coords1 = coords0
    for _ in range(model.num_iters):
        corr = corr_lookup(pyramid, coords1, model.corr_radius)
        flow = coords1 - coords0
        m = model.menc(_nchw(corr), _nchw(flow))
        hidden = model.gru(hidden, torch.cat([context, m], 1))
        delta = model.flow_head_2(torch.relu(model.flow_head_1(hidden)))
        coords1 = coords1 + _nhwc(delta).float()
    return model._upsample(hidden, coords1 - coords0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raft_allpairs_is_bit_identical_after_the_loop_refactor(
        one_thread, dtype):
    model = make_model("raft_allpairs", seed=9, num_iters=3, dtype=dtype)
    im1, im2 = shifted_pair(9, HW, torch_batch=True)
    with torch.no_grad():
        got = model(im1, im2, train=False)[0]
        want = _allpairs_before_the_hook(model, im1, im2)
    assert torch.equal(got, want)


def test_train_forward_returns_every_iteration_and_the_inscan_loss():
    w = _weights(10)
    im1, im2 = shifted_pair(10, HW, torch_batch=True)
    model = make_model("gma", num_iters=3)
    model.load_state_dict(w)
    flows = model(im1, im2, train=True)
    assert len(flows) == 3 and all(f.shape == (1, 64, 128, 2) for f in flows)
    gt = torch.zeros((1, 64, 128, 2))
    last, loss = model(im1, im2, train=True, gt=gt)
    want = sum(0.8 ** (2 - i) * f.abs().sum(-1).mean()
               for i, f in enumerate(flows))
    assert torch.allclose(last[0], flows[-1])
    assert torch.allclose(loss, want, rtol=1e-5)


def test_state_dict_keys_are_the_references():
    model = make_model("gma", num_iters=1)
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        ref.param_shapes(CFG)
    assert float(sd["aggregator.gamma"]) == 0.0    # the released init
    # Published RAFT's 5.26 M, the GRU's 6 x 128 x 128 x 5 more inputs,
    # to_qk's 32768 and to_v's 16384.
    n_raft = sum(p.numel() for p in RAFTAllPairs(
        num_iters=1, device="cpu").parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n - n_raft == 6 * 128 * 128 * 5 + 32768 + 16384 + 1


# -- the trainer's routing and the entry points -------------------------------

def test_build_model_routes_the_family():
    from pwcnet_tpu_torch.config import apply_overrides
    from pwcnet_tpu_torch.train.loop import build_model
    cfg = apply_overrides(PRESETS["chairs-1chip"], [
        "model.family=gma", "model.raft_iters=5", "model.raft_radius=3",
        "model.dtype=float32"])
    model = build_model(cfg, "cpu")
    assert isinstance(model, GMA)
    assert (model.num_iters, model.corr_levels, model.corr_radius) == (5, 4,
                                                                       3)
    assert model.gru.convs[0].weight.shape[1] == 128 + 384
    assert model.dtype == torch.float32 and model.pad_divisor == 8


def test_predict_flow_pads_to_8_and_crops():
    from pwcnet_tpu_torch.train.evaluate import pad_to_divisible, predict_flow
    model = make_model("gma", num_iters=2)
    model.load_state_dict(_weights(11))
    rng = np.random.default_rng(11)
    im1 = rng.random((60, 100, 3)).astype(np.float32)
    im2 = np.roll(im1, 2, 1)
    flow = predict_flow(model, im1, im2)
    assert flow.shape == (60, 100, 2) and flow.dtype == np.float32
    p1, _ = pad_to_divisible(im1[None], 8)
    p2, _ = pad_to_divisible(im2[None], 8)
    with torch.no_grad():
        full = model(torch.from_numpy(p1), torch.from_numpy(p2),
                     train=False)[0]
    np.testing.assert_array_equal(flow, full[0, :60, :100].numpy())


def test_train_runs_the_family(tmp_path):
    """``train()`` takes the family from the config: two steps of 64x64
    crops under the in-scan sequence loss, the gradients through the
    attention's plain autograd, a checkpoint of the family's parameters."""
    import dataclasses

    from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
    from pwcnet_tpu_torch.train.loop import build_model, train
    cfg = PRESETS["synthetic-proof"]
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, family="gma",
                                       raft_iters=2, dtype="float32"),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=(64, 64))),
        train=dataclasses.replace(cfg.train, global_batch=1,
                                  loss="sequence_inscan",
                                  log_dir=str(tmp_path), summary_interval=1))
    final = train(cfg, max_steps=2, device="cpu")
    assert final["step"] == 2
    assert np.isfinite([final["loss"], final["train_epe"],
                        final["grad_norm"]]).all() and final["grad_norm"] > 0
    saved = CheckpointManager(str(tmp_path / "ckpt")).load()["model"]
    assert saved.keys() == ref.param_shapes(CFG).keys()
    init = build_model(cfg, "cpu").state_dict()
    for k in ("att.to_qk.weight", "aggregator.to_v.weight",
              "aggregator.gamma"):
        assert not torch.equal(saved[k], init[k]), k


def test_cli_predict_takes_the_family(tmp_path, capsys, monkeypatch):
    """``predict`` with ``model.family=gma`` writes the flow that
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
    overrides = ["model.family=gma", "model.raft_iters=2",
                 "model.dtype=float32"]
    out = tmp_path / "flow.flo"
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    assert cli.main(["predict", "--im1", im1, "--im2", im2, "--out",
                     str(out), *overrides]) == 0
    assert json.loads(capsys.readouterr().out)["shape"] == [128, 160, 2]
    model = build_model(apply_overrides(Config(), overrides), "cpu").eval()
    assert isinstance(model, GMA)
    want = predict_flow(model, read_image(im1), read_image(im2))
    np.testing.assert_allclose(read_flo(str(out)), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_cli_eval_takes_the_family(capsys, monkeypatch):
    """``eval`` with ``model.family=gma`` prints what ``evaluate_dataset``
    gives on the model ``build_model`` makes of the same overrides, on two
    64x64 synthetic validation pairs."""
    from pwcnet_tpu_torch import cli
    from pwcnet_tpu_torch.config import PRESETS, apply_overrides
    from pwcnet_tpu_torch.data.base import get_dataset
    from pwcnet_tpu_torch.train.evaluate import evaluate_dataset
    from pwcnet_tpu_torch.train.loop import build_model
    overrides = ["model.family=gma", "model.raft_iters=2",
                 "model.dtype=float32", "data.sample_hw=(64,64)",
                 "train.eval_limit=2", "data.eval_batch=2"]
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    assert cli.main(["eval", "--preset", "synthetic-proof", *overrides]) == 0
    got = json.loads(capsys.readouterr().out)
    cfg = apply_overrides(PRESETS["synthetic-proof"], overrides)
    model = build_model(cfg, "cpu").eval()
    assert isinstance(model, GMA)
    ds = get_dataset("synthetic", "-", split="val", hw=(64, 64),
                     val_length=cfg.data.synthetic_val_length)
    want = evaluate_dataset(model, ds, batch=2, limit=2)
    assert got["num_samples"] == 2 and np.isfinite(got["epe"])
    assert got["epe"] == pytest.approx(want["epe"], rel=1e-6)


# -- K11 on a card ------------------------------------------------------------

# K11 against the plain versions: f32, the sums' order and exp2 for exp
# (relative 1e-5 of a value: of a map row's max for the map); bf16, the
# rules of ``ops.global_attention`` (each value within one bf16 step, a
# map's rows summing to 1 within 2**-9, K11's map through the plain
# aggregation within two steps of the largest value). The grids: the cell's
# (its 127 row blocks fill the card), 136x240, published GMA's Sintel grid
# 55x128 and the ragged 17x30 (row blocks too few: a cluster splits the
# keys), and 1x5 (P under one tile).
F32_TOL = 1e-5
K11_GRIDS = [(135, 240), (136, 240), (17, 30), (55, 128), (1, 5)]


def _qkvm(hw, dtype, dev, seed):
    """Queries and keys whose scaled scores spread by about 2 (peaked rows
    and flat ones), values and motion features, (1, P, 128); q and k are
    views into one (P, 256) buffer, as the model splits them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = hw[0] * hw[1]
    qk = (torch.randn((1, p, 256), generator=g, device=dev) * 1.2).to(dtype)
    v, m = (torch.randn((1, p, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    return qk[..., :128], qk[..., 128:], v, m


def _k11_errs(attn, want_attn, v, m, gamma):
    """K11's map and aggregations (motion features ``m`` and 0, so that
    the allowance is relative to ``gamma * A v`` alone) against the plain
    versions', by the rules of their dtype, and the rules' readings."""
    from pwcnet_tpu_torch.ops import global_attention as ga
    from pwcnet_tpu_torch.ops.kernels import global_attention_kernel as gk
    zero = torch.zeros_like(m)
    errs = {}
    for name, mm in (("m", m), ("0", zero)):
        got = gk.aggregate_cuda(want_attn, v, mm, gamma)
        want = aggregate_ref(want_attn, v, mm, gamma)
        if m.dtype == torch.float32:
            errs[f"aggregate_{name}"] = (rel_err(got, want), F32_TOL)
        else:
            floor = ga.AGGREGATE_FLOOR * float(want.float().abs().max())
            errs[f"aggregate_{name}"] = (ga.bf16_steps_off(got, want, floor),
                                         ga.BF16_STEPS)
    if m.dtype == torch.float32:
        rows = ((attn.double() - want_attn.double()).abs().amax(-1)
                / want_attn.double().amax(-1))
        errs["map"] = (float(rows.max()), F32_TOL)
    else:
        errs["map"] = (ga.bf16_steps_off(attn, want_attn), ga.BF16_STEPS)
        errs["row_sum"] = (ga.row_sum_err(attn), ga.ROW_SUM_TOL)
        via = [aggregate_ref(a, v, zero.float(), gamma)
               for a in (attn, want_attn)]
        errs["via_map"] = (rel_err(*via), ga.VIA_MAP_TOL)
    return errs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw", K11_GRIDS)
def test_k11_matches_the_plain_versions(hw, dtype):
    need_cuda()
    from pwcnet_tpu_torch.ops.kernels import global_attention_kernel as gk
    dev = torch.device("cuda")
    q, k, v, m = _qkvm(hw, dtype, dev, 11)
    gamma = torch.tensor([1.25], device=dev)
    with torch.no_grad():
        attn = gk.attention_map_cuda(q, k)
        want_attn = attention_map_ref(q, k)
        p = hw[0] * hw[1]
        assert attn.shape == want_attn.shape == (1, p, p)
        errs = _k11_errs(attn, want_attn, v, m, gamma)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, errs


@pytest.mark.cuda
def test_k11_takes_maps_of_any_pitch_and_a_batch():
    """A contiguous map of an odd P (rows not on 16 bytes) and a batch of
    two images with their own gamma-scaled sums."""
    need_cuda()
    from pwcnet_tpu_torch.ops.kernels import global_attention_kernel as gk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    p = 17 * 31
    q, k, v, m = (torch.randn((2, p, 128), generator=g, device=dev)
                  .bfloat16() for _ in range(4))
    gamma = torch.tensor([0.5], device=dev)
    with torch.no_grad():
        attn = attention_map_ref(q, k).contiguous()
        errs = _k11_errs(gk.attention_map_cuda(q, k), attn, v, m, gamma)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, errs


@pytest.mark.cuda
def test_k11_functions_give_the_plain_gradients():
    need_cuda()
    from pwcnet_tpu_torch.ops.global_attention import aggregate, attention_map
    dev = torch.device("cuda")
    q, k, v, m = (t.detach().clone().requires_grad_()
                  for t in _qkvm((7, 9), torch.float32, dev, 13))
    gamma = torch.tensor([0.75], device=dev, requires_grad=True)
    proj = torch.randn((1, 63, 128), device=dev)
    args = (q, k, v, m, gamma)
    got = torch.autograd.grad(
        (aggregate(attention_map(q, k), v, m, gamma) * proj).sum(), args)
    want = torch.autograd.grad(
        (aggregate_ref(attention_map_ref(q, k), v, m, gamma) * proj).sum(),
        args)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= F32_TOL


def _card_model(dev, dtype=torch.bfloat16, iters=4, backend="pallas"):
    model = GMA(num_iters=iters, dtype=dtype, device=dev,
                corr_backend=backend,
                generator=torch.Generator().manual_seed(14))
    model.load_state_dict({k: v.to(dev) for k, v in _weights(14).items()})
    return model.eval()


def _k11_launches(backend, hw=(136, 240), iters=4):
    from pwcnet_tpu_torch import trace
    dev = torch.device("cuda")
    model = _card_model(dev, iters=iters, backend=backend)
    im1, im2 = (t.to(dev) for t in shifted_pair(14, hw, torch_batch=True))
    counts = trace.counters("launches.global_attention")
    before = dict(counts)
    with torch.no_grad():
        model(im1, im2, train=False)
    return {k: counts[k] - before[k] for k in counts}


# A 136x240 pair's 17x30 grid has 2 row blocks: each aggregation splits.
K11_SMALL = {"map": 1, "aggregate": 4, "aggregate_split": 4}


@pytest.mark.cuda
def test_forward_launches_k11_once_a_pair_and_once_an_iteration():
    need_cuda()
    assert _k11_launches("pallas") == K11_SMALL


@pytest.mark.cuda
def test_lax_forward_on_the_card_launches_k11_too():
    """``corr_backend`` chooses K8/K9 alone: the attention of a ``"lax"``
    model on the card is K11's, as the encoders' norms are K10's."""
    need_cuda()
    assert _k11_launches("lax") == K11_SMALL


@pytest.mark.cuda
@pytest.mark.parametrize("hw, split", [((1080, 1920), 0), ((440, 1024), 32)])
def test_aggregations_split_their_keys_where_row_blocks_are_few(hw, split):
    """A 32-iteration forward: the cell's 135x240 grid (127 row blocks of
    256, enough for the card) splits no aggregation; published GMA's
    Sintel grid, 55x128 (28 row blocks), splits all 32."""
    need_cuda()
    assert _k11_launches("pallas", hw, 32) == {
        "map": 1, "aggregate": 32, "aggregate_split": split}


@pytest.fixture
def card(monkeypatch):
    """The card, with deterministic algorithms while the test runs."""
    need_cuda()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
def test_captured_forward_equals_the_eager_one(card):
    """``infer_flow`` replays a CUDA graph of the forward (K11's map and
    aggregations inside it); its flow equals the eager forward's bit for
    bit, on a second pair too."""
    from pwcnet_tpu_torch.train.evaluate import infer_flow
    model = _card_model(card)
    for seed in (15, 16):
        im1, im2 = (t.to(card) for t in shifted_pair(seed, (136, 240),
                                                      torch_batch=True))
        with torch.no_grad():
            eager = infer_flow(model, im1, im2, capture=False)
            captured = infer_flow(model, im1, im2, capture=True)
        assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_f32_card_forward_matches_the_cpu():
    """The f32 model on the card (K8, K9, K10, K11) against the CPU's plain
    ops at 64x128, with TF32 off."""
    need_cuda()
    dev = torch.device("cuda")
    w = _weights(16)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = _card_model(dev, torch.float32, 3)
        card.load_state_dict({k: v.to(dev) for k, v in w.items()})
        got, im1, im2 = _forward(w, seed=16)
        with torch.no_grad():
            on_card = card(im1.to(dev), im2.to(dev), train=False)[0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert rel_err(on_card.cpu(), got) <= MODEL_TOL


def _started(monkeypatch, backend, device):
    """The kernel names a GMA built on ``device`` asks ``build.start``
    for."""
    from pwcnet_tpu_torch.ops.kernels import build
    asked = []
    monkeypatch.setattr(build, "start", lambda names: asked.append(
        set(names)))
    GMA(num_iters=1, corr_backend=backend, device=device)
    return asked


def test_a_model_on_the_cpu_starts_no_build(monkeypatch):
    assert _started(monkeypatch, "pallas", "cpu") == []


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_a_model_on_the_card_starts_its_kernels_builds(monkeypatch,
                                                        backend):
    """Built on the card, GMA starts compiling K10 and K11 (and K8, K9
    under "pallas") side by side, once."""
    need_cuda()
    want = {"encoder_norm", "global_attention"}
    if backend == "pallas":
        want |= {"corr_pyramid", "corr_lookup"}
    assert _started(monkeypatch, backend, "cuda") == [want]


def test_reference_reuses_published_rafts_functions():
    """The reference's RAFT parts are ``raft_allpairs``' own functions."""
    assert ref.full_res is rap.full_res
    shapes = ref.param_shapes(CFG)
    base = rap.param_shapes(CFG)
    assert set(shapes) - set(base) == {"att.to_qk.weight",
                                       "aggregator.to_v.weight",
                                       "aggregator.gamma"}
