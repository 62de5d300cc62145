"""GMFlow with refinement in the port (``models/gmflow.py``,
``ops/window_attention.py``, ``ops/warp.py:flow_warp``) held against the
benchmark's plain float32 reference of the released code
(``flowbench/reference/gmflow.py``), on the CPU; K12
(``csrc/window_attention.cu``) against the plain version on a card (the
``cuda`` tests).

The JAX package has no GMFlow, so the reference is the plain PyTorch one.
Tensors are compared by relative max error, ``max|got - ref| <= tol *
max|ref|``, with each tolerance stated where it is used. This file imports
no JAX: on a card it runs with ``--noconftest``.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flowbench.reference import gmflow as ref
from flowbench.reference import raft_allpairs as rap
from flowbench.reference.ops import F32, Precision
from pwcnet_tpu_torch.config import PRESETS
from pwcnet_tpu_torch.models import gmflow as gm
from pwcnet_tpu_torch.models.layers import Conv
from pwcnet_tpu_torch.models.gmflow import GMFlow
from pwcnet_tpu_torch.models.pwcnet import _nchw, _nhwc
from pwcnet_tpu_torch.models.raft_allpairs import (BasicEncoder,
                                                   RAFTAllPairs,
                                                   ResidualBlock)
from pwcnet_tpu_torch.ops.warp import flow_warp, warp_bilinear
from pwcnet_tpu_torch.ops import window_attention as wa
from pwcnet_tpu_torch.ops.window_attention import window_attention_ref

from torch_port_util import (make_model, need_cuda, one_thread,  # noqa: F401
                             rel_err, shifted_pair)

# The model cases' frames: 1/8 grid 8x12 (2x2 windows of 4x6), 1/4 grid
# 16x24 (8x8 windows of 2x3).
HW = (64, 96)
CFG = dict(feature_channels=128, num_transformer_layers=6,
           ffn_dim_expansion=4, attn_splits_list=[2, 8],
           corr_radius_list=[-1, 4], prop_radius_list=[-1, 1],
           upsample_factor=4)
# The f32 port against the f32 reference, per stage (1/8 flow, 1/4 flow,
# final): the sums' order alone, amplified by the softmaxes of the
# matching, read 8e-6 to 5.4e-5 of max at seeds 1-3 (the features after the
# transformer 4e-6 to 6e-6).
TOL = 1e-4
# Within one window attention of f32 values: the sums' order alone.
ATTN_TOL = 1e-5
# The benchmark's LayerNorm weights (0.3 + a draw of std 0.03), and the
# released init's (1 + a draw of std 0.03).
LN_BENCH = (0.3, 0.03)
LN_RELEASED = (1.0, 0.03)
# The f32 port against the f32 reference under LN_RELEASED, per stage: the
# features grow through the twelve residual layers and the matching
# softmaxes sharpen, so the sums' order alone read 1.1e-5 to 4.6e-5 of max
# at 1/8, 6.0e-5 to 1.12e-3 at 1/4 and 6.0e-5 to 9.7e-4 at the end, at
# seeds 1-16; the same port reads 8e-6 to 1.8e-5 there under LN_BENCH.
TOL_RELEASED = (1e-4, 4e-3, 4e-3)


def _weights(seed: int, cfg=CFG, ln=LN_BENCH) -> dict:
    """The benchmark's law (``flowbench/drivers/stream_gmflow.py``): conv
    and linear weights of std sqrt(1 / fan_in), clamped at two; LayerNorm
    weights ``ln[0]`` + a draw of std ``ln[1]``; biases of std 0.01."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in sorted(ref.param_shapes(cfg).items()):
        x = torch.randn(shape, generator=g)
        if k.endswith(".weight") and len(shape) > 1:
            out[k] = x.clamp(-2, 2) * math.prod(shape[1:]) ** -0.5
        elif k.endswith(".weight"):
            out[k] = ln[0] + ln[1] * x
        else:
            out[k] = 0.01 * x
    return out


def _model(seed, backend="pallas", dtype=torch.float32, device="cpu",
           ln=LN_BENCH):
    model = make_model("gmflow", corr_backend=backend, dtype=dtype,
                       device=device)
    model.load_state_dict({k: v.to(device) for k, v in
                           _weights(seed, ln=ln).items()})
    return model


def _pair(seed, hw=HW):
    im1, im2 = shifted_pair(seed, hw, torch_batch=True)
    return im1, im2


# -- the window attention ----------------------------------------------------

def _released(q, k, v, splits, shifted, kv_offset):
    """The released formulation, with the reference's functions (roll,
    split, additive mask, softmax, merge, un-roll) on (B, H, W, C)
    tensors; the keys and values of image (b + kv_offset) mod B."""
    b, h, w, c = q.shape
    k, v = (torch.roll(t, -kv_offset, 0) for t in (k, v))
    vw = v.shape[-1]
    if splits == 1:
        out = ref._attend(q.reshape(b, -1, c), k.reshape(b, -1, c),
                          v.reshape(b, -1, vw), F32)
        return out.view(b, h, w, vw)
    wh, ww = h // splits, w // splits
    mask = ref.shift_window_attn_mask(h, w, wh, ww, wh // 2, ww // 2, "cpu")
    if vw != c:   # the split version takes one width: pad v to C
        v = F.pad(v, (0, c - vw))
    out = ref.split_window_attention(q.reshape(b, -1, c), k.reshape(b, -1, c),
                                     v.reshape(b, -1, c), splits, shifted,
                                     h, w, mask, F32)
    return out.view(b, h, w, c)[..., :vw]


@pytest.mark.parametrize("h, w, splits, shifted, vw, off", [
    (8, 12, 2, False, 128, 0),
    (8, 12, 2, True, 128, 1),
    (16, 24, 8, True, 128, 1),
    (16, 24, 8, True, 2, 0),
    (12, 18, 3, True, 128, 1),    # 4x6 windows, odd splits
    (6, 10, 2, True, 2, 1),       # 3x5 windows: odd halves
    (8, 12, 1, False, 2, 0),      # global
    (8, 12, 1, False, 128, 1),
])
def test_plain_window_attention_is_the_released_formulation(h, w, splits,
                                                            shifted, vw,
                                                            off):
    g = torch.Generator().manual_seed(h * w + splits + vw + off)
    q, k = (3 * torch.randn((2, h, w, 128), generator=g) for _ in range(2))
    v = torch.randn((2, h, w, vw), generator=g)
    got = window_attention_ref(q, k, v, splits, shifted, off)
    want = _released(q, k, v, splits, shifted, off)
    assert rel_err(got, want) <= ATTN_TOL


def test_the_shifted_mask_reaches_the_answer():
    """Shifted and unshifted windows give different answers, and a window
    that is not in the last row or column has no mask: its rolled tokens
    equal the unmasked attention over the same rolled window."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((1, 12, 18, 128), generator=g) for _ in range(3))
    shifted = window_attention_ref(q, k, v, 3, True)
    assert rel_err(window_attention_ref(q, k, v, 3, False), shifted) > 0.1
    # Window (0, 0) of the rolled frame holds pixels rows 2..5, columns
    # 3..8: one region, so the mask takes nothing from it.
    sub = [t[:, 2:6, 3:9] for t in (q, k, v)]
    assert rel_err(shifted[:, 2:6, 3:9],
                   window_attention_ref(*sub, 1)) <= ATTN_TOL


def test_bf16_plain_version_rounds_probabilities_and_output_once():
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn((2, 8, 12, 128), generator=g).bfloat16()
               for _ in range(3))
    got = window_attention_ref(q, k, v, 2, True, 1)
    assert got.dtype == torch.bfloat16
    exact = window_attention_ref(q.float(), k.float(), v.float(), 2, True, 1)
    # Each probability to bf16 (2**-9 of it), the output once (2**-9).
    assert rel_err(got, exact, float(v.float().abs().max())) <= 2.0 ** -8


def test_window_arguments_are_checked():
    x = torch.zeros((1, 8, 12, 128))
    with pytest.raises(ValueError, match="do not tile"):
        window_attention_ref(x, x, x, 5)
    with pytest.raises(ValueError, match="shifted windows"):
        window_attention_ref(x, x, x, 1, True)
    y = torch.zeros((1, 8, 16, 128))   # 8 x 8 windows of 1 x 2
    with pytest.raises(ValueError, match="shifted windows"):
        window_attention_ref(y, y, y, 8, True)


# -- the parts ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_flow_warp_is_grid_sample_without_a_mask(seed):
    """``flow_warp`` equals ``F.grid_sample(align_corners=True, zeros)`` at
    the grid plus the flow, flows reaching out of the frame included, where
    ``warp_bilinear`` zeroes the pixels whose coverage is short."""
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((2, 9, 13, 5), generator=g)
    flow = 4 * torch.randn((2, 9, 13, 2), generator=g)
    got = flow_warp(feat, flow)
    want = _nhwc(ref.flow_warp(_nchw(feat), _nchw(flow)))
    assert rel_err(got, want) <= 1e-6
    masked = warp_bilinear(feat, flow)
    assert not torch.equal(masked, got)
    # bf16 features are blended in f32 and rounded once.
    b16 = feat.bfloat16()
    assert torch.equal(flow_warp(b16, flow), flow_warp(b16.float(),
                                                       flow).bfloat16())


def test_position_encoding_is_the_released_one():
    x = torch.zeros((3, 128, 5, 7))
    want = ref.position_embedding_sine(x, 64)[0]
    got = gm.position_encoding(5, 7, 128, "cpu")
    assert rel_err(got, want.permute(1, 2, 0)) <= 1e-6


def test_added_position_is_the_released_one():
    g = torch.Generator().manual_seed(3)
    f = torch.randn((2, 128, 16, 24), generator=g)
    got = gm._add_position(_nhwc(f), 8)
    a, b = ref.feature_add_position(f[:1], f[1:], 8, 128)
    assert rel_err(got, _nhwc(torch.cat([a, b]))) <= 1e-6


def test_local_matching_and_propagation_are_the_released_ones():
    """The port's local matching (K1's plain correlation over sqrt(C), the
    mask from positions, the expected offset) and 3x3 propagation against
    the released ``local_correlation_softmax`` and
    ``forward_local_window_attn``."""
    g = torch.Generator().manual_seed(4)
    f0, f1 = (torch.randn((1, 16, 24, 128), generator=g) for _ in range(2))
    model = _model(4)
    got = model._local_match(f0, f1, 4)
    want = ref.local_correlation_softmax(_nchw(f0), _nchw(f1), 4, F32)
    assert rel_err(got, _nhwc(want)) <= 1e-5
    flow = 3 * torch.randn((1, 16, 24, 2), generator=g)
    with torch.no_grad():
        got = model.feature_flow_attn(f0, flow, 1)
        want = ref.feature_flow_attention(_weights(4), _nchw(f0),
                                          _nchw(flow), 1, F32)
    assert rel_err(got, _nhwc(want)) <= 1e-5


def test_backbone_is_the_released_one():
    w = _weights(5)
    model = _model(5)
    im1, im2 = _pair(5)
    mean = torch.tensor(ref.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(ref.STD).view(1, 3, 1, 1)
    with torch.no_grad():
        f8, f4 = model._features(im1, im2)
        r4, r8 = ref.backbone(w, (_nchw(torch.cat([im1, im2])) - mean) / std,
                              F32)
    assert f8.shape == (2, 8, 12, 128) and f4.shape == (2, 16, 24, 128)
    assert rel_err(f8, _nhwc(r8)) <= 1e-5 and rel_err(f4, _nhwc(r4)) <= 1e-5


# -- the generalised encoder -------------------------------------------------

def test_residual_block_keeps_published_rafts_keys_and_outputs():
    """RAFT's encoder after the generalisation: the same keys as published
    RAFT's reference, and its output within f32 rounding of it; a block
    without biases has none, and projects where only the width changes."""
    enc = BasicEncoder(256, "instance")
    keys = {k[len("fnet."):] for k in rap.param_shapes(
        dict(feature_dim=256, hidden_dim=128, context_dim=128,
             corr_levels=4, corr_radius=4)) if k.startswith("fnet.")}
    assert set(enc.state_dict()) == keys
    g = torch.Generator().manual_seed(6)
    w = {"fnet." + k: torch.randn(v.shape, generator=g) * (
        v[0].numel() ** -0.5 if v.dim() > 1 else 0.1)
        for k, v in enc.state_dict().items()}
    enc.load_state_dict({k[5:]: v for k, v in w.items()})
    x = torch.randn((1, 3, 64, 96), generator=g)
    with torch.no_grad():
        got = enc(x)
        want = rap.encoder(w, "fnet", x, "instance", F32)
    assert rel_err(got, want) <= 1e-5
    block = ResidualBlock(96, 128, "instance", 1, bias=False)
    assert set(block.state_dict()) == {"conv1.weight", "conv2.weight",
                                       "down.weight", "down.bias"}
    assert ResidualBlock(64, 64, "instance", 1).down is None


def test_published_rafts_parameters_are_unchanged():
    """Published RAFT's parameter count and init draws: the bias-free
    option leaves its convs as they were."""
    a = RAFTAllPairs(num_iters=1, device="cpu",
                     generator=torch.Generator().manual_seed(2))
    assert sum(p.numel() for p in a.parameters()) == 5257536
    assert all(m.bias is not None for m in a.modules()
               if isinstance(m, Conv))


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_f32_model_matches_the_reference_per_stage(seed):
    w = _weights(seed)
    model = _model(seed)
    im1, im2 = _pair(seed)
    with torch.no_grad():
        got = model(im1, im2)
        want = ref.forward(w, CFG, im1, im2)
    assert [tuple(t.shape) for t in got] == [(1, 8, 12, 2), (1, 16, 24, 2),
                                             (1, 64, 96, 2)]
    for a, b in zip(got, want):
        assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("seed", [2, 8])
def test_f32_model_matches_the_reference_near_the_released_init(seed):
    """Under the released init's LayerNorm weights, where the f32 sums'
    order alone moves the flow more (TOL_RELEASED's readings)."""
    w = _weights(seed, ln=LN_RELEASED)
    model = _model(seed, ln=LN_RELEASED)
    im1, im2 = _pair(seed)
    with torch.no_grad():
        got = model(im1, im2)
        want = ref.forward(w, CFG, im1, im2)
    for a, b, tol in zip(got, want, TOL_RELEASED):
        assert rel_err(a, b) <= tol


def test_no_shift_moves_the_flow():
    """The reference with every block unshifted (the benchmark's
    ``no_shift`` control) lies far from the shifted answer."""
    w = _weights(7)
    im1, im2 = _pair(7)
    with torch.no_grad():
        a = ref.forward(w, CFG, im1, im2)[-1]
        b = ref.forward(w, CFG, im1, im2, shift=False)[-1]
    assert rel_err(b, a) > 0.01


def test_bf16_model_is_nearer_the_reference_than_fp8():
    w = _weights(8)
    model = _model(8, dtype=torch.bfloat16)
    im1, im2 = _pair(8)
    with torch.no_grad():
        got = model(im1, im2)[-1]
        want = ref.forward(w, CFG, im1, im2)[-1]
        fp8 = ref.forward(w, CFG, im1, im2, Precision("fp8"))[-1]
    assert got.dtype == torch.float32
    assert rel_err(got, want) < rel_err(fp8, want)


def test_lax_and_pallas_agree_on_the_cpu(one_thread):
    """On CPU tensors both backends run the same plain ops."""
    im1, im2 = _pair(9)
    with torch.no_grad():
        a = _model(9, "pallas")(im1, im2)[-1]
        b = _model(9, "lax")(im1, im2)[-1]
    assert torch.equal(a, b)


def test_state_dict_keys_are_the_references():
    sd = make_model("gmflow").state_dict()
    shapes = ref.param_shapes(CFG)
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    # The released model's 4.68 M parameters (its LayerNorms' too).
    assert sum(v.numel() for v in sd.values()) == 4716720


def test_forward_refuses_training_and_sizes_off_the_divisor():
    model = make_model("gmflow")
    im = torch.zeros((1, 64, 96, 3))
    with pytest.raises(ValueError, match="inference only"):
        model(im, im, train=True)
    with pytest.raises(ValueError, match="divisible by 32"):
        model(im[:, :48], im[:, :48])


# -- the trainer's routing and the entry points ------------------------------

def test_build_model_routes_the_family():
    from pwcnet_tpu_torch.config import apply_overrides
    from pwcnet_tpu_torch.train.loop import build_model
    cfg = apply_overrides(PRESETS["chairs-1chip"], [
        "model.family=gmflow", "model.dtype=float32",
        "model.corr_backend=lax"])
    model = build_model(cfg, "cpu")
    assert isinstance(model, GMFlow)
    assert model.pad_divisor == 32 and model.corr_backend == "lax"
    assert model.dtype == torch.float32
    assert model.attn_splits == (2, 8) and model.corr_radius == (-1, 4)


def test_predict_flow_pads_to_32_and_crops():
    from pwcnet_tpu_torch.train.evaluate import pad_to_divisible, predict_flow
    model = _model(11)
    rng = np.random.default_rng(11)
    im1 = rng.random((60, 90, 3)).astype(np.float32)
    im2 = np.roll(im1, 2, 1)
    flow = predict_flow(model, im1, im2)
    assert flow.shape == (60, 90, 2) and flow.dtype == np.float32
    p1, _ = pad_to_divisible(im1[None], 32)
    p2, _ = pad_to_divisible(im2[None], 32)
    with torch.no_grad():
        full = model(torch.from_numpy(p1), torch.from_numpy(p2))[-1]
    np.testing.assert_array_equal(flow, full[0, :60, :90].numpy())


def test_launch_counters_are_the_registry_group():
    from pwcnet_tpu_torch import trace
    from pwcnet_tpu_torch.ops.kernels import window_attention_kernel as wk
    assert wk.LAUNCHES is trace.counters("launches.window_attention")
    assert set(wk.LAUNCHES) == {"window", "shifted", "global"}
    before = dict(wk.LAUNCHES)
    with torch.no_grad():
        _model(12)(*_pair(12))
    assert dict(wk.LAUNCHES) == before   # the CPU launches nothing


def _started(monkeypatch, backend, device):
    from pwcnet_tpu_torch.ops.kernels import build
    asked = []
    monkeypatch.setattr(build, "start", lambda names: asked.append(
        set(names)))
    GMFlow(corr_backend=backend, device=device)
    return asked


def test_a_model_on_the_cpu_starts_no_build(monkeypatch):
    assert _started(monkeypatch, "pallas", "cpu") == []


# -- K12 on the card ---------------------------------------------------------

# K12 against the plain version: ``ops/window_attention.py``'s rule, with
# its reasons (read on an H100: 2.3e-3 to 4.4e-3 of max|v| in bf16 at the
# cell's shapes and at ragged ones; 2e-7 to 2.1e-6 of the output's max at
# width 2 and in f32).
K12_BF16_TOL = wa.BF16_TOL
K12_F32_TOL = wa.F32_TOL


def _gap(a, b):
    return float((a.float() - b.float()).abs().max())


K12_CASES = [
    # (bq, bk, h, w, splits, shifted, kv_offset, vw, dtype)
    (2, 2, 8, 12, 2, True, 1, 128, torch.float32),
    (2, 2, 16, 24, 8, True, 1, 2, torch.float32),
    (1, 1, 8, 12, 1, False, 0, 2, torch.float32),
    (2, 2, 66, 90, 3, True, 1, 128, torch.float32),
    (2, 2, 8, 12, 2, False, 0, 128, torch.bfloat16),
    (2, 2, 16, 24, 8, True, 1, 128, torch.bfloat16),
    (2, 2, 34, 58, 2, True, 1, 128, torch.bfloat16),    # ragged tiles
    (2, 2, 136, 240, 2, True, 1, 128, torch.bfloat16),  # the cell's 1/8
    (2, 2, 272, 480, 8, False, 0, 128, torch.bfloat16),  # the cell's 1/4
    (1, 1, 136, 240, 1, False, 0, 2, torch.bfloat16),   # global matching
    (2, 2, 16, 24, 8, False, 1, 2, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K12_CASES,
                         ids=lambda c: "-".join(map(str, c[2:8])))
def test_k12_matches_the_plain_version(case):
    need_cuda()
    from pwcnet_tpu_torch.ops.kernels import window_attention_kernel as wk
    bq, bk, h, w, splits, shifted, off, vw, dt = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(h * w + vw)
    q = (2 * torch.randn((bq, h, w, 128), generator=g, device=dev)).to(dt)
    k = (2 * torch.randn((bk, h, w, 128), generator=g, device=dev)).to(dt)
    vdt = dt if vw == 128 else torch.float32
    v = (5 * torch.randn((bk, h, w, vw), generator=g, device=dev)).to(vdt)
    got = wk.window_attention_cuda(q, k, v, splits, shifted, off)
    want = window_attention_ref(q, k, v, splits, shifted, off)
    tol = K12_BF16_TOL if vdt == torch.bfloat16 else K12_F32_TOL
    assert got.dtype == vdt and bool(torch.isfinite(got).all())
    assert _gap(got, want) <= tol * float(v.float().abs().max())


@pytest.mark.cuda
def test_k12_reads_strided_views_and_refuses_bad_windows():
    """q, k and v as views of one fused projection (token pitch 384) need
    no copy; windows that do not tile the grid are refused."""
    need_cuda()
    from pwcnet_tpu_torch.ops.kernels import window_attention_kernel as wk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 16, 24, 384), generator=g, device=dev).bfloat16()
    q, k, v = qkv[..., :128], qkv[..., 128:256], qkv[..., 256:]
    got = wk.window_attention_cuda(q, k, v, 8, True, 1)
    want = window_attention_ref(q, k, v, 8, True, 1)
    assert _gap(got, want) <= K12_BF16_TOL * float(v.float().abs().max())
    with pytest.raises(ValueError, match="do not tile"):
        wk.window_attention_cuda(q, k, v, 5)


def _card_model(dev, dtype=torch.bfloat16, backend="pallas", seed=14):
    return _model(seed, backend, dtype, dev)


@pytest.mark.cuda
def test_forward_launches_k12_26_times():
    """A forward at the cell's 1088x1920: 12 unshifted, 12 shifted and 2
    global K12 launches (6 blocks x self and cross x 2 scales, the global
    matching and the global propagation)."""
    need_cuda()
    from pwcnet_tpu_torch import trace
    dev = torch.device("cuda")
    model = _card_model(dev)
    im1, im2 = (t.to(dev) for t in _pair(14, (1088, 1920)))
    counts = trace.counters("launches.window_attention")
    before = dict(counts)
    with torch.no_grad():
        model(im1, im2)
    assert {k: counts[k] - before[k] for k in counts} == {
        "window": 12, "shifted": 12, "global": 2}


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
    """``infer_flow`` replays a CUDA graph of the forward (K12 inside it);
    its flow equals the eager forward's bit for bit, on a second pair
    too."""
    from pwcnet_tpu_torch.train.evaluate import infer_flow
    model = _card_model(card)
    for seed in (15, 16):
        im1, im2 = (t.to(card) for t in _pair(seed, (128, 256)))
        with torch.no_grad():
            eager = infer_flow(model, im1, im2, capture=False)
            captured = infer_flow(model, im1, im2, capture=True)
        assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_f32_card_forward_matches_the_cpu():
    """The f32 model on the card (K1, K10, K12) against the CPU's plain
    ops at 64x96, per stage, with TF32 off."""
    need_cuda()
    dev = torch.device("cuda")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = _card_model(dev, torch.float32, seed=16)
        im1, im2 = _pair(16)
        with torch.no_grad():
            on_card = card(im1.to(dev), im2.to(dev))
            cpu = _model(16)(im1, im2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    for a, b in zip(on_card, cpu):
        assert rel_err(a.cpu(), b) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "lax"])
def test_a_model_on_the_card_starts_its_kernels_builds(monkeypatch,
                                                        backend):
    """Built on the card, GMFlow starts compiling K10 and K12 (and K1
    under "pallas") side by side, once."""
    need_cuda()
    want = {"encoder_norm", "window_attention"}
    if backend == "pallas":
        want |= {"cost_volume"}
    assert _started(monkeypatch, backend, "cuda") == [want]
