"""``predict_flow``'s staged entry (``pwcnet_tpu_torch/train/evaluate.py``):
each frame pair goes through a host buffer and a device buffer laid out as
the padded pair, both reused across calls. Held bit for bit to the host
pad it replaced (``pad_to_divisible``, a fresh tensor per frame, the
forward, the crop) for the four families at a ragged and at a divisible
size; answers kept across calls stay as they were and share no memory with
the reused buffers; the ``predict_flow`` counters. The ``cuda`` test runs
the captured forward on a card and skips here.

No JAX here: the reference is the port's own forward on host-padded
frames.
"""

import gc
import sys
import threading

import numpy as np
import pytest
import torch

import pwcnet_tpu_torch.train.evaluate as evaluate_mod
from pwcnet_tpu_torch import trace
from pwcnet_tpu_torch.train.evaluate import (infer_flow, pad_to_divisible,
                                             predict_flow)

from torch_port_util import make_model, one_thread, shifted_pair

FAMILIES = ["pwcnet", "raft", "raft_allpairs", "gma"]
SIZES = {"ragged": (60, 90), "divisible": (64, 128)}
# The models on the CPU: PWC-Net with 3 levels, the others 2 iterations.
FAMILY_KW = {"pwcnet": dict(num_levels=3, output_level=2),
             "raft": dict(num_iters=2), "raft_allpairs": dict(num_iters=2),
             "gma": dict(num_iters=2)}


def _host_pad_flow(model, im1, im2, capture=False) -> np.ndarray:
    """The entry as it was: both frames padded on the host into fresh
    arrays, each uploaded as a fresh tensor, the forward, the crop.

    A frame that needed no padding reached the model as
    ``np.asarray(im)[None]`` itself, whose new batch axis has stride 0
    (``torch.tensor`` keeps numpy's strides). RAFT's context encoder
    then reads its input as not channels-last and rounds differently
    (1.2e-6 on the CPU at 64x128, 1.5e-6 in the flow). The copy gives every
    frame the layout of a padded one, the layout the staged entry gives
    all."""
    p1, (h, w) = pad_to_divisible(np.asarray(im1, np.float32)[None],
                                  model.pad_divisor)
    p2, _ = pad_to_divisible(np.asarray(im2, np.float32)[None],
                             model.pad_divisor)
    full = infer_flow(model,
                      torch.tensor(p1.copy(order="C"), device=model.device),
                      torch.tensor(p2.copy(order="C"), device=model.device),
                      capture)
    return full[0, :h, :w].float().cpu().numpy()


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("family", FAMILIES)
def test_staged_entry_equals_host_pad(one_thread, family, size):
    model = make_model(family, FAMILIES.index(family),
                       **FAMILY_KW[family]).eval()
    hw = SIZES[size]
    im1, im2 = shifted_pair(0, hw, 0.9)
    got = predict_flow(model, im1, im2)
    assert got.shape == (*hw, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _host_pad_flow(model, im1, im2))


@pytest.mark.parametrize("family", FAMILIES)
def test_kept_answers_are_the_callers_own(one_thread, family):
    """Two calls with different frames: the first answer is unchanged by
    the second, writable, and shares no memory with the stage's buffers;
    the margin of the padded buffer is still zero."""
    model = make_model(family, FAMILIES.index(family),
                       **FAMILY_KW[family]).eval()
    hw = SIZES["ragged"]
    (a1, a2), (b1, b2) = shifted_pair(1, hw, 0.9), shifted_pair(2, hw, 0.9)
    first = predict_flow(model, a1, a2)
    kept = first.copy()
    second = predict_flow(model, b1, b2)
    np.testing.assert_array_equal(first, kept)
    np.testing.assert_array_equal(second, _host_pad_flow(model, b1, b2))
    assert not np.array_equal(first, second)
    assert first.flags.writeable
    [stage] = evaluate_mod._STAGES[model].values()
    for buf in (stage.host, stage.padded):
        for answer in (first, second):
            assert not np.shares_memory(answer, buf.numpy())
    h, w = hw
    assert not stage.padded[:, h:].any() and not stage.padded[:, :, w:].any()


@pytest.mark.parametrize("form", ["read_only", "float64", "reversed",
                                  "channels_last_view"])
def test_frames_in_any_numpy_form(one_thread, form):
    """Read-only, non-f32, reversed or strided frames give what
    ``np.asarray(im, np.float32)`` gives through the host pad."""
    model = make_model("pwcnet", **FAMILY_KW["pwcnet"])
    im1, im2 = shifted_pair(3, SIZES["ragged"], 0.9)
    if form == "read_only":
        im1.flags.writeable = False
    elif form == "float64":
        im1 = im1.astype(np.float64) + 1e-9
    elif form == "reversed":
        im1 = np.ascontiguousarray(im1[::-1])[::-1]
    else:  # a strided view of a (3, H, W) planar image
        im1 = np.ascontiguousarray(np.moveaxis(im1, -1, 0))
        im1 = np.moveaxis(im1, 0, -1)
    np.testing.assert_array_equal(predict_flow(model, im1, im2),
                                  _host_pad_flow(model, im1, im2))


def test_frames_of_two_shapes_are_refused():
    model = make_model("pwcnet", **FAMILY_KW["pwcnet"])
    im1, _ = shifted_pair(4, SIZES["ragged"], 0.9)
    with pytest.raises(ValueError, match="two \\(H, W, C\\) frames"):
        predict_flow(model, im1, im1[:, :-8])
    with pytest.raises(ValueError, match="two \\(H, W, C\\) frames"):
        predict_flow(model, im1[..., 0], im1[..., 0])


def test_counters_on_the_cpu():
    """``calls`` rises by one a call; nothing is pinned for a CPU model."""
    model = make_model("pwcnet", **FAMILY_KW["pwcnet"])
    counts = trace.counters("predict_flow")
    before = dict(counts)
    for seed in range(3):
        predict_flow(model, *shifted_pair(seed, SIZES["ragged"], 0.9))
    assert counts["calls"] == before["calls"] + 3
    assert counts["pinned_uploads"] == before["pinned_uploads"]


def test_threads_sharing_a_model_take_turns():
    """Six threads call one model, each with its own frames of one shape,
    under a short switch interval: every answer equals its own frames'
    (without the stage's lock the threads overwrite each other's frames)."""
    model = make_model("pwcnet", **FAMILY_KW["pwcnet"])
    hw = SIZES["ragged"]
    pairs = [shifted_pair(20 + i, hw, 0.9) for i in range(6)]
    want = [predict_flow(model, *p) for p in pairs]
    got = [[] for _ in pairs]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda i=i: [got[i].append(predict_flow(model, *pairs[i]))
                                for _ in range(3)]) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    for i in range(6):
        assert len(got[i]) == 3
        for g in got[i]:
            np.testing.assert_array_equal(g, want[i])


def test_stages_live_with_the_model():
    """One stage per frame shape, made once; it goes when the model goes."""
    model = make_model("pwcnet", **FAMILY_KW["pwcnet"])
    for hw in (SIZES["ragged"], SIZES["divisible"], SIZES["ragged"]):
        predict_flow(model, *shifted_pair(5, hw, 0.9))
    stages = evaluate_mod._STAGES[model]
    assert sorted(k[1] for k in stages) == [(60, 90, 3), (64, 128, 3)]
    assert stages[(torch.device("cpu"), (60, 90, 3))].padded.shape == \
        (2, 64, 96, 3)
    n = len(evaluate_mod._STAGES)
    del model, stages
    gc.collect()
    assert len(evaluate_mod._STAGES) == n - 1


@pytest.fixture
def card(monkeypatch):
    """The card, with deterministic algorithms while the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_staged_entry_equals_host_pad(card, family):
    """At Sintel's 436x1024 in bf16, captured: the staged entry equals the
    host pad bit for bit; two pairs alternated over six calls each get
    their own answer (the pinned buffer is rewritten only after its copy
    has run), kept answers stay as they were, and every call makes one
    pinned upload."""
    model = make_model(family, FAMILIES.index(family), device=card,
                       dtype=torch.bfloat16).eval()
    pairs = [shifted_pair(10 + i, (436, 1024), 0.9) for i in range(2)]
    want = [_host_pad_flow(model, *p, capture=True) for p in pairs]
    counts = trace.counters("predict_flow")
    before = dict(counts)
    kept = []
    for i in range(6):
        got = predict_flow(model, *pairs[i % 2], capture=True)
        np.testing.assert_array_equal(got, want[i % 2])
        kept.append(got)
    for i, got in enumerate(kept):
        np.testing.assert_array_equal(got, want[i % 2])
    assert counts["calls"] == before["calls"] + 6
    assert counts["pinned_uploads"] == before["pinned_uploads"] + 6
    [stage] = evaluate_mod._STAGES[model].values()
    assert stage.host.is_pinned() and stage.padded.is_cuda
