"""The port's two-view front-end (``pwcnet_tpu_torch/frontend.py``) and the
command line's ``match`` held against the JAX package's, on the CPU.

``fb_consistency`` on the same numpy flows; ``match_two_view`` with the
same weights (bridged) for PWC-Net at init and for RAFT with the trained
checkpoint, whose flows are real. Dense fields are compared by relative max
error, ``max|got - ref| <= 1e-4 * max|ref|``; the matches themselves, which
threshold the forward-backward error at ``fb_threshold``, must be the same
points.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from pwcnet_tpu import frontend as jfront
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.models.raft import RAFT as JaxRAFT
import pwcnet_tpu_torch.config as tconfig
from pwcnet_tpu_torch import PWCNet, cli
from pwcnet_tpu_torch import frontend as tfront
from pwcnet_tpu_torch.compat import load_flax_params, read_flax_npz
from pwcnet_tpu_torch.data.base import read_image
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
from pwcnet_tpu_torch.models import RAFT
from pwcnet_tpu_torch.train.loop import build_model

from torch_port_util import jax_npz_params, rel_err

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "parity"
NPZ = REPO / "runs" / "raft-synthetic" / "params_step20000_bf16.npz"
TOL = 1e-4


def test_fb_consistency_matches_jax():
    rng = np.random.default_rng(0)
    fw = (4 * rng.standard_normal((40, 56, 2))).astype(np.float32)
    bw = (-fw + 0.3 * rng.standard_normal(fw.shape)).astype(np.float32)
    got = tfront.fb_consistency(fw, bw, device="cpu")
    want = jfront.fb_consistency(fw, bw)
    assert got.shape == (40, 56) and got.dtype == np.float32
    assert rel_err(got, want, floor=1e-30) <= 1e-6


def _pwcnet_pair():
    rng = np.random.default_rng(1)
    im1 = rng.random((100, 150, 3)).astype(np.float32)
    im2 = np.clip(np.roll(im1, (1, 2), (0, 1))
                  + 0.05 * rng.standard_normal(im1.shape), 0, 1
                  ).astype(np.float32)
    jm = JaxPWCNet(corr_backend="lax")
    pad = np.zeros((1, 128, 192, 3), np.float32)
    params = jax.jit(jm.init)(jax.random.key(0), pad, pad)
    model = PWCNet(device="cpu").eval()
    load_flax_params(model, jax.device_get(params)["params"])
    return jm, params, model, im1, im2


def _raft_pair():
    s = SyntheticFlow(split="val", hw=(128, 160))[1]
    model = RAFT(device="cpu").eval()
    load_flax_params(model, read_flax_npz(str(NPZ)))
    return (JaxRAFT(corr_backend="lax"), jax_npz_params(NPZ), model, s["im1"],
            s["im2"])


@pytest.mark.parametrize("family", ["pwcnet", "raft"])
def test_match_two_view_matches_jax(family):
    jm, params, model, im1, im2 = (_pwcnet_pair if family == "pwcnet"
                                   else _raft_pair)()
    want = jfront.match_two_view(jm, params, im1, im2, grid_step=6)
    got = tfront.match_two_view(model, im1, im2, grid_step=6)
    assert got["flow"].shape == (*im1.shape[:2], 2)
    assert rel_err(got["flow"], want["flow"], floor=1e-30) <= TOL
    assert np.abs(got["fb_error"] - want["fb_error"]).max() <= TOL * max(
        np.abs(want["flow"]).max(), 1.0)
    assert len(got["pts1"]) == len(want["pts1"]) > 0
    for k in ("pts1", "pts2", "confidence"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
    if family == "raft":  # trained: real motion, and most points consistent
        assert np.abs(want["flow"]).max() > 1.0
        assert len(want["pts1"]) > 0.5 * (128 // 6) * (160 // 6)


@pytest.mark.parametrize("family", ["pwcnet", "raft"])
def test_match_command_writes_the_matches(tmp_path, monkeypatch, capsys,
                                          family):
    """cli match, in this process on the CPU: the file holds the matches
    of match_two_view for the config's model (seed 0) on the same images."""
    import json
    overrides = ["model.dtype=float32", f"model.family={family}"]
    out = tmp_path / "matches.txt"
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    assert cli.main(["match", "--im1", str(FIXTURES / "im1.png"), "--im2",
                     str(FIXTURES / "im2.png"), "--out", str(out),
                     "--grid-step", "8", *overrides]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = tconfig.apply_overrides(tconfig.Config(), overrides)
    want = tfront.match_two_view(
        build_model(cfg, "cpu").eval(), read_image(str(FIXTURES / "im1.png")),
        read_image(str(FIXTURES / "im2.png")), grid_step=8)
    rows = np.loadtxt(out, ndmin=2)
    assert printed["num_matches"] == len(rows) == len(want["pts1"])
    np.testing.assert_allclose(rows, np.concatenate(
        [want["pts1"], want["pts2"], want["confidence"][:, None]], 1),
        rtol=0, atol=1e-3)
