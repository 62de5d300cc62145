"""The port's command line, evaluation, data and file formats held against
the JAX package's, on the CPU (``PWCNET_PLATFORM=cpu``).

The CLI runs in this process through ``pwcnet_tpu_torch.cli.main``; the
JAX side through its own functions (``cmd_config``, ``evaluate_dataset``,
the readers of ``pwcnet_tpu.io``). Inputs come from numpy with a seed.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import pwcnet_tpu.cli as jcli
import pwcnet_tpu.config as jconfig
import pwcnet_tpu.data.base as jbase
import pwcnet_tpu.data.pipeline as jpipe
import pwcnet_tpu.io as jio
from pwcnet_tpu.data.synthetic import SyntheticFlow as JaxSyntheticFlow
from pwcnet_tpu.train.evaluate import evaluate_dataset as jax_evaluate
from pwcnet_tpu.train.loop import build_model as jax_build_model
import pwcnet_tpu_torch.config as tconfig
from pwcnet_tpu_torch import cli
from pwcnet_tpu_torch.compat import load_flax_params
from pwcnet_tpu_torch.data import base as tbase
from pwcnet_tpu_torch.data import pipeline as tpipe
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
from pwcnet_tpu_torch.io import flow_to_rgb, make_color_wheel, png
from pwcnet_tpu_torch.io import read_kitti_png, write_kitti_png
from pwcnet_tpu_torch.parallel.launch import free_port
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.evaluate import predict_flow
from pwcnet_tpu_torch.train.loop import build_model
from pwcnet_tpu_torch.train.schedule import optimizer_from_config
from pwcnet_tpu_torch.train.state import TrainState

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "parity"


def _shared(a, b):
    """The fields two nested config dicts share, from each."""
    if isinstance(a, dict) and isinstance(b, dict):
        keys = a.keys() & b.keys()
        pairs = [_shared(a[k], b[k]) for k in sorted(keys)]
        return ({k: p[0] for k, p in zip(sorted(keys), pairs)},
                {k: p[1] for k, p in zip(sorted(keys), pairs)})
    return a, b


def _run_cli(capsys, monkeypatch, *argv):
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    assert cli.main(list(argv)) == 0
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# Config and overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    ["model.corr_backend=fused", "model.dtype=float32"],
    ["train.resume=false", "train.eval_limit=none", "train.init_from=runs/x"],
    ["data.sample_hw=(64, 64)", "data.augment.crop_hw=(32,48)",
     "train.level_weights=(0.32,0.08)"],
    ["model.context_s2b=true", "model.raft_gru_fuse=no",
     "train.schedule.base_lr=3e-4", "parallel.data=2"],
    ["train.schedule.milestones=(10, 20)", "data.augment.photometric=0",
     "train.eval_limit=16", "train.profile_dir=prof"],
])
def test_apply_overrides_matches_jax(overrides):
    for preset in (None, "synthetic-proof", "raft-chairs"):
        t = tconfig.PRESETS[preset] if preset else tconfig.Config()
        j = jconfig.PRESETS[preset] if preset else jconfig.Config()
        got = dataclasses.asdict(tconfig.apply_overrides(t, overrides))
        want = dataclasses.asdict(jconfig.apply_overrides(j, overrides))
        got, want = _shared(got, want)
        assert got == want


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_match_jax(preset):
    """Every JAX preset is the port's, field for field (the fields both
    configs have)."""
    got = dataclasses.asdict(tconfig.PRESETS[preset])
    want = dataclasses.asdict(jconfig.PRESETS[preset])
    got, want = _shared(got, want)
    assert got == want


@pytest.mark.parametrize("override,error", [("model.nope=1", AttributeError),
                                            ("train.seed", ValueError)])
def test_apply_overrides_refuses_as_jax_does(override, error):
    with pytest.raises(error):
        jconfig.apply_overrides(jconfig.Config(), [override])
    with pytest.raises(error):
        tconfig.apply_overrides(tconfig.Config(), [override])


def test_config_command_prints_the_jax_config(capsys, monkeypatch):
    argv = ["--preset", "synthetic-proof", "model.corr_backend=fused"]
    got = json.loads(_run_cli(capsys, monkeypatch, "config", *argv))
    assert jcli.cmd_config(argparse.Namespace(preset=argv[1],
                                              overrides=argv[2:])) == 0
    want = json.loads(capsys.readouterr().out)
    shared = _shared(got, want)
    assert shared[0] == shared[1]
    assert got["model"]["corr_backend"] == "fused"
    # Only JAX-side fields (of modules not ported yet) are missing.
    assert got["model"].keys() <= want["model"].keys()


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

PREDICT_ARGS = ["--im1", f"{FIXTURES}/im1.png", "--im2",
                f"{FIXTURES}/im2.png", "model.dtype=float32"]


@pytest.fixture(scope="module")
def predicted():
    """The flow that predict must write: the same model and images through
    predict_flow."""
    cfg = tconfig.apply_overrides(tconfig.Config(), ["model.dtype=float32"])
    model = build_model(cfg, "cpu").eval()
    im1 = imageio.imread(f"{FIXTURES}/im1.png").astype(np.float32) / 255
    im2 = imageio.imread(f"{FIXTURES}/im2.png").astype(np.float32) / 255
    return predict_flow(model, im1, im2)


@pytest.mark.parametrize("ext", ["flo", "pfm", "png"])
def test_predict_writes_flow_the_jax_readers_read(predicted, ext, tmp_path,
                                                  capsys, monkeypatch):
    out = tmp_path / f"flow.{ext}"
    printed = json.loads(_run_cli(capsys, monkeypatch, "predict",
                                  *PREDICT_ARGS, "--out", str(out)))
    assert printed["shape"] == [128, 160, 2]
    back = jio.load_flow(str(out))
    assert back.shape == predicted.shape
    # KITTI PNG stores 1/64 px steps (truncated, by both packages).
    tol = 1 / 64 + 1e-6 if ext == "png" else 1e-5 * np.abs(
        predicted).max()
    assert np.abs(back - predicted).max() <= tol
    if ext == "png":
        assert (jio.read_kitti_png(str(out))[1] == 1).all()


def test_predict_writes_the_color_visualization(predicted, tmp_path, capsys,
                                                monkeypatch):
    vis = tmp_path / "vis.png"
    _run_cli(capsys, monkeypatch, "predict", *PREDICT_ARGS, "--vis", str(vis))
    got = imageio.imread(str(vis))
    want = jio.flow_to_rgb(predicted)
    # Flows one f32 rounding apart may land in a neighbouring color bin.
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (np.abs(got.astype(int) - want).max(-1) <= 1).mean() > 0.999


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

EVAL_OVERRIDES = ["model.dtype=float32", "data.sample_hw=(64,64)",
                  "train.eval_limit=4", "data.eval_batch=3"]
EVAL_KEYS = ["epe", "fl_all", "num_valid_px", "epe_s0_10", "epe_s10_40",
             "epe_s40plus", "num_samples", "epe_sample_mean",
             "epe_sample_stderr", "epe_s0_10_sample_mean",
             "epe_s0_10_sample_stderr"]


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The CLI's eval of a checkpoint of flax weights, and JAX
    evaluate_dataset with the same weights on the same val samples."""
    jcfg = jconfig.apply_overrides(jconfig.PRESETS["synthetic-proof"],
                                   EVAL_OVERRIDES)
    jm = jax_build_model(jcfg)
    dummy = np.zeros((1, 64, 64, 3), np.float32)
    params = jax.device_get(jax.jit(jm.init)(jax.random.key(0), dummy,
                                             dummy))
    ds = jbase.get_dataset("synthetic", "-", split="val", hw=(64, 64),
                           val_length=jcfg.data.synthetic_val_length)
    want = jax_evaluate(jm, params, ds, batch=3, limit=4)

    tcfg = tconfig.apply_overrides(tconfig.PRESETS["synthetic-proof"],
                                   EVAL_OVERRIDES)
    model = build_model(tcfg, "cpu")
    load_flax_params(model, params["params"])
    ckpt = tmp_path_factory.mktemp("ckpt")
    CheckpointManager(str(ckpt)).save(TrainState.create(
        model, *optimizer_from_config(model.parameters(), tcfg.train),
        seed=0))
    mp = pytest.MonkeyPatch()
    mp.setenv("PWCNET_PLATFORM", "cpu")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["eval", "--preset", "synthetic-proof", "--ckpt",
                             str(ckpt), *EVAL_OVERRIDES]) == 0
    finally:
        mp.undo()
    return json.loads(buf.getvalue()), want


def test_eval_command_has_the_jax_keys(evaluated):
    got, want = evaluated
    assert got.keys() == want.keys() and set(EVAL_KEYS) <= want.keys()
    assert got["num_samples"] == 4


@pytest.mark.parametrize("key", EVAL_KEYS)
def test_eval_command_matches_jax_evaluate_dataset(evaluated, key):
    got, want = evaluated
    assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (
        key, got[key], want[key])


def test_eval_batches_match_jax():
    ds = JaxSyntheticFlow(split="val", hw=(40, 72), val_length=5)
    tds = SyntheticFlow(split="val", hw=(40, 72), val_length=5)
    want = list(jpipe.eval_batches(ds, 2, limit=5))
    got = list(tpipe.eval_batches(tds, 2, limit=5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("im1", "im2", "flow", "valid"):
            assert g[k].shape == w[k].shape == {"im1": (2, 64, 128, 3),
                                                "im2": (2, 64, 128, 3),
                                                "flow": (2, 64, 128, 2),
                                                "valid": (2, 64, 128)}[k]
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-5)
    sample = {k: np.ones((70, 30, 3 if k[:2] == "im" else 2))
              for k in ("im1", "im2", "flow")}
    sample["valid"] = np.ones((70, 30))
    for k, v in tpipe._fit_to_shape(sample, (64, 64)).items():
        np.testing.assert_array_equal(v, jpipe._fit_to_shape(sample,
                                                             (64, 64))[k])


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", ["smooth", "hard"])
def test_synthetic_val_samples_match_jax(regime):
    kw = dict(split="val", hw=(48, 80), regime=regime, val_length=3)
    got, want = SyntheticFlow(**kw), JaxSyntheticFlow(**kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got[i], want[i]
        for k in ("im1", "im2", "flow", "valid"):
            assert g[k].dtype == np.float32
            np.testing.assert_allclose(g[k], w[k], rtol=0,
                                       atol=5e-5 if k == "flow" else 2e-5)
    again = got[0]  # cached, read-only
    assert not again["im1"].flags.writeable
    np.testing.assert_array_equal(again["flow"], got[0]["flow"])


def test_get_dataset_refuses_the_file_datasets(tmp_path):
    """get_dataset refuses a file dataset without its files, and builds
    each from a tree in its layout (``tests/test_torch_port_data.py`` holds
    the readers against the JAX package's)."""
    from pwcnet_tpu_torch.data import trees
    assert tbase.available_datasets() == ["flyingchairs", "flyingthings",
                                          "kitti", "sintel", "synthetic"]
    with pytest.raises(FileNotFoundError, match="FlyingChairs"):
        tbase.get_dataset("flyingchairs", str(tmp_path / "absent"))
    roots = {
        "flyingchairs": trees.write_chairs(str(tmp_path / "c"), 3, (8, 12)),
        "flyingthings": trees.write_things(str(tmp_path / "t"), 2, (8, 12)),
        "sintel": trees.write_sintel(str(tmp_path / "s"), 2, 2, (8, 12)),
        "kitti": trees.write_kitti(str(tmp_path / "k"), 3, (8, 12)),
    }
    for name, root in roots.items():
        ds = tbase.get_dataset(name, root, split="all")
        assert isinstance(ds, tbase.FlowDataset) and len(ds) >= 2
        assert ds[0]["flow"].shape == (8, 12, 2)
    assert isinstance(tbase.get_dataset("synthetic", "-", split="val",
                                        val_length=2), tbase.FlowDataset)


@pytest.mark.parametrize("ext", ["png", "ppm"])
def test_read_image_matches_jax(tmp_path, ext):
    img = np.random.default_rng(6).integers(0, 256, (13, 17, 3), np.uint8)
    path = str(tmp_path / f"a.{ext}")
    imageio.imwrite(path, img)
    got = tbase.read_image(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jbase.read_image(path))


# ---------------------------------------------------------------------------
# Visualization and file formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_mag", [None, 3.0])
def test_flow_to_rgb_equals_jax(max_mag):
    flow = np.random.default_rng(7).standard_normal((23, 31, 2)).astype(
        np.float32) * 4
    flow[3, 4] = np.nan
    np.testing.assert_array_equal(flow_to_rgb(flow, max_mag),
                                  jio.flow_to_rgb(flow, max_mag))
    np.testing.assert_array_equal(make_color_wheel(), jio.make_color_wheel())


def test_kitti_png_round_trips_with_the_jax_codec(tmp_path):
    rng = np.random.default_rng(8)
    flow = (rng.standard_normal((19, 27, 2)) * 30).astype(np.float32)
    valid = (rng.random((19, 27)) > 0.3).astype(np.float32)
    write_kitti_png(str(tmp_path / "a.png"), flow, valid)
    jflow, jvalid = jio.read_kitti_png(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(jvalid, valid)
    jio.write_kitti_png(str(tmp_path / "b.png"), flow, valid)  # cv2
    tflow, tvalid = read_kitti_png(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(tflow, jflow)
    np.testing.assert_array_equal(tvalid, valid)
    assert np.abs(jflow - flow * valid[..., None]).max() <= 1 / 64 + 1e-6


def _cv2_order(img):
    """cv2 keeps color as BGR(A)."""
    if img.ndim == 3 and img.shape[-1] >= 3:
        return img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_codec_agrees_with_cv2(tmp_path, dtype, channels):
    rng = np.random.default_rng(9)
    shape = (21, 34) if channels == 1 else (21, 34, channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    ours = str(tmp_path / "ours.png")
    png.write_png(ours, img)
    back = png.read_png(ours)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        _cv2_order(cv2.imread(ours, cv2.IMREAD_UNCHANGED)), img)
    theirs = str(tmp_path / "theirs.png")
    cv2.imwrite(theirs, _cv2_order(img))
    np.testing.assert_array_equal(png.read_png(theirs), img)
    if dtype == np.uint8:
        np.testing.assert_array_equal(imageio.imread(ours), img)


def _encode(img, kind):
    """A PNG of 8-bit RGB ``img`` whose rows all use row filter ``kind``."""
    h, w, _ = img.shape
    bpp = 3
    rows = img.reshape(h, w * 3).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(tag, body):
        return (len(body).to_bytes(4, "big") + tag + body
                + zlib.crc32(tag + body).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0,
                                                                 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
def test_png_reader_undoes_each_row_filter(tmp_path, kind):
    img = np.random.default_rng(10 + kind).integers(0, 256, (9, 13, 3),
                                                    dtype=np.uint8)
    path = tmp_path / f"f{kind}.png"
    path.write_bytes(_encode(img, kind))
    np.testing.assert_array_equal(
        _cv2_order(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)


# ---------------------------------------------------------------------------
# What the CLI refuses
# ---------------------------------------------------------------------------

def test_cli_without_gpu_or_platform_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs there")
    monkeypatch.delenv("PWCNET_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="PWCNET_PLATFORM=cpu"):
        cli.main(["predict", *PREDICT_ARGS])


def test_eval_refuses_a_directory_without_port_checkpoints(tmp_path,
                                                           monkeypatch):
    (tmp_path / "5000" / "default").mkdir(parents=True)  # an Orbax layout
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="Orbax"):
        cli.main(["predict", *PREDICT_ARGS, "--ckpt", str(tmp_path)])


def test_train_command_runs_data_parallel_ranks(tmp_path):
    """Two ``train`` processes joined by the parallel.* overrides (JAX's
    coordinator, num_processes and process_id) under ``--backend gloo``:
    both print the ranks' mean metrics of the one global batch, and
    process 0 alone writes metrics.jsonl."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PWCNET_PLATFORM": "cpu", "PYTHONPATH": str(root),
           "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "pwcnet_tpu_torch.cli", "train",
            "--preset", "synthetic-proof", "--max-steps", "1",
            "--backend", "gloo", "model.dtype=float32",
            "data.augment.crop_hw=(64,64)", "train.global_batch=2",
            f"train.log_dir={tmp_path}", "parallel.num_processes=2",
            f"parallel.coordinator=localhost:{free_port()}"]
    procs = [subprocess.Popen(argv + [f"parallel.process_id={r}"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=root,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    finals = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert finals[0]["step"] == finals[1]["step"] == 1
    assert finals[0]["loss"] == finals[1]["loss"]
    assert np.isfinite(finals[0]["loss"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
