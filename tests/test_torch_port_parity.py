"""The port's reference ``.pth`` import (``compat/torch_import.py``), its
parity harness (``train/parity.py``) and the CLI's ``parity`` held against
the JAX package's, on the CPU.

The state dicts come from the JAX package's torch mirror of the reference
network, ``pwcnet_tpu.compat.torch_ref.Net``, at small sizes (search range
2, 3 or 4 levels; with 4 the port's pyramid starts with the stem). Imported
parameters must equal JAX's importer's exactly; flows match JAX's per
level within ``1e-4 * max|ref|``; the harness's numbers within 1e-4
relative, with the same ``best``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pwcnet_tpu.compat import import_torch_state_dict as jax_import
from pwcnet_tpu.compat.torch_ref import Net
from pwcnet_tpu.config import Config as JaxConfig
from pwcnet_tpu.config import ModelConfig as JaxModelConfig
from pwcnet_tpu.io import write_flo
from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.train.parity import parity_report as jax_parity_report
from pwcnet_tpu_torch import PWCNet, cli
from pwcnet_tpu_torch.compat import (import_torch_checkpoint,
                                     import_torch_state_dict,
                                     load_flax_params)
from pwcnet_tpu_torch.compat.flax_weights import _flatten, torch_key
from pwcnet_tpu_torch.config import Config, ModelConfig
from pwcnet_tpu_torch.io import write_png
from pwcnet_tpu_torch.train.checkpoint import CheckpointManager
from pwcnet_tpu_torch.train.parity import parity_report
from pwcnet_tpu_torch.train.schedule import ScheduleConfig, make_optimizer
from pwcnet_tpu_torch.train.state import TrainState

TOL = 1e-4
# "stem": 4 levels, min_level 2, the pyramid's first four convs go to the
# stem; "plain": 3 levels, min_level 1, no stem; "norm": use_norm, no stem.
CFGS = {"stem": dict(num_levels=4, output_level=2, search_range=2),
        "plain": dict(num_levels=3, output_level=2, search_range=2),
        "norm": dict(num_levels=4, output_level=2, search_range=2,
                     use_norm=True)}
MODEL_KW = dict(num_levels=3, output_level=2, search_range=2,
                corr_backend="lax", dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: these CPU ops are small, and under parallel test
    workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _net(cfg):
    torch.manual_seed(0)
    return Net(num_levels=cfg["num_levels"],
               output_level=cfg["output_level"],
               search_range=cfg["search_range"]).eval()


@pytest.fixture(scope="module")
def imported():
    """Per config: the reference state dict, JAX's imported params and the
    port model filled by the port's importer."""
    out = {}
    for name, cfg in CFGS.items():
        sd = _net(cfg).state_dict()
        jm = JaxPWCNet(corr_backend="lax", **cfg)
        model = PWCNet(device="cpu", corr_backend="lax", **cfg)
        filled = import_torch_state_dict(sd, model)
        out[name] = dict(sd=sd, jm=jm, jparams=jax_import(sd, jm)["params"],
                         model=model, filled=filled)
    return out


@pytest.mark.parametrize("name", list(CFGS))
def test_import_gives_the_jax_importers_parameters(imported, name):
    """Every conv JAX's importer fills holds, through the port's weight
    bridge, exactly what the port's importer put there; a use_norm model's
    norms keep their init (a reference state dict has no GroupNorm)."""
    r = imported[name]
    want = PWCNet(device="cpu", **CFGS[name])
    jparams = r["jparams"]
    if name == "norm":  # JAX's importer leaves the norms out
        got = r["model"].state_dict()
        for k, v in got.items():
            if ".norm." in k:
                assert torch.equal(v, want.state_dict()[k]), k
        flat = _flatten(jparams)
        assert {torch_key(k) for k in flat} == set(r["filled"])
        for k, v in flat.items():
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
            assert np.array_equal(got[torch_key(k)].numpy(), v), k
        return
    load_flax_params(want, jparams)
    got = r["model"].state_dict()
    assert set(r["filled"]) == set(got)
    for k, v in want.state_dict().items():
        assert torch.equal(got[k], v), k
    if name == "stem":
        assert r["filled"]["pyramid.stem.conv1.weight"] == \
            "feature_pyramid_extractor.convs.0.0.0.weight"


@pytest.fixture(scope="module")
def flows(imported):
    rng = np.random.default_rng(7)
    im1 = rng.random((1, 64, 64, 3), np.float32)
    im2 = rng.random((1, 64, 64, 3), np.float32)
    out = {}
    for name in ("stem", "plain"):
        r = imported[name]
        jf = r["jm"].apply({"params": r["jparams"]}, im1, im2, train=False)
        with torch.no_grad():
            tf = r["model"](torch.from_numpy(im1), torch.from_numpy(im2))
        out[name] = ([np.asarray(f) for f in jf], [f.numpy() for f in tf])
    return out


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("name", ["stem", "plain"])
def test_imported_flows_match_jax_per_level(flows, name, i):
    want, got = flows[name][0][i], flows[name][1][i]
    assert got.shape == want.shape
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("wrap", ["plain", "state_dict", "model",
                                  "model_state_dict"])
def test_checkpoint_file_and_wrappers(tmp_path, imported, wrap):
    """A plain file, and each wrapper dict with DataParallel's ``module.``
    prefix on every key."""
    r = imported["stem"]
    obj = r["sd"] if wrap == "plain" else {
        wrap: {f"module.{k}": v for k, v in r["sd"].items()}, "epoch": 3}
    path = tmp_path / f"{wrap}.pth"
    torch.save(obj, path)
    model = PWCNet(device="cpu", **CFGS["stem"])
    import_torch_checkpoint(str(path), model)
    for k, v in r["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def _fine_first(sd):
    """The same network with its estimators registered finest first."""
    n = len({k.split(".")[1] for k in sd if k.startswith("flow_estimators")})
    return {(f"flow_estimators.{n - 1 - int(k.split('.')[1])}."
             + k.split(".", 2)[2] if k.startswith("flow_estimators") else k):
            v for k, v in sd.items()}


def test_fine_first_estimators(imported):
    r = imported["stem"]
    fine = _fine_first(r["sd"])
    model = PWCNet(device="cpu", **CFGS["stem"])
    import_torch_state_dict(fine, model, estimator_order="fine_first")
    for k, v in r["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="estimator_order"):
        import_torch_state_dict(fine, model, estimator_order="sideways")


def test_wrong_estimator_order_is_caught_and_copies_nothing(imported):
    """fine_first on a coarse-first dict fails the shape checks (each
    level's estimator input width differs), as JAX's importer does; the
    model is left as it was."""
    r = imported["stem"]
    model = PWCNet(device="cpu", **CFGS["stem"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="expects"):
        import_torch_state_dict(r["sd"], model, estimator_order="fine_first")
    with pytest.raises(ValueError, match="expects"):
        jax_import(r["sd"], r["jm"], estimator_order="fine_first")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_every_problem_is_listed_at_once(imported):
    r = imported["stem"]
    sd = dict(r["sd"])
    sd["totally_unknown.weight"] = torch.zeros(3)
    del sd["context_networks.flow_conv.weight"]  # its bias stays, 1-D
    sd["feature_pyramid_extractor.convs.1.0.0.weight"] = torch.zeros(
        32, 16, 5, 5)
    sd["flow_estimators.0.convs.0.0.bn.running_mean"] = torch.zeros(3)
    with pytest.raises(ValueError) as err:
        import_torch_state_dict(sd, PWCNet(device="cpu", **CFGS["stem"]))
    msg = str(err.value)
    assert "unmatched source key: totally_unknown.weight" in msg
    assert "context: 6 source convs for 7 destination convs" in msg
    assert "convs.1.0.0: (32, 16, 5, 5) -> pyramid.stem.conv3" in msg
    assert "running_mean" not in msg
    with pytest.raises(ValueError, match="unmatched source key"):
        jax_import(sd, r["jm"])


def test_a_port_checkpoint_file_is_refused_with_its_directory_named(
        tmp_path):
    """A step_<n>.pt of the port's CheckpointManager holds the model under
    "model" beside the optimizer: it is refused, with the directory form
    named, rather than read as a reference state dict."""
    model = PWCNet(device="cpu", **CFGS["stem"])
    opt, sched = make_optimizer(model.parameters(), ScheduleConfig())
    path = CheckpointManager(str(tmp_path)).save(
        TrainState.create(model, opt, sched, seed=0))
    assert path.endswith("step_0.pt")
    with pytest.raises(ValueError, match="pass the directory"):
        import_torch_checkpoint(path, PWCNet(device="cpu", **CFGS["stem"]))


# ---------------------------------------------------------------------------
# The parity harness and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 40x56 pair (padded to /8 by the harness), a GT and a noisy
    reference .flo, and a reference .pth of the 3-level network."""
    d = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(0)
    h, w = 40, 56
    im1 = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    write_png(str(d / "im1.png"), im1)
    write_png(str(d / "im2.png"), np.roll(im1, 2, axis=1))
    gt = np.zeros((h, w, 2), np.float32)
    gt[..., 0] = 2.0
    write_flo(str(d / "gt.flo"), gt)
    write_flo(str(d / "ref.flo"),
              gt + rng.standard_normal(gt.shape).astype(np.float32) * 0.1)
    torch.save(_net(CFGS["plain"]).state_dict(), d / "ref.pth")
    return d


def _reports_agree(got, want):
    """Same keys and entries; every float within 1e-4 relative."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _reports_agree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _reports_agree(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    else:
        assert got == want


def _args(pair, **kw):
    return dict(gt_path=str(pair / "gt.flo"),
                ref_flow_path=str(pair / "ref.flo"),
                ckpt=str(pair / "ref.pth"), **kw)


@pytest.mark.parametrize("sweep", [False, True])
def test_parity_report_matches_jax(pair, sweep):
    want = jax_parity_report(
        JaxConfig(model=JaxModelConfig(**MODEL_KW)), str(pair / "im1.png"),
        str(pair / "im2.png"), **_args(pair, sweep=sweep))
    got = parity_report(Config(model=ModelConfig(**MODEL_KW)),
                        str(pair / "im1.png"), str(pair / "im2.png"),
                        device="cpu", **_args(pair, sweep=sweep))
    json.dumps(got)
    _reports_agree(got, want)
    if sweep:
        assert {(r["resize_mode"], r["input_center"]) for r in got["sweep"]
                } == {(m, c) for m in ("half_pixel", "align_corners")
                      for c in (False, True)}
        assert "epe_vs_reference" in got["best"]
    else:
        assert len(got["per_level"]) == 3


def test_parity_without_a_checkpoint_runs_the_seeded_init(pair):
    cfg = Config(model=ModelConfig(**MODEL_KW))
    a = parity_report(cfg, str(pair / "im1.png"), str(pair / "im2.png"),
                      gt_path=str(pair / "gt.flo"), device="cpu")
    assert np.isfinite(a["epe_vs_gt"]) and "epe_vs_reference" not in a
    b = parity_report(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=1)), str(pair / "im1.png"), str(pair / "im2.png"),
        gt_path=str(pair / "gt.flo"), device="cpu")
    assert a["epe_vs_gt"] != b["epe_vs_gt"]


def _cli(pair, capsys, *extra):
    rc = cli.main(["parity", "--im1", str(pair / "im1.png"), "--im2",
                   str(pair / "im2.png"), "--gt", str(pair / "gt.flo"),
                   *extra, *(f"model.{k}={v}" for k, v in MODEL_KW.items())])
    assert rc == 0
    return json.loads(capsys.readouterr().out)


def test_parity_cli_matches_the_harness(pair, capsys, monkeypatch):
    """The CLI in-process on the CPU (PWCNET_PLATFORM=cpu), with --sweep
    and a .pth, prints the harness's report; a port checkpoint directory
    holding the imported weights gives the same report."""
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    out = _cli(pair, capsys, "--sweep", "--ckpt", str(pair / "ref.pth"))
    want = parity_report(Config(model=ModelConfig(**MODEL_KW)),
                         str(pair / "im1.png"), str(pair / "im2.png"),
                         gt_path=str(pair / "gt.flo"),
                         ckpt=str(pair / "ref.pth"), sweep=True,
                         device="cpu")
    _reports_agree(out, want)
    model = PWCNet(device="cpu", **{k: v for k, v in MODEL_KW.items()
                                    if k != "dtype"})
    import_torch_checkpoint(str(pair / "ref.pth"), model)
    opt, sched = make_optimizer(model.parameters(), ScheduleConfig())
    ckdir = pair / "ckpt"
    CheckpointManager(str(ckdir)).save(
        TrainState.create(model, opt, sched, seed=0))
    _reports_agree(_cli(pair, capsys, "--sweep", "--ckpt", str(ckdir)), out)


def test_parity_cli_refuses_an_orbax_directory(pair, tmp_path, monkeypatch):
    (tmp_path / "5000" / "default").mkdir(parents=True)
    monkeypatch.setenv("PWCNET_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="Orbax"):
        cli.main(["parity", "--im1", str(pair / "im1.png"), "--im2",
                  str(pair / "im2.png"), "--ckpt", str(tmp_path)])
