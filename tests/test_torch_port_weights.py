"""The flax -> port weight bridge and the port's own init, and the repo's
trained PWC-Net checkpoint (``runs/synthetic-proof/
params_step125000_bf16.npz``, bf16 stored as ``uint16`` views) through it:
its flows per level against the JAX model's with the same weights, within
``1e-4 * max|ref|`` (the rule of ``tests/test_torch_port_model.py``), on a
smooth ``SyntheticFlow`` pair (an integer-shifted pair converges onto the
integer and flips the warp's coverage threshold), and its val EPE."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import (_flatten, load_flax_params,
                                                  read_flax_npz, torch_key)
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow
from pwcnet_tpu_torch.train.evaluate import evaluate_dataset

from torch_port_util import jax_npz_params, nested_set, rel_err

NPZ = (Path(__file__).resolve().parents[1] / "runs" / "synthetic-proof"
       / "params_step125000_bf16.npz")
TRAINED_HW = (384, 448)
TOL = 1e-4  # f32 flows, per level, relative to max|ref|
# The JAX run of this checkpoint read 0.0336 px on 256 val pairs
# (runs/synthetic-proof/final_eval.json); at init the model reads ~6.9.
TRAINED_EPE_MAX = 0.05


def _param_tree(num_levels=6):
    """The JAX model's parameter tree (shapes from jax.eval_shape of the
    jitted init, so nothing compiles) filled with seeded values."""
    jm = JaxPWCNet(num_levels=num_levels)
    side = 2 ** num_levels
    im = jax.ShapeDtypeStruct((1, side, side, 3), jnp.float32)
    shapes = jax.eval_shape(jax.jit(jm.init), jax.random.key(0), im, im)
    rng = np.random.default_rng(num_levels)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"])


@pytest.mark.parametrize("num_levels", [6, 7])
def test_round_trip_every_key(num_levels):
    params = _param_tree(num_levels)
    model = PWCNet(num_levels=num_levels, device="cpu")
    load_flax_params(model, params)
    flat = _flatten(params)
    state = model.state_dict()
    keys = [torch_key(p) for p in flat]
    assert len(set(keys)) == len(keys) == len(state)
    for path, value in flat.items():
        got = state[torch_key(path)].numpy()
        want = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value
        np.testing.assert_array_equal(got, want)


def test_names_of_the_main_path_tree():
    flat = _flatten(_param_tree())
    assert torch_key("FeaturePyramidExtractor_0/StemConvs_0/conv3_kernel") \
        == "pyramid.stem.conv3.weight"
    assert torch_key("estimator_l2/ConvStack_0/ConvBlock_4/Conv_0/bias") \
        == "estimators.l2.stack.blocks.4.conv.bias"
    assert torch_key("context/Conv_0/kernel") == "context.flow.weight"
    assert flat["estimator_l6/ConvStack_0/ConvBlock_0/Conv_0/kernel"].shape \
        == (3, 3, 81 + 196 + 2, 128)
    n_blocks = {p.split("/")[1] for p in flat
                if p.startswith("FeaturePyramidExtractor_0/ConvBlock_")}
    assert n_blocks == {f"ConvBlock_{i}" for i in range(8)}


def test_missing_key_raises():
    params = _param_tree()
    del params["context"]["Conv_0"]
    with pytest.raises(KeyError, match="lack"):
        load_flax_params(PWCNet(device="cpu"), params)


def test_unknown_key_raises():
    params = _param_tree()
    nested_set(params, "context/ConvBlock_9/Conv_0/kernel",
                np.zeros((3, 3, 32, 32), np.float32))
    with pytest.raises(KeyError):
        load_flax_params(PWCNet(device="cpu"), params)
    with pytest.raises(KeyError):
        torch_key("RAFT_0/Conv_0/kernel")


def test_wrong_shape_raises():
    params = _param_tree()
    params["context"]["Conv_0"]["kernel"] = np.zeros((3, 3, 32, 3),
                                                     np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(PWCNet(device="cpu"), params)


def test_plain_stem_layout_loads_as_the_fused_one():
    """A flax tree whose pyramid starts with plain ConvBlocks (the layout
    of min_level=1 models and of checkpoints from before the fused stem)
    loads into the fused-stem port, and a fused tree into a port model
    without a stem: the weight bridge remaps as
    pwcnet_tpu/train/checkpoint.py:remap_stem_params does."""
    from pwcnet_tpu.train.checkpoint import remap_stem_params as jax_remap
    from pwcnet_tpu_torch.compat.flax_weights import remap_stem_params
    params = _param_tree()
    fpe = params["FeaturePyramidExtractor_0"]
    plain_fpe = remap_stem_params(fpe, to_fused=False)
    want = jax_remap(fpe, to_fused=False)
    assert _flatten(plain_fpe).keys() == _flatten(want).keys()
    fused = PWCNet(device="cpu")
    load_flax_params(fused, params)
    remapped = PWCNet(device="cpu", generator=torch.Generator().manual_seed(9))
    load_flax_params(remapped, {**params,
                                "FeaturePyramidExtractor_0": plain_fpe})
    for k, v in fused.state_dict().items():
        assert torch.equal(v, remapped.state_dict()[k]), k
    back = remap_stem_params(plain_fpe, to_fused=True)
    for k, v in _flatten(fpe).items():
        np.testing.assert_array_equal(_flatten(back)[k], v)


def test_init_follows_lecun_normal():
    model = PWCNet(device="cpu", generator=torch.Generator().manual_seed(3))
    w = model.estimators["l6"].stack.blocks[0].conv.weight.detach()
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 / 0.87962566 / np.sqrt(fan_in) + 1e-6
    assert all((m.conv.bias == 0).all() for m in
               model.estimators["l6"].stack.blocks)
    again = PWCNet(device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.context.flow.weight, model.context.flow.weight)


def test_read_flax_npz_reads_the_uint16_checkpoint_as_bf16():
    tree = read_flax_npz(str(NPZ))
    flat = _flatten(tree)
    with np.load(NPZ) as z:
        assert len(flat) == len(z.files) == 98
        for key in z.files:
            got = flat[key.split("/", 1)[1]]
            assert got.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          z[key].view(np.int16))


@pytest.mark.parametrize("stored", ["<u2", "<i2", "|V2"])
def test_read_flax_npz_reads_every_2_byte_storage_as_bf16(tmp_path, stored):
    bits = np.array([0x3F80, 0xC000, 0x7F80, 0x0001], np.uint16)
    path = tmp_path / "p.npz"
    np.savez(path, **{"params/context/Conv_0/bias": bits.view(stored),
                      "params/context/Conv_0/half": bits.astype(np.float16)})
    tree = read_flax_npz(str(path))["context"]["Conv_0"]
    assert tree["bias"].dtype == torch.bfloat16
    assert tree["bias"][:3].tolist() == [1.0, -2.0, float("inf")]
    np.testing.assert_array_equal(tree["bias"].view(torch.int16).numpy(),
                                  bits.view(np.int16))
    assert tree["half"].dtype == torch.float16  # a real float16 array


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_integer_parameters_raise(dtype):
    params = _param_tree()
    k = params["context"]["Conv_0"]["kernel"]
    params["context"]["Conv_0"]["kernel"] = np.ones(k.shape, dtype)
    with pytest.raises(TypeError, match="context/Conv_0/kernel.*dtype"):
        load_flax_params(PWCNet(device="cpu"), params)


@pytest.fixture(scope="module")
def trained():
    """The flows of the port's and of JAX's f32 PWC-Net with the trained
    weights (bf16, upcast) on synthetic val pair 0."""
    s = SyntheticFlow(split="val", hw=TRAINED_HW)[0]
    im1, im2 = s["im1"][None], s["im2"][None]
    jm = JaxPWCNet(corr_backend="lax")
    want = jax.jit(lambda p, a, b: jm.apply(p, a, b, train=False))(
        jax_npz_params(NPZ), im1, im2)
    model = PWCNet(device="cpu")
    load_flax_params(model, read_flax_npz(str(NPZ)))
    with torch.no_grad():
        got = model(torch.from_numpy(im1.copy()), torch.from_numpy(
            im2.copy()))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("level", range(5))
def test_trained_checkpoint_matches_jax_per_level(trained, level):
    got, want = trained
    assert len(got) == len(want) == 5
    assert got[level].shape == want[level].shape
    assert rel_err(got[level], want[level]) <= TOL  # measured <= 6.2e-7
    assert np.abs(want[level]).max() > 0.1  # trained flows carry signal


def test_trained_checkpoint_val_epe():
    """evaluate_dataset of the trained model on 4 synthetic-proof val pairs
    at 384x448 (f32 on the CPU): finite and under 0.05 px."""
    model = PWCNet(device="cpu")
    load_flax_params(model, read_flax_npz(str(NPZ)))
    ev = evaluate_dataset(model, SyntheticFlow(split="val", hw=TRAINED_HW),
                          batch=4, limit=4)
    assert ev["num_samples"] == 4
    assert np.isfinite(ev["epe"]) and ev["epe"] < TRAINED_EPE_MAX, ev
