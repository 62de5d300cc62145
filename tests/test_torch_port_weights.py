"""The flax -> port weight bridge and the port's own init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat.flax_weights import (_flatten, load_flax_params,
                                                  torch_key)


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


def _nested_set(tree, path, value):
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def test_missing_key_raises():
    params = _param_tree()
    del params["context"]["Conv_0"]
    with pytest.raises(KeyError, match="lack"):
        load_flax_params(PWCNet(device="cpu"), params)


def test_unknown_key_raises():
    params = _param_tree()
    _nested_set(params, "context/ConvBlock_9/Conv_0/kernel",
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
