"""The design of the tensor-core kernels (``csrc/conv3x3_mma.cuh``, K7 and
the bf16 K5), checked on the CPU: the build's hash of the shared header,
the output-parity split of the stride-2 transposed conv, and the bf16 K5's
rounding, each through the port's plain-torch model of the kernel's
arithmetic (``stem_kernel.conv_t2_ref``, ``stem_kernel.stem_bwd_bf16_ref``).
"""

import numpy as np
import pytest
import torch

from pwcnet_tpu_torch.ops.conv import conv_same
from pwcnet_tpu_torch.ops.kernels import build, stem_kernel

from torch_port_util import rel_err, stem_params, torch_stem_params


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited header must rebuild every source, or a stale library
    would load."""
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    first = build._target("a")
    assert build._target("a") == first
    (tmp_path / "tile.cuh").write_text("// v2\n")
    second = build._target("a")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert build._target("a") not in (first, second)
    (tmp_path / "a.cu").write_text('#include "tile.cuh"\n// edited\n')
    assert len({first, second, build._target("a")}) == 3


@pytest.mark.parametrize("hw", [(8, 10), (12, 12), (9, 7), (7, 13)])
def test_stride2_transposed_conv_parity_split_matches_autograd(hw):
    """conv_t2_ref walks the output by parity as the kernel does (XLA's
    (0, 1) stride-2 padding on even sizes, (1, 1) on odd ones): equal to
    autograd of conv_same's stride-2 conv within 1e-6 (f32)."""
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 5, *hw)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3)).astype(np.float32))
    a = x.clone().requires_grad_()
    out = conv_same(a, w, None, stride=2)
    p = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    want, = torch.autograd.grad(out, a, p)
    got = stem_kernel.conv_t2_ref(p.permute(0, 2, 3, 1),
                                  w.permute(2, 3, 1, 0), hw)
    assert rel_err(got.permute(0, 3, 1, 2), want) <= 1e-6


def _grads(im, params, g):
    a = im.clone().requires_grad_()
    p = [(w.clone().requires_grad_(), b.clone().requires_grad_())
         for w, b in params]
    flat = [t for pair in p for t in pair]
    return torch.autograd.grad(stem_kernel.stem_ref(a, p), [a, *flat], g)


@pytest.mark.parametrize("shape", [(2, 40, 72, 3), (1, 36, 100, 3)])
def test_bf16_stem_backward_rounding_holds_the_oracle_bound(shape):
    """The bf16 K5 rounds p_l to bf16 before each product and sums in f32
    (stem_bwd_bf16_ref models exactly that). Against the f32 oracle (f32
    autograd on the same bf16-rounded inputs) every gradient stays within
    max(3 x the plain bf16 autograd's error, 5e-3): chip_smoke.py's
    STEM_BWD_BF16 bound for the kernel."""
    rng = np.random.default_rng(13)
    params = torch_stem_params(stem_params(rng))
    im = torch.from_numpy(rng.random(shape, np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal(
        (shape[0], shape[1] // 4, shape[2] // 4, 32)).astype(
            np.float32)).bfloat16()
    d_im, dp = stem_kernel.stem_bwd_bf16_ref(im, params, g)
    got = [d_im] + [t for pair in dp for t in pair]
    plain = _grads(im, params, g)
    oracle = _grads(im.float(), [(w.bfloat16().float(), b.bfloat16().float())
                                 for w, b in params], g.float())
    assert d_im.dtype == torch.bfloat16 and d_im.shape == im.shape
    for x, y, o in zip(got, plain, oracle):
        assert x.shape == o.shape
        assert rel_err(x, o) <= max(3 * rel_err(y, o), 5e-3)
    no_im, dp2 = stem_kernel.stem_bwd_bf16_ref(im, params, g, need_im=False)
    assert no_im is None
    assert all(torch.equal(a, b) for pa, pb in zip(dp, dp2)
               for a, b in zip(pa, pb))
