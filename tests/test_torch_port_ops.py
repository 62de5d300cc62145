"""The port's ops (``pwcnet_tpu_torch.ops``) held against the JAX package's.

Inputs come from numpy with a seed and go through both functions, in f32
unless a test says otherwise. CUDA-only tests carry the ``cuda`` marker and
skip without a CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwcnet_tpu.ops.cost_volume import cost_volume_lax
from pwcnet_tpu.ops.pallas.cost_volume_kernel import cost_volume_pallas
from pwcnet_tpu.ops.pallas.stem_kernel import _stem_backward_pallas
from pwcnet_tpu.ops.pallas.stem_kernel import stem_pallas
from pwcnet_tpu.ops.pallas.stem_kernel import stem_ref as jax_stem_ref
from pwcnet_tpu.ops.resize import resize_bilinear as jax_resize
from pwcnet_tpu.ops.warp import warp_bilinear as jax_warp
from pwcnet_tpu.ops.warp import warp_bilinear_ref as jax_warp_ref
from pwcnet_tpu_torch.ops import (conv_same, cost_volume, cost_volume_ref,
                                  downsample_bilinear, resize_bilinear,
                                  warp_bilinear)
from pwcnet_tpu_torch.ops.kernels import (build, cost_volume_kernel,
                                          stem_kernel, warp_corr_kernel)

from torch_port_util import (need_cuda, rel_err, stem_params, to_torch,
                             torch_stem_params)


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (1, 9, 20, 33)])
def test_cost_volume_ref_matches_jax(shape, d):
    rng = np.random.default_rng(0)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    got = cost_volume_ref(to_torch(f1), to_torch(f2), d).numpy()
    want_lax = np.asarray(cost_volume_lax(jnp.asarray(f1), jnp.asarray(f2), d))
    want_pallas = np.asarray(cost_volume_pallas(
        jnp.asarray(f1), jnp.asarray(f2), max_displacement=d, interpret=True))
    assert got.shape == shape[:3] + ((2 * d + 1) ** 2,)
    np.testing.assert_allclose(got, want_lax, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=0)


def test_cost_volume_ref_bf16_matches_lax():
    rng = np.random.default_rng(1)
    f1 = rng.uniform(-1, 1, (2, 7, 13, 24)).astype(np.float32)
    f2 = rng.uniform(-1, 1, (2, 7, 13, 24)).astype(np.float32)
    t1, t2 = to_torch(f1).bfloat16(), to_torch(f2).bfloat16()
    got = cost_volume_ref(t1, t2).float().numpy()
    want = np.asarray(cost_volume_lax(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    ).astype(jnp.float32))
    assert cost_volume_ref(t1, t2).dtype == torch.bfloat16
    # Both upcast the same bf16 inputs and sum in f32, in different orders;
    # the f32 means then round to bf16 (8 bits), so an output of size <= 1
    # may land one bf16 step (2**-8 relative, < 4e-3 here) apart. 2e-2
    # leaves room for that and nothing more.
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_cost_volume_dispatches_to_plain_on_cpu():
    rng = np.random.default_rng(2)
    f1 = to_torch(rng.standard_normal((1, 5, 6, 8)).astype(np.float32))
    before = dict(cost_volume_kernel.LAUNCHES)
    np.testing.assert_array_equal(cost_volume(f1, f1).numpy(),
                                  cost_volume_ref(f1, f1).numpy())
    assert cost_volume_kernel.LAUNCHES == before


def test_cost_volume_kernel_wrapper_refuses_cpu_tensors():
    f = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_kernel.cost_volume_cuda(f, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (1, 9, 33, 196),
                                   (3, 20, 70, 32)])
def test_cost_volume_kernel_matches_plain(shape, dtype, tol):
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    f2 = torch.randn(shape, device="cuda", generator=g).to(dtype)
    with torch.no_grad():
        got = cost_volume_kernel.cost_volume_cuda(f1, f2).float()
        want = cost_volume_ref(f1, f2).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (1, 9, 20, 33),
                                   (3, 6, 7, 16)])
def test_cost_volume_plain_backward_matches_jax(shape, d):
    """K2 and K3's plain version (autograd through cost_volume_ref) against
    the JAX VJP through the Pallas kernels in interpret mode."""
    rng = np.random.default_rng(10)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + ((2 * d + 1) ** 2,)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: cost_volume_pallas(
        a, b, max_displacement=d, interpret=True), jnp.asarray(f1),
        jnp.asarray(f2))
    want = vjp(jnp.asarray(g))
    a1, a2 = to_torch(f1).requires_grad_(), to_torch(f2).requires_grad_()
    got = torch.autograd.grad(cost_volume(a1, a2, max_displacement=d),
                              (a1, a2), to_torch(g))
    for gt, wt in zip(got, want):
        assert gt.shape == shape
        assert rel_err(gt.numpy(), wt) <= 1e-5


def test_cost_volume_backward_wrapper_refuses_cpu_tensors():
    f, g = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 81)
    with pytest.raises(ValueError, match="CUDA"):
        cost_volume_kernel.cost_volume_bwd_cuda(g, f, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("shape", [(2, 7, 13, 5), (8, 6, 7, 196),
                                   (3, 20, 70, 32)])
def test_cost_volume_backward_kernels_match_plain(shape, dtype, tol):
    need_cuda()
    g = torch.Generator(device="cuda").manual_seed(1)
    f1, f2 = (torch.randn(shape, device="cuda", generator=g).to(dtype)
              for _ in range(2))
    go = torch.randn(shape[:3] + (81,), device="cuda", generator=g).to(dtype)
    a1, a2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    got = torch.autograd.grad(cost_volume(a1, a2), (a1, a2), go)
    b1, b2 = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    want = torch.autograd.grad(cost_volume_ref(b1, b2), (b1, b2), go)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == dtype
        assert (x.float() - y.float()).abs().max() <= tol * y.float().abs(
        ).max()


# ---------------------------------------------------------------------------
# Stem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 64, 3), (1, 40, 96, 3)])
def test_stem_ref_matches_jax(shape):
    rng = np.random.default_rng(3)
    im = rng.random(shape, np.float32)
    params = stem_params(rng)
    jparams = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)
    got = stem_kernel.stem_ref(to_torch(im), torch_stem_params(params)).numpy()
    want_ref = np.asarray(jax_stem_ref(jnp.asarray(im), jparams))
    want_pallas = np.asarray(stem_pallas(jnp.asarray(im), jparams,
                                         interpret=True))
    assert got.shape == (shape[0], shape[1] // 4, shape[2] // 4, 32)
    assert rel_err(got, want_ref) <= 1e-5
    assert rel_err(got, want_pallas) <= 1e-5


def test_stem_dispatches_to_plain_on_cpu():
    rng = np.random.default_rng(4)
    im = to_torch(rng.random((1, 16, 24, 3), np.float32))
    params = torch_stem_params(stem_params(rng))
    before = dict(stem_kernel.LAUNCHES)
    np.testing.assert_array_equal(stem_kernel.stem(im, params).numpy(),
                                  stem_kernel.stem_ref(im, params).numpy())
    assert stem_kernel.LAUNCHES == before


def test_stem_kernel_wrapper_refuses_cpu_tensors():
    params = torch_stem_params(stem_params(np.random.default_rng(5)))
    with pytest.raises(ValueError, match="CUDA"):
        stem_kernel.stem_cuda(torch.zeros(1, 8, 8, 3), params)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [(1, 64, 192, 3), (2, 36, 40, 3)])
def test_stem_kernel_matches_plain(shape, dtype, tol):
    need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    params = [(w.cuda(), b.cuda())
              for w, b in torch_stem_params(stem_params(rng))]
    im = to_torch(rng.random(shape, np.float32)).cuda().to(dtype)
    with torch.no_grad():
        got = stem_kernel.stem_cuda(im, params).float()
        want = stem_kernel.stem_ref(im, params).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("hw", [(40, 64), (36, 96), (96, 256), (40, 112)])
def test_stem_plain_backward_matches_jax(hw):
    """K5's plain version (autograd through stem_ref) against the Pallas
    backward kernel in interpret mode and against jax.vjp(stem_ref), for
    the image and all eight parameters."""
    rng = np.random.default_rng(11)
    im = rng.random((2, *hw, 3), np.float32)
    params = stem_params(rng)
    g = rng.standard_normal((2, hw[0] // 4, hw[1] // 4, 32)).astype(
        np.float32)
    jparams = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)
    k_im, k_params = _stem_backward_pallas(jnp.asarray(im), jparams,
                                           jnp.asarray(g), interpret=True)
    _, vjp = jax.vjp(jax_stem_ref, jnp.asarray(im), jparams)
    r_im, r_params = vjp(jnp.asarray(g))
    a = to_torch(im).requires_grad_()
    tp = [(w.requires_grad_(), b.requires_grad_())
          for w, b in torch_stem_params(params)]
    got = torch.autograd.grad(stem_kernel.stem(a, tp),
                              [a, *[t for pair in tp for t in pair]],
                              to_torch(g))
    for want_im, want_p in ((k_im, k_params), (r_im, r_params)):
        assert rel_err(got[0].numpy(), want_im) <= 1e-5
        for i, (w, b) in enumerate(want_p):
            assert rel_err(got[1 + 2 * i].numpy().transpose(2, 3, 1, 0),
                            w) <= 1e-5
            assert rel_err(got[2 + 2 * i].numpy(), b) <= 1e-5


def test_stem_backward_wrapper_refuses_cpu_tensors():
    params = torch_stem_params(stem_params(np.random.default_rng(12)))
    with pytest.raises(ValueError, match="CUDA"):
        stem_kernel.stem_bwd_cuda(torch.zeros(1, 8, 8, 3), params,
                                  torch.zeros(1, 2, 2, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((2, 40, 72, 3), torch.float32), ((1, 36, 100, 3), torch.float32),
    ((2, 40, 72, 3), torch.bfloat16), ((1, 36, 100, 3), torch.bfloat16),
    # the bf16 kernel's tiles, ragged at N = 16
    ((16, 44, 76, 3), torch.bfloat16),
    # more weight-gradient tiles than blocks in every layer (1872, 1872,
    # 944 and 944 tiles of 4 x 64 pixels over 924, 528, 264 and 264 blocks)
    ((16, 932, 12, 3), torch.bfloat16)])
def test_stem_backward_kernel_matches_plain(shape, dtype):
    """f32: within 1e-4 of autograd through stem_ref. bf16: within
    max(3 x the plain bf16 error, 5e-3) of an f32 oracle on the same
    bf16-rounded inputs, as tests/test_stem_kernel.py holds the Pallas
    backward, and within BF16_MODEL_TOL of stem_bwd_bf16_ref, the kernel's
    own arithmetic."""
    need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(13)
    params = [(w.cuda(), b.cuda())
              for w, b in torch_stem_params(stem_params(rng))]
    im = to_torch(rng.random(shape, np.float32)).cuda().to(dtype)
    g = to_torch(rng.standard_normal(
        (shape[0], shape[1] // 4, shape[2] // 4, 32)).astype(
            np.float32)).cuda().to(dtype)

    def plain(im, ps, g):
        a = im.clone().requires_grad_()
        p = [(w.clone().requires_grad_(), b.clone().requires_grad_())
             for w, b in ps]
        flat = [t for pair in p for t in pair]
        return torch.autograd.grad(stem_kernel.stem_ref(a, p), [a, *flat], g)

    d_im, dp = stem_kernel.stem_bwd_cuda(im, params, g)
    got = [d_im] + [t for pair in dp for t in pair]
    want = plain(im, params, g)
    if dtype == torch.float32:
        for x, y in zip(got, want):
            assert rel_err(x.cpu(), y.cpu()) <= 1e-4
        return
    oracle = plain(im.float(), [(w.to(dtype).float(), b.to(dtype).float())
                                for w, b in params], g.float())
    for x, y, o in zip(got, want, oracle):
        err_k = rel_err(x.float().cpu(), o.cpu())
        err_x = rel_err(y.float().cpu(), o.cpu())
        assert err_k <= max(3 * err_x, 5e-3), (err_k, err_x)
    m_im, mp = stem_kernel.stem_bwd_bf16_ref(im, params, g)
    model = [m_im] + [t for pair in mp for t in pair]
    for i, (x, m) in enumerate(zip(got, model)):
        tol = stem_kernel.BF16_MODEL_TOL[0 if i == 0 else 1]
        assert rel_err(x.float().cpu(), m.float().cpu()) <= tol, i


@pytest.mark.cuda
@pytest.mark.parametrize("need_im", [False, True])
def test_stem_backward_kernel_is_deterministic(need_im):
    """bf16: two calls on the same inputs give bit-identical gradients (a
    fixed split of the weight-gradient sums, reduced in a fixed order)."""
    need_cuda()
    rng = np.random.default_rng(15)
    params = [(w.cuda(), b.cuda())
              for w, b in torch_stem_params(stem_params(rng))]
    im = to_torch(rng.random((4, 64, 96, 3), np.float32)).cuda().bfloat16()
    g = to_torch(rng.standard_normal((4, 16, 24, 32)).astype(
        np.float32)).cuda()
    first = stem_kernel.stem_bwd_cuda(im, params, g, need_im=need_im)
    second = stem_kernel.stem_bwd_cuda(im, params, g, need_im=need_im)
    torch.cuda.synchronize()
    flat = [[d] + [t for pair in dp for t in pair] for d, dp in (first,
                                                                  second)]
    assert (flat[0][0] is None) == (not need_im)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(*flat))


# ---------------------------------------------------------------------------
# SAME-padded conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,stride,dilation", [
    ((8, 8), 2, 1), ((16, 10), 2, 1), ((9, 7), 2, 1),
    ((12, 12), 1, 1), ((16, 16), 1, 2), ((16, 16), 1, 4),
    ((32, 32), 1, 8), ((32, 32), 1, 16)])
def test_conv_same_matches_lax(hw, stride, dilation):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = conv_same(to_torch(x).permute(0, 3, 1, 2),
                    to_torch(w.transpose(3, 2, 0, 1).copy()), to_torch(b),
                    stride=stride, dilation=dilation).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# Warp and resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_warp_matches_jax(dtype):
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    # Flows up to +-6 px on a 9x11 map: many samples fall partly or wholly
    # outside, exercising the corner masks and the coverage mask.
    flow = rng.uniform(-6, 6, (2, 9, 11, 2)).astype(np.float32)
    if dtype == "bfloat16":
        tf = to_torch(feat).bfloat16()
        jf = jnp.asarray(feat, jnp.bfloat16)
    else:
        tf, jf = to_torch(feat), jnp.asarray(feat)
    got = warp_bilinear(tf, to_torch(flow))
    assert got.dtype == tf.dtype
    got = got.float().numpy()
    for fn in (jax_warp, jax_warp_ref):
        want = np.asarray(fn(jf, jnp.asarray(flow)).astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got == 0).all(-1).any() and not (got == 0).all()


@pytest.mark.parametrize("mode", ["half_pixel", "align_corners"])
@pytest.mark.parametrize("in_hw,out_hw", [((3, 5), (6, 10)),
                                          ((4, 6), (16, 24)),
                                          ((7, 9), (10, 19))])
def test_resize_matches_jax(mode, in_hw, out_hw):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, *in_hw, 2)).astype(np.float32)
    got = resize_bilinear(to_torch(x), out_hw, mode).numpy()
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw, mode))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((384, 448), (96, 112)),
                                          ((384, 448), (6, 7)),
                                          ((64, 96), (25, 40)),
                                          ((40, 24), (10, 6))])
def test_downsample_matches_jax_resize(in_hw, out_hw):
    """jax.image.resize antialiases when it shrinks; so does the port's
    downsample (F.interpolate(antialias=True)), for flows and masks."""
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, *in_hw, 2)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_hw, 2),
                                       "bilinear"))
    np.testing.assert_allclose(
        downsample_bilinear(to_torch(x), out_hw).numpy(), want, atol=1e-6,
        rtol=0)
    m = (rng.random((2, *in_hw)) > 0.5).astype(np.float32)
    want_m = np.asarray(jax.image.resize(jnp.asarray(m), (2, *out_hw),
                                         "bilinear"))
    np.testing.assert_allclose(
        downsample_bilinear(to_torch(m), out_hw).numpy(), want_m, atol=1e-6,
        rtol=0)


def test_resize_half_pixel_refuses_downsampling():
    with pytest.raises(ValueError, match="upsamples"):
        resize_bilinear(torch.zeros(1, 8, 8, 2), (4, 4))


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------

def test_build_knows_both_kernel_sources():
    from pwcnet_tpu_torch.ops.kernels import (conv_folded_kernel,
                                              corr_lookup_kernel,
                                              corr_pyramid_kernel,
                                              encoder_norm_kernel,
                                              global_attention_kernel,
                                              window_attention_kernel)
    assert build.kernel_names() == ["conv_folded", "corr_lookup",
                                    "corr_pyramid", "cost_volume",
                                    "cost_volume_bwd", "encoder_norm",
                                    "global_attention", "stem", "warp_corr",
                                    "window_attention"]
    src = {cost_volume_kernel.SOURCE, cost_volume_kernel.BWD_SOURCE,
           stem_kernel.SOURCE, warp_corr_kernel.SOURCE,
           conv_folded_kernel.SOURCE, corr_pyramid_kernel.SOURCE,
           corr_lookup_kernel.SOURCE, encoder_norm_kernel.SOURCE,
           global_attention_kernel.SOURCE, window_attention_kernel.SOURCE}
    assert src == {f"pwcnet_tpu_torch/csrc/{n}.cu"
                   for n in build.kernel_names()}
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("int x;\n")
    (src / "b.cu").write_text("int y;\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no compiler here"):
        build.build_all()
    assert not list((tmp_path / "out").glob("*.so"))


def _fake_nvcc(tmp_path, monkeypatch, seconds):
    """Sources a.cu, b.cu and an ``nvcc`` that copies a real shared library
    to its ``-o`` after ``seconds``."""
    import _ctypes
    src = tmp_path / "csrc"
    src.mkdir()
    for n in "ab":
        (src / f"{n}.cu").write_text(f"int {n};\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && "
                    "out=$2; shift; done\n"
                    f"sleep {seconds}\ncp {_ctypes.__file__} \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_pending", {})
    started = []
    real = build._start
    monkeypatch.setattr(build, "_start",
                        lambda n: started.append(n) or real(n))
    return started


def test_start_compiles_side_by_side_and_load_library_takes_the_job(
        tmp_path, monkeypatch):
    """``start`` begins every compile at once and returns while they run;
    ``load_library`` waits for the one it needs instead of starting it
    again; a built kernel starts nothing."""
    started = _fake_nvcc(tmp_path, monkeypatch, 0.5)
    build.start(["a", "b"])
    assert started == ["a", "b"]
    assert all(job[1].poll() is None for _, job in build._pending.values())
    build.load_library("a")
    build.load_library("b")
    assert started == ["a", "b"] and not build._pending
    build.start(["a", "b"])
    assert started == ["a", "b"] and not build._pending
    assert len(list((tmp_path / "out").glob("*.so"))) == 2


def test_a_compile_no_one_takes_is_stopped_at_exit(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 30)
    build.start(["b"])
    (_, proc, tmp, _), = [job for _, job in build._pending.values()]
    build._stop_pending()
    assert proc.poll() is not None and not build._pending
    assert not tmp.exists()
    assert not list((tmp_path / "out").glob("*.so"))

