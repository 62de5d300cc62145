"""Published RAFT's encoder norms (``ops/encoder_norm.py``; K10,
``csrc/encoder_norm.cu``, on a card).

On the CPU: the plain version of a norm with its ReLU and a residual
block's join is bit-equal to the composition the encoders ran before K10
(written out here as it was), both encoders' outputs too; CPU tensors
take the plain version and tensors off the CPU K10, in any layout; the
wrapper refuses what K10 does not take. The ``cuda`` tests hold K10 to the plain version, to itself and
under graph capture, count its launches a forward and compare a training
step's gradients. No JAX: the reference is plain PyTorch.
"""

import pytest
import torch
import torch.nn.functional as F

from pwcnet_tpu_torch.models import raft_allpairs
from pwcnet_tpu_torch.models.init import init_params
from pwcnet_tpu_torch.models.raft_allpairs import (BasicEncoder,
                                                   FrozenBatchNorm,
                                                   InstanceNorm)
from pwcnet_tpu_torch.ops.encoder_norm import (INSTANCE, bf16_tolerance,
                                               encoder_norm, encoder_norm_ref,
                                               norm_ref)
from pwcnet_tpu_torch.ops.kernels import encoder_norm_kernel as enk

from torch_port_util import need_cuda, rel_err

CL = torch.channels_last
KINDS = ["instance", "batch"]
JOINS = [None, "identity", "down"]
DTYPES = [torch.bfloat16, torch.float32]
RAGGED = [(2, 8, 7, 9), (1, 200, 5, 3), (2, 64, 9, 11), (1, 96, 6, 5),
          (1, 128, 3, 7)]
# The encoders' norm shapes at the cell's 440x1024 (fnet: both frames).
CELL = [(2, 64, 220, 512), (2, 96, 110, 256), (2, 128, 55, 128)]


# -- the composition before K10, written out as the encoders ran it ---------

def _instance_before(x):
    xf = x.float()
    var, mean = torch.var_mean(xf, (2, 3), correction=0, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def _batch_before(bn, x):
    mul = torch.rsqrt(bn.running_var + 1e-5) * bn.weight
    add = bn.bias - bn.running_mean * mul
    return (x.float() * mul[:, None, None] + add[:, None, None]).to(x.dtype)


def _norm_before(module, x):
    if isinstance(module, InstanceNorm):
        return _instance_before(x)
    return _batch_before(module, x)


def _join_before(norm, x, skip=None, skip_norm=None):
    y = F.relu(_norm_before(norm, x))
    if skip is None:
        return y
    if skip_norm is not None:
        skip = _norm_before(skip_norm, skip)
    return F.relu(skip + y)


def _encoder_before(enc, x):
    x = F.relu(_norm_before(enc.norm1, enc.conv1(x)))
    for b in enc.blocks:
        y = F.relu(_norm_before(b.norm1, b.conv1(x)))
        y = F.relu(_norm_before(b.norm2, b.conv2(y)))
        if b.down is not None:
            x = _norm_before(b.norm3, b.down(x))
        x = F.relu(x + y)
    return enc.conv2(x)


# -- inputs -------------------------------------------------------------------

def _conv_like(shape, g, dtype, device="cpu"):
    """Channels-last values as a conv leaves them: per-channel offsets and
    scales, so that means are off zero."""
    n, c, h, w = shape
    x = torch.randn(shape, generator=g) * (0.5 + torch.rand(
        (1, c, 1, 1), generator=g) * 1.5) + 2 * torch.randn((1, c, 1, 1),
                                                             generator=g)
    return x.to(device, dtype).contiguous(memory_format=CL)


def _batch_norm(c, g, device="cpu"):
    """A FrozenBatchNorm off the identity."""
    bn = FrozenBatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(torch.randn(c, generator=g))
        bn.running_var.copy_(1 + torch.rand(c, generator=g))
    return bn.to(device)


def _case(kind, join, shape, dtype, seed, device="cpu"):
    """(x, norm module, skip, skip norm module) of one case."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]

    def module():
        return InstanceNorm() if kind == "instance" else _batch_norm(
            c, g, device)
    x = _conv_like(shape, g, dtype, device)
    skip = skip_norm = None
    if join == "identity":
        skip = F.relu(_conv_like(shape, g, dtype, device))
    elif join == "down":
        skip, skip_norm = _conv_like(shape, g, dtype, device), module()
    return x, module(), skip, skip_norm


def _terms(module):
    return None if module is None else module.terms()


# -- the CPU cases ------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", RAGGED, ids=str)
@pytest.mark.parametrize("join", JOINS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_version_is_the_composition_before(kind, join, shape, dtype):
    x, norm, skip, skip_norm = _case(kind, join, shape, dtype, 1)
    want = _join_before(norm, x, skip, skip_norm)
    got = encoder_norm_ref(x, norm.terms(), skip, _terms(skip_norm))
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(encoder_norm(x, norm.terms(), skip,
                                    _terms(skip_norm)), want)


def _pair(device, layout, dtype=torch.float32):
    """(x, skip) of one shape, in ``layout``: a memory format, or
    "strided" for a view with no contiguous layout."""
    g = torch.Generator().manual_seed(2)
    x, skip = (torch.randn((2, 16, 5, 14), generator=g).to(device, dtype)
               for _ in range(2))
    if layout == "strided":
        return x[..., ::2], skip[..., ::2]
    return tuple(t.contiguous(memory_format=layout) for t in (x, skip))


@pytest.mark.parametrize("layout", [CL, torch.contiguous_format, "strided"],
                         ids=["channels_last", "contiguous", "strided"])
def test_cpu_tensors_take_the_plain_version(layout):
    before = dict(enk.LAUNCHES)
    x, skip = _pair("cpu", layout)
    got = encoder_norm(x, INSTANCE, skip, INSTANCE)
    assert dict(enk.LAUNCHES) == before
    assert torch.equal(got, encoder_norm_ref(x, INSTANCE, skip, INSTANCE))


@pytest.mark.parametrize("layout", [CL, torch.contiguous_format, "strided"],
                         ids=["channels_last", "contiguous", "strided"])
def test_tensors_off_the_cpu_take_the_kernel_in_any_layout(layout):
    """A tensor off the CPU never takes the plain version: a meta tensor,
    whatever its layout, reaches K10's wrapper, which refuses it for not
    being on a card, before any launch."""
    before = dict(enk.LAUNCHES)
    x, skip = _pair("meta", layout)
    with pytest.raises(ValueError, match="CUDA"):
        encoder_norm(x, INSTANCE)
    with pytest.raises(ValueError, match="CUDA"):
        encoder_norm(x, INSTANCE, skip, INSTANCE)
    assert dict(enk.LAUNCHES) == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", KINDS)
def test_basic_encoder_output_is_the_composition_before(kind, dtype):
    g = torch.Generator().manual_seed(3)
    enc = BasicEncoder(32, kind)
    init_params(enc, g)
    if kind == "batch":
        for m in enc.modules():
            if isinstance(m, FrozenBatchNorm):
                m.load_state_dict(_batch_norm(m.weight.shape[0],
                                              g).state_dict())
    x = torch.randn((2, 3, 40, 48), generator=g).to(dtype).contiguous(
        memory_format=CL)
    with torch.no_grad():
        got, want = enc(x), _encoder_before(enc, x)
    assert got.shape == (2, 32, 5, 6) and torch.equal(got, want)


def _refusal(case):
    x = torch.zeros((1, 16, 3, 5)).contiguous(memory_format=CL)
    terms = (torch.ones(16), torch.zeros(16))
    return {"f16": lambda: enk.encoder_norm_cuda(x.half(), INSTANCE),
            "f64": lambda: enk.encoder_norm_cuda(x.double(), terms),
            "rank3": lambda: enk.encoder_norm_cuda(x[0], INSTANCE),
            "empty": lambda: enk.encoder_norm_cuda(x[:, :, :0], INSTANCE),
            "c12": lambda: enk.encoder_norm_cuda(x[:, :12], INSTANCE),
            "c2056": lambda: enk.encoder_norm_cuda(
                torch.zeros((1, 2056, 1, 1)), INSTANCE),
            "terms_shape": lambda: enk.encoder_norm_cuda(
                x, (torch.ones(8), torch.zeros(8))),
            "terms_dtype": lambda: enk.encoder_norm_cuda(
                x, tuple(t.double() for t in terms)),
            "terms_strided": lambda: enk.encoder_norm_cuda(
                x, tuple(torch.ones(32)[::2] for _ in terms)),
            "unknown_norm": lambda: enk.encoder_norm_cuda(x, "group"),
            "skip_shape": lambda: enk.encoder_norm_cuda(
                x, INSTANCE, x[:, :8]),
            "skip_dtype": lambda: enk.encoder_norm_cuda(
                x, INSTANCE, x.to(torch.bfloat16)),
            "skip_norm_alone": lambda: enk.encoder_norm_cuda(
                x, INSTANCE, None, INSTANCE),
            "cpu": lambda: enk.encoder_norm_cuda(x, INSTANCE, x, terms)}[case]


@pytest.mark.parametrize("case,error", [
    ("f16", TypeError), ("f64", TypeError), ("rank3", ValueError),
    ("empty", ValueError), ("c12", ValueError), ("c2056", ValueError),
    ("terms_shape", ValueError), ("terms_dtype", ValueError),
    ("terms_strided", ValueError),
    ("unknown_norm", ValueError), ("skip_shape", ValueError),
    ("skip_dtype", ValueError), ("skip_norm_alone", ValueError),
    ("cpu", ValueError)])
def test_the_wrapper_refuses_what_k10_does_not_take(case, error):
    before = dict(enk.LAUNCHES)
    with pytest.raises(error):
        _refusal(case)()
    assert dict(enk.LAUNCHES) == before


def expected_launches(model) -> dict:
    """K10's launches a forward of published RAFT: the stem's norm, then
    two calls a block (the down path's norm joins the second), each an
    apply and, for instance norm, one statistics launch."""
    stats = apply = 0
    for enc in (model.fnet, model.cnet):
        apply += 1 + 2 * len(enc.blocks)
        if isinstance(enc.norm1, InstanceNorm):
            stats += 1 + 2 * len(enc.blocks)
    return {"stats": stats, "apply": apply}


def test_the_launch_formula_of_the_published_encoders():
    from pwcnet_tpu_torch.models import RAFTAllPairs
    model = RAFTAllPairs(num_iters=1, device="cpu")
    assert expected_launches(model) == {"stats": 13, "apply": 26}


# -- on a card ---------------------------------------------------------------

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
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CELL + RAGGED, ids=str)
@pytest.mark.parametrize("join", JOINS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_k10_matches_its_plain_version(card, kind, join, shape, dtype):
    x, norm, skip, skip_norm = _case(kind, join, shape, dtype, 4, card)
    terms, skip_terms = norm.terms(), _terms(skip_norm)
    with torch.no_grad():
        got = enk.encoder_norm_cuda(x, terms, skip, skip_terms)
        want = encoder_norm_ref(x, terms, skip, skip_terms)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    if kind == "batch":
        assert torch.equal(got, want)
    elif dtype == torch.float32:
        assert rel_err(got, want) <= 1e-5
    else:
        tol = bf16_tolerance(x, terms, skip, skip_terms)
        assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_k10_gives_the_same_bits_twice(card, kind):
    x, norm, skip, skip_norm = _case(kind, "down", CELL[0], torch.bfloat16,
                                     5, card)
    with torch.no_grad():
        a = enk.encoder_norm_cuda(x, norm.terms(), skip, skip_norm.terms())
        b = enk.encoder_norm_cuda(x, norm.terms(), skip, skip_norm.terms())
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [torch.contiguous_format, "strided"],
                         ids=["contiguous", "strided"])
def test_cuda_other_layouts_take_k10(card, layout):
    """Off channels-last, a CUDA tensor still takes K10 (made channels-last
    first): one statistics and one apply launch, the plain version's
    values."""
    x, skip = _pair(card, layout, torch.bfloat16)
    before = dict(enk.LAUNCHES)
    with torch.no_grad():
        got = encoder_norm(x, INSTANCE, skip, INSTANCE)
    launched = {k: v - before[k] for k, v in enk.LAUNCHES.items()}
    want = encoder_norm_ref(x, INSTANCE, skip, INSTANCE)
    assert launched == {"stats": 1, "apply": 1}
    assert got.is_contiguous(memory_format=CL)
    tol = bf16_tolerance(x, INSTANCE, skip, INSTANCE)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


def _allpairs(card, dtype, iters):
    from pwcnet_tpu_torch.models import RAFTAllPairs
    return RAFTAllPairs(num_iters=iters, dtype=dtype, device=card).eval()


@pytest.mark.cuda
def test_cuda_captured_forward_equals_eager(card):
    from pwcnet_tpu_torch.train.evaluate import infer_flow
    model = _allpairs(card, torch.bfloat16, 4)
    gen = torch.Generator().manual_seed(6)
    a, b = (torch.rand((1, 440, 1024, 3), generator=gen).to(card)
            for _ in range(2))
    for x, y in ((a, b), (b, a), (a, b)):
        assert torch.equal(infer_flow(model, x, y, capture=True),
                           infer_flow(model, x, y, capture=False))


@pytest.mark.cuda
def test_cuda_launches_a_forward_follow_the_formula(card):
    model = _allpairs(card, torch.bfloat16, 2)
    im = torch.rand((1, 128, 256, 3), device=card)
    with torch.inference_mode():
        model(im, im, train=False)
        torch.cuda.synchronize()
        before = dict(enk.LAUNCHES)
        model(im, im, train=False)
    got = {k: v - before[k] for k, v in enk.LAUNCHES.items()}
    assert got == expected_launches(model) == {"stats": 13, "apply": 26}


@pytest.mark.cuda
@pytest.mark.parametrize("join", JOINS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_function_gradients_are_the_plain_versions(card, kind, join):
    """The Function's backward is autograd of the plain version on the same
    inputs: the same gradients, bit for bit."""
    x, norm, skip, skip_norm = _case(kind, join, (2, 64, 19, 23),
                                     torch.float32, 7, card)
    leaves = [t.requires_grad_() for t in (x, skip) if t is not None]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)
                    ).to(card)
    params = [p for m in (norm, skip_norm) if m is not None
              for p in m.parameters()]
    grads = []
    for fn in (enk.encoder_norm_fn, encoder_norm_ref):
        out = fn(x, norm.terms(), skip, _terms(skip_norm))
        grads.append(torch.autograd.grad((out * g).sum(), leaves + params))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _instance_other_order(x, norm, skip=None, skip_norm=None):
    """The plain version with instance norm's statistics summed in another
    order (``var_mean`` of an NCHW copy): as valid an f32 result as
    ``var_mean``'s of the channels-last tensor, and K10's."""
    def norm_other(t, nm):
        if not isinstance(nm, str):
            return norm_ref(t, nm)
        tf = t.float()
        var, mean = torch.var_mean(tf.contiguous(), (2, 3), correction=0,
                                   keepdim=True)
        return ((tf - mean) * torch.rsqrt(var + 1e-5)).to(t.dtype)
    y = F.relu(norm_other(x, norm))
    if skip is None:
        return y
    if skip_norm is not None:
        skip = norm_other(skip, skip_norm)
    return F.relu(skip + y)


def _train_step_gaps(monkeypatch, fns):
    """One f32 sequence-loss step of published RAFT (2 iterations, 64x128)
    with the encoders' norms through each of ``fns``; each leaf's max
    error against the first's, over that leaf's max (at least 1e-3 of the
    largest): {fn's index: {leaf: gap}}."""
    card = torch.device("cuda")
    model = _allpairs(card, torch.float32, 2).train()
    gen = torch.Generator().manual_seed(8)
    im1, im2 = (torch.rand((1, 64, 128, 3), generator=gen).to(card)
                for _ in range(2))
    gt = (3 * torch.randn((1, 64, 128, 2), generator=gen)).to(card)
    grads = []
    for fn in fns:
        monkeypatch.setattr(raft_allpairs, "encoder_norm", fn)
        model.zero_grad()
        _, loss = model(im1, im2, gt=gt)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    ref = grads[0]
    top = max(float(v.abs().max()) for v in ref.values())
    gaps = {}
    for i, got in enumerate(grads[1:], 1):
        assert set(got) == set(ref)
        gaps[i] = {k: float((got[k] - want).abs().max())
                   / max(float(want.abs().max()), 1e-3 * top)
                   for k, want in ref.items()}
    return gaps


@pytest.mark.cuda
def test_cuda_train_step_gradients_match_the_plain_path(monkeypatch):
    """One f32 step through K10 and with every norm on the plain version:
    frozen batch norm is bit-equal, so instance norm's f32 statistics move
    the gradients, and the lookup's backward adds atomically (no
    deterministic mode: grid_sample's backward has none); each leaf within
    1e-4 of its max. TF32 is off here: its rounding of the conv inputs
    turns the statistics' last-bit differences into 2**-11 steps (the
    TF32 case below)."""
    need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gaps = _train_step_gaps(monkeypatch, [encoder_norm_ref, encoder_norm])
    assert max(gaps[1].values()) <= 1e-4, gaps[1]


@pytest.mark.cuda
def test_cuda_train_step_with_tf32_moves_as_any_summation_order(monkeypatch):
    """The f32 step as training runs it, TF32 on (PyTorch's default for
    cuDNN). There the gradients move by tenths of a leaf's max under any
    last-bit change of the statistics: the plain version run twice gives
    the same bits, but with its statistics summed in another order it is
    16-32% off on the worst leaf (seeds 8-13 on an H100). K10's gap is held
    to three times that control's, on the worst leaf (1.4x at this
    seed)."""
    need_cuda()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    gaps = _train_step_gaps(monkeypatch, [encoder_norm_ref, encoder_norm,
                                          _instance_other_order])
    k10, other = max(gaps[1].values()), max(gaps[2].values())
    assert 0 < other and k10 <= 3 * other, (k10, other)
