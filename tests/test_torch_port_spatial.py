"""The port's spatially sharded inference held against the JAX package's.

The JAX side runs on the fake 8-device CPU mesh of ``tests/conftest.py``,
as ``tests/test_halo.py`` does; its Pallas kernels run in interpret mode.
The port runs its plain versions on the CPU: the per-shard functions in
this process, and ``spatial_forward`` / ``exchange_halo`` in one ``gloo``
worker process per rank (``pwcnet_tpu_torch.parallel.launch``), started
once per shard count with every check of that count in one job. Flows are
compared per level by relative max error, ``max|got - ref| <= 1e-4 *
max|ref|``; the per-shard ops by the tolerance stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pwcnet_tpu.models import PWCNet as JaxPWCNet
from pwcnet_tpu.ops.cost_volume import cost_volume_prepadded_lax
from pwcnet_tpu.ops.pallas.cost_volume_kernel import (
    cost_volume_pallas_prepadded)
from pwcnet_tpu.ops.pallas.stem_kernel import stem_ref as jax_stem_ref
from pwcnet_tpu.ops.resize import resize_bilinear as jax_resize
from pwcnet_tpu.parallel import MeshConfig as JaxMeshConfig
from pwcnet_tpu.parallel import SPATIAL_AXIS as JAX_AXIS
from pwcnet_tpu.parallel import exchange_halo as jax_exchange_halo
from pwcnet_tpu.parallel import make_mesh as jax_make_mesh
from pwcnet_tpu.parallel import warp_corr_spatial as jax_warp_corr_spatial
from pwcnet_tpu.parallel.halo import _warp_ext, _warp_ext_corners
from pwcnet_tpu.parallel.spatial import pad_for_spatial as jax_pad
from pwcnet_tpu.parallel.spatial import spatial_forward as jax_spatial_forward
from pwcnet_tpu_torch import PWCNet
from pwcnet_tpu_torch.compat import load_flax_params
from pwcnet_tpu_torch.ops.cost_volume import cost_volume_prepadded_ref
from pwcnet_tpu_torch.ops.kernels.stem_kernel import stem_ref
from pwcnet_tpu_torch.ops.resize import resize_bilinear
from pwcnet_tpu_torch.ops.warp import (warp_bilinear, warp_ext_corners_ref,
                                       warp_ext_ref)
from pwcnet_tpu_torch.parallel import (GridMesh, MeshConfig, make_mesh,
                                       pad_for_spatial, required_divisor,
                                       spatial_forward,
                                       warp_corr_spatial_local)
from pwcnet_tpu_torch.parallel.halo import corr_halo
from pwcnet_tpu_torch.parallel.launch import run_ranks
from pwcnet_tpu_torch.parallel.spatial_ops import (STEM_RECEPTIVE, STEM_ROWS,
                                                   real_rows, stem_block,
                                                   upsample2x_block)

from torch_port_util import (ext_rows, jax_sharded, rel_err, stem_params,
                             to_torch, torch_stem_params)

TOL = 1e-4
HW = (64, 48)
# num_levels=3: min_level 1, no stem. num_levels=4: min_level 2, the stem's
# halo path runs, and under S = 4 level 4 has one row per shard, so the
# correlation's halo (2 rows) takes two hops.
CFGS = {"l3": dict(num_levels=3, output_level=2, search_range=2),
        "l4": dict(num_levels=4, output_level=2, search_range=2)}
BACKENDS = ("pallas", "fused")
SHARDS = (2, 4)
HALOS = (2, 5)  # one hop; several hops (5 > 4 rows a shard under S = 4)
WORKER_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.random((1, *HW, 3), np.float32),
            rng.random((1, *HW, 3), np.float32))


@pytest.fixture(scope="module")
def jax_runs(images):
    """Flax params per config, and JAX spatial_forward per (S, config,
    backend) with fused_min_pixels=0 (the fused island everywhere)."""
    im1, im2 = images
    params, out = {}, {}
    for name, cfg in CFGS.items():
        jm = JaxPWCNet(corr_backend="pallas", **cfg)
        params[name] = jax.device_get(
            jax.jit(jm.init)(jax.random.key(0), im1, im2))["params"]
        for s in SHARDS:
            mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=s))
            for backend in BACKENDS:
                model = JaxPWCNet(corr_backend=backend, fused_min_pixels=0,
                                  **cfg)
                flows, full = jax_spatial_forward(
                    model, {"params": params[name]}, mesh, im1, im2)
                out[s, name, backend] = ([np.asarray(f) for f in flows],
                                         np.asarray(full))
    return params, out


_PORT_RUNS = {}


def _port_run(s, images, params, tmp_root):
    """One gloo job of s worker ranks: the exchanges, then spatial_forward
    for every config and backend (the port's plain versions on the CPU)."""
    if s in _PORT_RUNS:
        return _PORT_RUNS[s]
    im1, im2 = images
    x = torch.arange(16.0).reshape(1, 16, 1, 1)
    tasks = [dict(kind="exchange", x=x, top=h, bottom=h) for h in HALOS]
    for name, cfg in CFGS.items():
        model = PWCNet(device="cpu", **cfg)
        load_flax_params(model, params[name])
        for backend in BACKENDS:
            tasks.append(dict(
                kind="forward", state_dict=model.state_dict(),
                im1=to_torch(im1), im2=to_torch(im2),
                model=dict(corr_backend=backend, fused_min_pixels=0, **cfg)))
    res = run_ranks(s, dict(backend="gloo", device="cpu", threads=1,
                            tasks=tasks), str(tmp_root / f"s{s}"),
                    timeout=WORKER_TIMEOUT_S)
    _PORT_RUNS[s] = res
    return res


@pytest.fixture(scope="module")
def port_runs(images, jax_runs, tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    return lambda s: _port_run(s, images, jax_runs[0], root)


def _task_index(name, backend):
    return len(HALOS) + list(CFGS).index(name) * len(BACKENDS) \
        + BACKENDS.index(backend)


# -- exchange_halo ---------------------------------------------------------

@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("halo", HALOS)
def test_exchange_halo_matches_jax(port_runs, s, halo):
    """Values, zeros at the global edges, and multi-hop (halo 5 > t = 4
    under S = 4), against JAX exchange_halo under shard_map."""
    mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=s))
    x = jnp.arange(16.0).reshape(1, 16, 1, 1)
    f = jax.jit(jax.shard_map(lambda a: jax_exchange_halo(a, halo),
                              in_specs=P(None, JAX_AXIS),
                              out_specs=P(None, JAX_AXIS)))
    with jax.set_mesh(mesh):
        want = np.asarray(f(jax_sharded(mesh, x)))[0, :, 0, 0]
    want = want.reshape(s, 16 // s + 2 * halo)
    runs = port_runs(s)
    for r in range(s):
        got = runs[r][HALOS.index(halo)][0, :, 0, 0].numpy()
        np.testing.assert_array_equal(got, want[r])
    assert (want[0][:halo] == 0).all() and (want[-1][-halo:] == 0).all()


# -- the whole sharded forward ---------------------------------------------

@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_spatial_forward_matches_jax(port_runs, jax_runs, s, name, backend):
    want_flows, want_full = jax_runs[1][s, name, backend]
    runs = port_runs(s)
    got = runs[0][_task_index(name, backend)]
    assert len(got["flows"]) == len(want_flows)
    for g, w in zip(got["flows"], want_flows):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) <= TOL
    assert rel_err(got["full"].numpy(), want_full) <= TOL
    # Replicated: every rank returns the same flows.
    for r in range(1, s):
        other = runs[r][_task_index(name, backend)]
        for a, b in zip(got["flows"], other["flows"]):
            assert torch.equal(a, b)
    assert np.abs(want_flows[-1]).max() > 1e-3  # the flows carry signal


def test_spatial_forward_one_rank_matches_unsharded(images):
    """S = 1 needs no process group: the spatial path on one rank equals
    the unsharded port forward."""
    im1, im2 = (to_torch(a) for a in images)
    for cfg in CFGS.values():
        model = PWCNet(device="cpu", **cfg).eval()
        mesh = make_mesh(MeshConfig(spatial=1), device="cpu")
        with torch.no_grad():
            flows, full = spatial_forward(model, mesh, im1, im2)
            want = model(im1, im2)
        for g, w in zip(flows, want):
            assert rel_err(g.numpy(), w.numpy()) <= TOL
        assert full.shape == (1, *HW, 2)


# -- per-shard ops ---------------------------------------------------------

@pytest.mark.parametrize("row0", [0, 8, 24])  # top, interior, bottom shard
@pytest.mark.parametrize("scale", [0.5, 6.0])  # 6 px reaches past the halo
def test_warp_ext_matches_jax_shard(row0, scale):
    """The halo-extended warp and its corner split against JAX's
    _warp_ext_corners / _warp_ext on one shard, including samples beyond
    the exchanged rows (the halo-bound clamp)."""
    rng = np.random.default_rng(int(row0 + 10 * scale))
    n, t, w, c, halo, d, h = 2, 8, 12, 6, 3, 2, 32
    f2 = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow_g = (scale * rng.standard_normal((n, h, w, 2))).astype(np.float32)
    f2e = ext_rows(f2, row0, t, halo, halo)
    flow_e = ext_rows(flow_g, row0, t, d, d)
    g_j, wm_j = _warp_ext_corners(jnp.asarray(f2e), jnp.asarray(flow_e),
                                  jnp.int32(row0), h, halo, d)
    g_p, wm_p = warp_ext_corners_ref(to_torch(f2e), to_torch(flow_e), row0,
                                     h, halo, d)
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(wm_p.numpy(), np.asarray(wm_j), atol=1e-7)
    want = np.asarray(_warp_ext(jnp.asarray(f2e), jnp.asarray(flow_e),
                                jnp.int32(row0), h, halo, d))
    got = warp_ext_ref(to_torch(f2e), to_torch(flow_e), row0, h, halo,
                       d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # The shard's own rows of the unsharded warp: equal while the samples
    # (|flow| <= 1.7 px at scale 0.5) stay within the halo, different where
    # they reach past it.
    full = warp_bilinear(to_torch(f2),
                         to_torch(flow_g)).numpy()[:, row0:row0 + t]
    own = got[:, d:d + t]
    if scale < 1:
        np.testing.assert_allclose(own, full, atol=1e-5)
    else:
        assert np.abs(own - full).max() > 1e-2


@pytest.mark.parametrize("row0", [0, 8])
def test_warp_ext_nan_flow_matches_jax_shard(row0):
    """A NaN flow gathers at index 0 and keeps NaN weights (it used to turn
    into index -2**63 and raise): the corners, the weights and the warp are
    NaN where JAX's are, and equal elsewhere."""
    rng = np.random.default_rng(7 + row0)
    n, t, w, c, halo, d, h = 2, 8, 12, 6, 3, 2, 32
    f2 = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow_g = (2 * rng.standard_normal((n, h, w, 2))).astype(np.float32)
    f2e = ext_rows(f2, row0, t, halo, halo)
    flow_e = ext_rows(flow_g, row0, t, d, d)
    flow_e[0, 3, 4, 0] = flow_e[1, 6, 2, 1] = flow_e[1, 0, 0] = np.nan
    args = (row0, h, halo, d)
    g_j, wm_j = _warp_ext_corners(jnp.asarray(f2e), jnp.asarray(flow_e),
                                  jnp.int32(row0), h, halo, d)
    g_p, wm_p = warp_ext_corners_ref(to_torch(f2e), to_torch(flow_e), *args)
    want = np.asarray(_warp_ext(jnp.asarray(f2e), jnp.asarray(flow_e),
                                jnp.int32(row0), h, halo, d))
    got = warp_ext_ref(to_torch(f2e), to_torch(flow_e), *args).numpy()
    for a, b in ((g_p.numpy(), np.asarray(g_j)), (wm_p.numpy(),
                                                   np.asarray(wm_j)),
                 (got, want)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=0, atol=1e-6)
    assert np.isnan(want).sum() == 3 * c  # the three NaN pixels, no more


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cost_volume_prepadded_matches_jax(dtype):
    rng = np.random.default_rng(3)
    d = 3
    f1 = rng.standard_normal((2, 6, 13, 5)).astype(np.float32)
    f2e = rng.standard_normal((2, 6 + 2 * d, 13, 5)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    a, b = jnp.asarray(f1, jd), jnp.asarray(f2e, jd)
    got = cost_volume_prepadded_ref(to_torch(f1).to(td),
                                    to_torch(f2e).to(td), d)
    want_lax = cost_volume_prepadded_lax(a, b, d)
    want_pallas = cost_volume_pallas_prepadded(a, b, max_displacement=d,
                                               interpret=True)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for want in (want_lax, want_pallas):
        want = np.asarray(want.astype(jnp.float32))
        assert rel_err(got.float().numpy(), want) <= tol


@pytest.mark.parametrize("backend", ("lax",) + BACKENDS)
@pytest.mark.parametrize("flow", [None, 2.0, 8.0])
def test_warp_corr_spatial_local_matches_jax_shards(backend, flow):
    """warp_corr_spatial_local on each of 4 shards (exchanged rows built
    from the global arrays) against the JAX island's sharded output; flows
    of 8 px reach past the halo. fused_min_pixels=0 on both sides."""
    s, n, h, w, c, d, halo_rows = 4, 1, 32, 24, 8, 2, 8
    rng = np.random.default_rng(7)
    f1 = rng.standard_normal((n, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((n, h, w, c)).astype(np.float32)
    fl = None if flow is None else (
        flow * rng.standard_normal((n, h, w, 2))).astype(np.float32)
    mesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=s))

    def f(a, b, fw):
        return jax_warp_corr_spatial(a, b, fw, max_displacement=d,
                                     halo_rows=halo_rows, backend=backend,
                                     fused_min_pixels=0)

    with jax.set_mesh(mesh):
        want = np.asarray(jax.jit(f)(
            jax_sharded(mesh, f1), jax_sharded(mesh, f2),
            None if fl is None else jax_sharded(mesh, fl)))
    t = h // s
    halo = corr_halo(t, halo_rows, d)
    for r in range(s):
        row0 = r * t
        got = warp_corr_spatial_local(
            to_torch(f1[:, row0:row0 + t]),
            to_torch(ext_rows(f2, row0, t, halo, halo)),
            None if fl is None else to_torch(ext_rows(fl, row0, t, d, d)),
            row0=row0, h_global=h, halo=halo, max_displacement=d,
            backend=backend, fused_min_pixels=0)
        assert rel_err(got.numpy(), want[:, row0:row0 + t]) <= 1e-5


def test_stem_receptive_field():
    """Level-2 row j of the stem depends on image rows 4j-6 .. 4j+12: 6
    rows above its own 4 and 9 below. A perturbed image row moves exactly
    the level-2 rows whose field holds it."""
    params = torch_stem_params(stem_params(np.random.default_rng(0), 0.3))
    rng = np.random.default_rng(1)
    im = to_torch(rng.random((1, 64, 16, 3), np.float32))
    base = stem_ref(im, params)
    for row in (24, 25, 26, 27):
        bumped = im.clone()
        bumped[:, row] += 1.0
        moved = (stem_ref(bumped, params) - base).abs().amax((0, 2, 3)) > 0
        rows = torch.nonzero(moved).flatten().tolist()
        want = [j for j in range(16) if 4 * j - STEM_RECEPTIVE[0] <= row
                <= 4 * j + 3 + STEM_RECEPTIVE[1]]
        assert rows == want
    assert STEM_ROWS[0] >= STEM_RECEPTIVE[0] and STEM_ROWS[0] % 4 == 0
    assert STEM_ROWS[1] >= STEM_RECEPTIVE[1] and STEM_ROWS[1] % 4 == 0


@pytest.mark.parametrize("s", [1, 2, 4])
def test_stem_halo_rule_matches_jax_stem(s):
    """stem_block on each shard's exchanged rows (edge and interior shards)
    equals that shard's rows of the JAX stem on the whole image; 8 rows
    below in place of 12 would not."""
    hwio = stem_params(np.random.default_rng(2), 0.3)
    params = torch_stem_params(hwio)
    rng = np.random.default_rng(4)
    im = rng.random((2, 64, 24, 3), np.float32)
    want = np.asarray(jax_stem_ref(jnp.asarray(im), [
        (jnp.asarray(w), jnp.asarray(b)) for w, b in hwio]))
    t = 64 // s

    def stem(x):
        return stem_ref(x, params)

    for r in range(s):
        ext = to_torch(ext_rows(im, r * t, t, *STEM_ROWS))
        got = stem_block(ext, stem, t, r, s).numpy()
        lo = r * t // 4
        assert rel_err(got, want[:, lo:lo + t // 4]) <= TOL
        if r < s - 1:  # 8 rows of the shard below are too few
            block, above = real_rows(to_torch(ext_rows(im, r * t, t, 8, 8)), 8,
                                     8, t, r, s)
            short = stem(block)[:, above // 4:above // 4 + t // 4].numpy()
            assert rel_err(short, want[:, lo:lo + t // 4]) > TOL


@pytest.mark.parametrize("s", [1, 2, 4])
def test_upsample_halo_rule_matches_jax_resize(s):
    """upsample2x_block on each shard equals its rows of the JAX half-pixel
    resize of the whole flow, which renormalises (clamps) at the global
    edges."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 6, 2)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), (32, 12)))
    np.testing.assert_allclose(resize_bilinear(to_torch(x), (32, 12)).numpy(),
                               want, atol=1e-6)
    t = 16 // s
    for r in range(s):
        got = upsample2x_block(to_torch(ext_rows(x, r * t, t, 1, 1)), t, r, s)
        np.testing.assert_allclose(got.numpy(),
                                   want[:, 2 * r * t:2 * (r + 1) * t],
                                   atol=1e-6)


# -- padding and the entry's checks ----------------------------------------

@pytest.mark.parametrize("s", [1, 2, 4])
def test_pad_for_spatial_matches_jax(s):
    """A Sintel frame (436 x 1024) pads as the JAX package pads it:
    512 x 1024 under 2 and 4 shards (448 under one: the divisor is 64)."""
    model = PWCNet(device="cpu")
    mesh = GridMesh.line(1, None, 0, s, "cpu", None)
    jmesh = jax_make_mesh(JaxMeshConfig(data=1, spatial=s))
    img = np.zeros((1, 436, 1024, 3), np.float32)
    got, hw = pad_for_spatial(img, model, mesh)
    want, jhw = jax_pad(img, JaxPWCNet(), jmesh)
    assert got.shape == want.shape and hw == jhw == (436, 1024)
    assert required_divisor(model, mesh) == 64 * s
    assert got.shape[1] == (448 if s == 1 else 512)


def test_spatial_forward_rejects_indivisible_height():
    model = PWCNet(device="cpu", num_levels=3, output_level=2)
    mesh = make_mesh(MeshConfig(spatial=1), device="cpu")
    bad = torch.zeros(1, 36, 48, 3)
    with pytest.raises(ValueError, match="H=36 must be divisible by 8 for "
                       "spatial sharding"):
        spatial_forward(model, mesh, bad, bad)


def test_mesh_and_model_options():
    """The (data, spatial) grid builds (one process: a grid of one; the
    2x2 grid on four ranks is tests/test_torch_port_grid.py's), a grid of
    more processes than the group has is refused, and the spatial model
    takes align_corners."""
    grid = make_mesh(MeshConfig(data=1, spatial=1), device="cpu")
    assert (grid.shape, grid.size, grid.data_mesh.size,
            grid.spatial_mesh.size) == ((1, 1, 1), 1, 1, 1)
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh(MeshConfig(data=2, spatial=2), backend="gloo",
                  device="cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(MeshConfig(data=1, spatial=2), backend="gloo",
                  device="cpu")
    aligned = PWCNet(device="cpu", spatial_axis="spatial",
                     resize_mode="align_corners")
    assert aligned.resize_mode == "align_corners"
    model = PWCNet(device="cpu", spatial_axis="spatial", spatial_halo=4)
    assert (model.spatial_axis, model.spatial_halo) == ("spatial", 4)
    im = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="mesh"):
        model(im, im)
    mesh = make_mesh(MeshConfig(spatial=1), device="cpu")
    with torch.no_grad():
        flows = model(im, im, mesh=mesh)
    assert flows[-1].shape == (1, 16, 16, 2)
