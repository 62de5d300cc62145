"""The port's dataset readers, splits, resize, ``Loader`` and native
decoder held against the JAX package's, on the CPU.

Trees in each dataset's layout are written from a seed into ``tmp_path``
(``pwcnet_tpu_torch.data.trees``) and read by both packages. Decoding is
the same arithmetic on both sides (the port's PNG, PPM, PFM, .flo and KITTI
codecs against imageio, cv2 and the JAX package's), so arrays are compared
exactly; only the native decoder's 8-bit scaling (x * (1/255) against
x / 255) may differ, by one float32 step.
"""

import ctypes
import logging
import shutil
import subprocess
import tempfile
import time

import cv2
import numpy as np
import pytest

import pwcnet_tpu.data.base as jbase
import pwcnet_tpu.data.datasets  # noqa: F401  (registers the JAX readers)
import pwcnet_tpu.data.pipeline as jpipe
from pwcnet_tpu import native as jnative
from pwcnet_tpu_torch import native
from pwcnet_tpu_torch.data import base as tbase
from pwcnet_tpu_torch.data import pipeline as tpipe
from pwcnet_tpu_torch.data import trees

KEYS = ("im1", "im2", "flow", "valid")


def _build(tmp_path, kind):
    """(dataset name, root, reader kwargs) of a small tree of ``kind``."""
    root = str(tmp_path / kind)
    if kind == "chairs":
        return "flyingchairs", trees.write_chairs(root, 12, (24, 40)), {}
    if kind == "chairs_split_file":
        labels = [1, 2, 1, 1, 2, 1, 1, 1, 2, 1]
        return "flyingchairs", trees.write_chairs(
            root, 10, (24, 40), seed=1, split_labels=labels), {}
    if kind == "things_subset":
        trees.write_things(root, 5, (20, 36), seed=2, split="val")
        return "flyingthings", trees.write_things(root, 6, (20, 36),
                                                  seed=3), {}
    if kind == "things_full":
        trees.write_things(root, 3, (20, 36), seed=4, layout="full",
                           split="val")
        return "flyingthings", trees.write_things(
            root, 6, (20, 36), seed=5, layout="full"), {}
    if kind in ("sintel_clean", "sintel_final"):
        return "sintel", trees.write_sintel(root, 6, 3, (18, 30), seed=6), {
            "render_pass": kind.split("_")[1]}
    if kind == "kitti":
        return "kitti", trees.write_kitti(root, 11, (21, 43), seed=7), {}
    raise ValueError(kind)


KINDS = ["chairs", "chairs_split_file", "things_subset", "things_full",
         "sintel_clean", "sintel_final", "kitti"]


@pytest.mark.parametrize("kind", KINDS)
def test_readers_match_jax(tmp_path, kind):
    name, root, kw = _build(tmp_path, kind)
    sizes = {}
    for split in ("train", "val", "all"):
        got = tbase.get_dataset(name, root, split=split, **kw)
        want = jbase.get_dataset(name, root, split=split, **kw)
        assert [tuple(vars(r).values()) for r in got.records] == [
            tuple(vars(r).values()) for r in want.records]
        sizes[split] = len(got)
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert g.keys() == w.keys() == set(KEYS)
            for k in KEYS:
                assert g[k].dtype == np.float32, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert sizes["val"] >= 1
    if name == "kitti":
        valid = got[0]["valid"]
        assert 0 < valid.mean() < 1  # sparse ground truth
        assert (got[0]["flow"][valid == 0] == 0).all()
    if name == "sintel":  # whole scenes on one side
        scenes = {s: {r.im1.split("/")[-2] for r in tbase.get_dataset(
            name, root, split=s, **kw).records} for s in ("train", "val")}
        assert scenes["train"].isdisjoint(scenes["val"])
    if kind == "chairs_split_file":
        assert (sizes["train"], sizes["val"]) == (7, 3)


def test_registry_and_missing_roots(tmp_path):
    assert tbase.available_datasets() == ["flyingchairs", "flyingthings",
                                          "kitti", "sintel", "synthetic"]
    for name in ("flyingchairs", "flyingthings", "sintel", "kitti"):
        with pytest.raises(FileNotFoundError):
            tbase.get_dataset(name, str(tmp_path / "absent"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no \\*_flow.flo"):
        tbase.get_dataset("flyingchairs", str(tmp_path / "empty"))


@pytest.mark.parametrize("split", ["train", "val", "all"])
@pytest.mark.parametrize("n", [1, 9, 23])
def test_splits_pick_the_jax_records(split, n):
    recs = [jbase.SampleRecord(f"a{i}", f"b{i}", f"f{i}") for i in range(n)]
    mine = [tbase.SampleRecord(*vars(r).values()) for r in recs]
    want = jbase.FlowDataset.split_records(recs, split, seed=3)
    got = tbase.FlowDataset.split_records(mine, split, seed=3)
    assert [r.im1 for r in got] == [r.im1 for r in want]
    keys = [f"s{i % 4}" for i in range(n)]
    want = jbase.FlowDataset.split_groups(recs, keys, split, seed=3)
    got = tbase.FlowDataset.split_groups(mine, keys, split, seed=3)
    assert [r.im1 for r in got] == [r.im1 for r in want]


RESIZES = [((37, 53), (20, 31)), ((20, 31), (37, 53)), ((64, 96), (32, 48)),
           ((375, 1242), (384, 1280)), ((436, 1024), (448, 1024)),
           ((9, 7), (30, 2)), ((540, 960), (384, 768))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_cv2(src, dst):
    rng = np.random.default_rng(8)
    for shape in (src, (*src, 1), (*src, 3)):
        im = rng.random(shape, np.float32)
        got = tbase.resize_sample(im, dst)
        want = cv2.resize(im, (dst[1], dst[0]),
                          interpolation=cv2.INTER_LINEAR).reshape(got.shape)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5, shape
    flow = (rng.standard_normal((*src, 2)) * 20).astype(np.float32)
    got, want = tbase.resize_flow(flow, dst), jbase.resize_flow(flow, dst)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(flow).max()


# ---------------------------------------------------------------------------
# Loader and native decoder
# ---------------------------------------------------------------------------

def _jax_native_loaded(wait_s=30.0):
    """JAX's native library, loaded for real (ROADMAP C9).

    ``pwcnet_tpu/native/__init__.py`` builds ``_libpwcnative.so`` in place,
    and a process whose ``ctypes.CDLL`` opens it while another process's
    linker is still writing it caches ``_tried=True, _lib=None`` for good,
    and JAX's ``Loader`` then quietly decodes in Python. So while the
    library is missing and g++ exists, clear that cache and load again
    until the file is whole. A real build failure still fails, with the
    compiler's or the loader's reason."""
    deadline = time.monotonic() + wait_s
    while jnative.load() is None and shutil.which("g++"):
        if time.monotonic() > deadline:
            break
        jnative._lib, jnative._tried = None, False
        if jnative.load() is None:
            time.sleep(0.5)
    lib = jnative.load()
    assert lib is not None, _jax_native_failure()
    return lib


def _jax_native_failure() -> str:
    """Why JAX's native library does not load: the loader's error on the
    file, then the compiler's on a private copy of the build."""
    if shutil.which("g++") is None:
        return "g++ not found: JAX's native decoder cannot be built"
    why = []
    try:
        ctypes.CDLL(jnative._LIB_PATH)
    except OSError as e:
        why.append(f"loading {jnative._LIB_PATH}: {e}")
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             jnative._SRC, "-o", f"{d}/lib.so"],
            capture_output=True, text=True, timeout=300)
        why.append(f"g++ exit {r.returncode}: {r.stderr[-2000:]}")
    return "; ".join(why)


def test_jax_native_recovers_from_a_lost_build_race():
    """The state a process is left in when it loses JAX's build race
    (``_tried`` set, no library) is undone by ``_jax_native_loaded``, and
    JAX's decoder then runs natively."""
    jnative._tried, jnative._lib = True, None
    assert jnative.load() is None and not jnative.available()
    lib = _jax_native_loaded()
    assert lib is jnative.load() and jnative.available()


def _loader_pair(ds_t, ds_j, **kw):
    return tpipe.Loader(ds_t, **kw), jpipe.Loader(ds_j, **kw)


@pytest.mark.parametrize("kind,kw", [
    # 11 train pairs in batches of 4: an epoch of 2 steps, so steps 0-4
    # cross two epoch boundaries; the native path on both sides.
    ("chairs", dict(global_batch=4, sample_hw=(32, 40), seed=3)),
    # Resume at step 3, rows of process 1 of 2, samples center-cropped.
    ("chairs", dict(global_batch=4, sample_hw=(16, 24), seed=5,
                    start_step=3, process_index=1, process_count=2)),
    # More rows than samples: the tail wraps; the Python path (PNG + .flo).
    ("sintel_clean", dict(global_batch=12, sample_hw=(20, 30), seed=1,
                          process_index=0, process_count=2)),
    ("kitti", dict(global_batch=3, sample_hw=(24, 48), seed=2,
                   start_step=1)),
])
def test_loader_matches_jax(tmp_path, kind, kw):
    name, root, rkw = _build(tmp_path, kind)
    ds_t = tbase.get_dataset(name, root, **rkw)
    ds_j = jbase.get_dataset(name, root, **rkw)
    if name == "flyingchairs":
        _jax_native_loaded()  # JAX's Loader then decodes natively too
    got, want = _loader_pair(ds_t, ds_j, num_threads=2, **kw)
    try:
        for step in range(kw.get("start_step", 0),
                          kw.get("start_step", 0) + 5):
            np.testing.assert_array_equal(got.indices_for_step(step),
                                          want._indices_for_step(step))
            g, w = next(got), next(want)
            for k in KEYS:
                assert g[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        path = "native" if name == "flyingchairs" else "python"
        assert got.decoded[path] >= 5 and sum(got.decoded.values()) == \
            got.decoded[path]
    finally:
        got.close()
        want.close()
    assert not got._thread.is_alive()


def test_native_decoder_matches_jax_and_the_python_path(tmp_path):
    assert native.available(), native.BUILD_ERROR
    _jax_native_loaded()
    root = trees.write_chairs(str(tmp_path / "c"), 5, (30, 50), seed=9)
    ds = tbase.get_dataset("flyingchairs", root, split="all")
    paths = [[getattr(r, k) for r in ds.records] for k in ("im1", "im2",
                                                            "flow")]
    for hw in ((30, 50), (24, 64), (40, 36)):
        got = native.decode_batch(*paths, hw, num_threads=3)
        want = jnative.decode_batch(*paths, hw, num_threads=3)
        loader = tpipe.Loader(ds, 5, hw, num_threads=2)
        try:
            py = loader.python_batch(np.arange(5))
        finally:
            loader.close()
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_allclose(got[k], py[k], rtol=0, atol=1e-7,
                                       err_msg=k)
    assert native.BUILD_DIR.name == "pwcnet_tpu_torch"
    assert native._target().exists()


def test_loader_says_when_the_native_decoder_is_missing(tmp_path,
                                                        monkeypatch, caplog):
    name, root, _ = _build(tmp_path, "chairs")
    ds = tbase.get_dataset(name, root)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "BUILD_ERROR", "g++ not found")
    with caplog.at_level(logging.WARNING):
        loader = tpipe.Loader(ds, 2, (24, 40), num_threads=2)
        try:
            first, second = next(loader), next(loader)
        finally:
            loader.close()
    assert loader.decoded["native"] == 0 and loader.decoded["python"] >= 2
    msgs = [r.getMessage() for r in caplog.records
            if "native decoder" in r.getMessage()]
    assert len(msgs) == 1 and "g++ not found" in msgs[0]
    assert first["im1"].shape == (2, 24, 40, 3)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_loader_stops_when_its_producer_fails(tmp_path):
    name, root, _ = _build(tmp_path, "kitti")
    ds = tbase.get_dataset(name, root, split="all")
    (tmp_path / "kitti" / "training" / "image_2" / "000000_10.png"
     ).write_bytes(b"not a png")
    loader = tpipe.Loader(ds, len(ds), (24, 48), num_threads=2)
    try:
        with pytest.raises(RuntimeError, match="producer stopped"):
            next(loader)
    finally:
        loader.close()
