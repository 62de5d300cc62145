"""What the port's tests (``tests/test_torch_*.py``) share: each pytest
worker's share of the cores, and the helpers that every file used to copy.

The thread share. Under ``pytest -n 6`` each worker ran torch's CPU ops on
as many OpenMP threads as the machine has cores, beside JAX's own pool, so
six workers put about 48 torch threads on 8 cores. The threads fought over
the cores: on an 8-core machine, six of the port's files (train, capture,
augment, cli, weights, norm) took 292 s of wall time and 1262 test-seconds
with torch's default, and 106 s and 280 test-seconds with one thread a
worker, with the same 182 passes. Alone, ``test_capture_on_the_cpu_raises``
takes 0.14-0.55 s a case; inside the six-worker run it took 10-11.5 s. All
the port's files took 6018 test-seconds of a 1359 s run of the whole suite
with the default, and 1063 test-seconds with the share.
So on import this module sets torch's intra-op threads to the process's
share of the cores it may run on: ``cores // workers``, at least 1, where
``workers`` is xdist's ``PYTEST_XDIST_WORKER_COUNT`` (1 outside xdist, so
a run in one process keeps every core). It also sets ``OMP_NUM_THREADS``
to that share where it is unset, so that the processes the tests start
(the CLI's, the launcher's ranks) inherit it. xdist workers import every
test module at collection, before the first test runs.

Nothing here imports JAX when the module is imported: the files that
import no JAX run on a card with ``--noconftest``.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch


_SHARE = max(1, len(os.sched_getaffinity(0))
             // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(_SHARE)
os.environ.setdefault("OMP_NUM_THREADS", str(_SHARE))


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` while the block runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_thread():
    """One torch thread for the rest of the module: multi-threaded CPU
    kernels of torch add in a varying order, and one thread makes two runs
    of the same ops bitwise equal (under xdist the share is often 1
    already; in one process it is every core)."""
    with torch_threads(1):
        yield


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# -- arrays ------------------------------------------------------------------

def _f64(a):
    if torch.is_tensor(a):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, np.float64)


def rel_err(got, want, floor=0.0):
    """``max|got - want| / max(max|want|, floor)`` in float64; numpy
    arrays, JAX arrays or tensors of any dtype and device."""
    got, want = _f64(got), _f64(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor)


def to_torch(a):
    """A CPU tensor holding a C-contiguous, writable copy of ``a`` (a numpy
    or JAX array), or a dict of such tensors for a dict of arrays."""
    if isinstance(a, dict):
        return {k: to_torch(v) for k, v in a.items()}
    return torch.from_numpy(np.array(a, order="C"))


def nchw(a):
    """An NHWC array as an NCHW tensor (a view: channels-last strides)."""
    return to_torch(a).permute(0, 3, 1, 2)


def ext_rows(x, row0, t, top, bottom):
    """Global rows [row0 - top, row0 + t + bottom) of x (N, H, ...), zeros
    outside: what exchange_rows gives a shard (its test pins that)."""
    pad = [(0, 0), (top, bottom)] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, pad)[:, row0:row0 + t + top + bottom]


def random_batch(rng, n, hw, valid_above):
    """A random train batch of ``n`` pairs at ``hw`` (numpy, NHWC): frames
    in [0, 1), flows N(0, 9), a pixel valid where its draw exceeds
    ``valid_above``."""
    return {"im1": rng.random((n, *hw, 3), np.float32),
            "im2": rng.random((n, *hw, 3), np.float32),
            "flow": (rng.standard_normal((n, *hw, 2)) * 3).astype(np.float32),
            "valid": (rng.random((n, *hw)) > valid_above).astype(np.float32)}


def rendered_batch(hw, seeds):
    """The JAX package's "hard" synthetic scene of each seed at ``hw``,
    rendered on the host with numpy, stacked into one f32 batch."""
    import pwcnet_tpu.data.synthetic as jsyn
    samples = [jsyn._render(np, hw, jsyn._scale_pos(
        jsyn._host_params(np.random.default_rng(s), "hard"), hw, np))
        for s in seeds]
    return {k: np.stack([s[k] for s in samples]).astype(np.float32)
            for k in samples[0]}


def shifted_pair(seed, hw, gain=1.0, torch_batch=False):
    """A random f32 frame in [0, 1) drawn from ``seed`` and its copy moved
    2 rows down and 3 columns right (wrapping), times ``gain``: (H, W, 3)
    arrays from numpy's generator, or with ``torch_batch`` (1, H, W, 3)
    tensors from torch's."""
    if torch_batch:
        im1 = torch.rand((1, *hw, 3),
                         generator=torch.Generator().manual_seed(seed))
        return im1, torch.roll(im1, (2, 3), (1, 2)) * gain
    im1 = np.random.default_rng(seed).random((*hw, 3), np.float32)
    return im1, np.roll(im1, (2, 3), (0, 1)) * np.float32(gain)


# -- models and weights ------------------------------------------------------

def make_model(family, seed=0, state_dict=None, **kw):
    """A port model of ``family`` (``"pwcnet"``, ``"raft"``,
    ``"raft_allpairs"``, ``"gma"`` or ``"gmflow"``) on the CPU unless
    ``kw`` names a device, its init drawn from a generator seeded with
    ``seed``, with ``state_dict`` loaded when given; ``kw`` goes to the
    constructor."""
    from pwcnet_tpu_torch import PWCNet
    from pwcnet_tpu_torch.models.gma import GMA
    from pwcnet_tpu_torch.models.gmflow import GMFlow
    from pwcnet_tpu_torch.models.raft import RAFT
    from pwcnet_tpu_torch.models.raft_allpairs import RAFTAllPairs
    cls = {"pwcnet": PWCNet, "raft": RAFT, "raft_allpairs": RAFTAllPairs,
           "gma": GMA, "gmflow": GMFlow}[family]
    m = cls(**{"device": "cpu", **kw},
            generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        m.load_state_dict(state_dict)
    return m


def tiny_cfg(log_dir, use_norm=False, **train_kw):
    """The synthetic-proof preset in f32 on 64x64 crops, one pair a step,
    a summary every step, logs under ``log_dir``."""
    from pwcnet_tpu_torch.config import PRESETS
    cfg = PRESETS["synthetic-proof"]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32",
                                       use_norm=use_norm),
        data=dataclasses.replace(cfg.data, augment=dataclasses.replace(
            cfg.data.augment, crop_hw=(64, 64))),
        train=dataclasses.replace(cfg.train, global_batch=1,
                                  log_dir=str(log_dir), summary_interval=1,
                                  **train_kw))


STEM_CHANNELS = ((3, 16), (16, 16), (16, 32), (32, 32))


def stem_params(rng, scale=0.2):
    """The stem's four (HWIO weight, bias) pairs as numpy f32: weights
    N(0, scale**2), biases N(0, 0.01)."""
    return [(rng.standard_normal((3, 3, ci, co)).astype(np.float32) * scale,
             rng.standard_normal(co).astype(np.float32) * 0.1)
            for ci, co in STEM_CHANNELS]


def torch_stem_params(params):
    """``stem_params`` as the port takes them: (OIHW weight, bias)."""
    return [(to_torch(w.transpose(3, 2, 0, 1)), to_torch(b))
            for w, b in params]


def nested_set(tree, path, value):
    *heads, last = path.split("/")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def jax_npz_params(path):
    """A bf16 ``.npz`` checkpoint (``uint16`` views, keys
    ``params/...``) as the JAX model's f32 params: each value's bits
    shifted into the high half of an f32, which is exact."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            nested_set(tree, key.split("/", 1)[1], (
                z[key].view(np.uint16).astype(np.uint32) << 16).view(
                    np.float32))
    return {"params": tree}


def jax_tree_to_port(flat):
    """A flat flax tree (``_flatten``) under the port's names, kernels
    HWIO -> OIHW."""
    from pwcnet_tpu_torch.compat.flax_weights import torch_key
    return {torch_key(k): (v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
            for k, v in flat.items()}


def jax_sharded(mesh, x):
    """``x`` (N, H, ...) on the JAX mesh, its rows split over the spatial
    axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pwcnet_tpu.parallel import SPATIAL_AXIS
    return jax.device_put(x, NamedSharding(mesh, P(None, SPATIAL_AXIS)))


def params_agree(got, want, share, bound):
    """At least ``share`` of the entries within rtol=2e-4, atol=2e-6, and
    every entry within ``bound``; returns the share."""
    inside = total = 0
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, k
        diff = np.abs(g - w)
        inside += int((diff <= 2e-6 + 2e-4 * np.abs(w)).sum())
        total += w.size
        assert diff.max() <= bound, (k, diff.max())
    assert inside >= share * total, (inside, total)
    return inside / total
