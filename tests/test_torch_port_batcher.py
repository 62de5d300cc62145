"""The device batcher's one upload a batch (``data/synthetic.py``): its
batch equals, bit for bit, the per-sample path (each sample's draws
uploaded on their own, rendered, stacked), on the CPU in both regimes and
for a mesh rank's rows; on a card the upload does not wait for the work
queued before it, and the counters see one pinned upload a batch."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from pwcnet_tpu_torch.data import synthetic as tsyn

import torch_port_util  # noqa: F401  (this process's share of the cores)

HW = (24, 40)
SEED = 2 ** 31 + 7


def per_sample(hw, seed, regime, step, rows, device):
    """The batch of ``rows`` drawn, uploaded and rendered one sample at a
    time."""
    samples = []
    for i in rows:
        rng = np.random.default_rng((seed, 2, step, i))
        p = tsyn._scale_pos(tsyn._host_params(rng, regime), hw)
        samples.append(tsyn._render(hw, tsyn.to_device(p, device)))
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


def data_rank(rank, size):
    return types.SimpleNamespace(
        data_mesh=types.SimpleNamespace(rank=rank, size=size))


@pytest.mark.parametrize("regime, rank, size, rows", [
    ("smooth", None, 1, range(6)),
    ("hard", None, 1, range(6)),
    ("smooth", 1, 2, range(3, 6)),
    ("hard", 2, 3, range(4, 6)),
])
def test_batch_equals_the_per_sample_path(regime, rank, size, rows):
    mesh = None if rank is None else data_rank(rank, size)
    got = tsyn.make_device_batcher(6, HW, seed=SEED, regime=regime,
                                   device="cpu", mesh=mesh)(3)
    want = per_sample(HW, SEED, regime, 3, rows, "cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_upload_does_not_wait_and_is_pinned():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    hw = (96, 128)
    batchers = {r: tsyn.make_device_batcher(2, hw, seed=SEED, regime=r,
                                            device=dev)
                for r in ("smooth", "hard")}
    for b in batchers.values():
        b(0)  # loads the kernels and takes the pinned blocks
    torch.cuda.synchronize()
    before = dict(tsyn.COUNTS)
    # Some 0.5 s of the card's clock, far longer than the call's host work.
    # Two smooth samples launch too few kernels to fill the launch queue,
    # which would hold the host behind the sleep whatever the batcher does.
    torch.cuda._sleep(1_000_000_000)
    got = {"smooth": batchers["smooth"](1)}
    assert not torch.cuda.current_stream().query()
    got["hard"] = batchers["hard"](1)
    torch.cuda.synchronize()
    assert tsyn.COUNTS["batches"] == before["batches"] + 2
    assert tsyn.COUNTS["pinned_uploads"] == before["pinned_uploads"] + 2
    for regime, batch in got.items():
        want = per_sample(hw, SEED, regime, 1, range(2), dev)
        for k in want:
            assert torch.equal(batch[k], want[k]), (regime, k)
