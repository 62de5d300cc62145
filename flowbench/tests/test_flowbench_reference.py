"""The reference against the port's plain float32 path on the CPU (same
weights, same inputs, the port built as its trainer builds it), and its
re-derived batches against the port's own."""

from __future__ import annotations

import pytest
import torch

from flowbench import harness
from flowbench.reference import pwcnet, raft, synthetic
from flowbench.reference.ops import Precision, pad_to


def _f32(cfg):
    return dict(cfg, port_model=dict(cfg["port_model"], dtype="float32"))


@pytest.mark.parametrize("name,mod", [("pwcnet-paper", pwcnet),
                                      ("raft-small-local", raft)])
def test_forward_matches_the_ports_float32_path(name, mod):
    cfg = harness.resolve(
        "pwc-stream-sintel" if mod is pwcnet else "raft-stream-sintel").config
    if mod is raft:
        cfg = dict(cfg, iters=3, port_model=dict(cfg["port_model"],
                                                 raft_iters=3))
    w = harness.seeded_weights(cfg, 3, "cpu")
    model = harness.port_model(_f32(cfg), w, "cpu")
    g = torch.Generator().manual_seed(0)
    im1 = torch.rand((1, 64, 128, 3), generator=g)
    im2 = torch.roll(im1, (2, 3), (1, 2))
    with torch.no_grad():
        got = model.full_res_flow(model(im1, im2, train=False), (64, 128))
        ref = mod.full_res(cfg, mod.forward(w, cfg, im1, im2), (64, 128))
    assert harness.rel_l2(got, ref) < 1e-5


def test_fp8_is_coarser_than_float32():
    x = torch.linspace(-3, 3, 1001)
    y = Precision("fp8").q(x)
    assert 0 < (x - y).abs().max() <= 3 * 2 ** -4
    assert torch.equal(Precision("float32").q(x), x)


def test_synthetic_batch_is_the_device_batchers():
    from pwcnet_tpu_torch.data.synthetic import make_device_batcher
    port = make_device_batcher(3, (40, 56), seed=2 ** 31 + 7,
                               device="cpu")(5)
    ref = synthetic.batch(2 ** 31 + 7, 5, 3, (40, 56), "cpu")
    for k in port:
        assert torch.equal(port[k], ref[k]), k


def test_padding_is_bottom_right():
    x = torch.ones((1, 436, 1000, 3))
    y = pad_to(x, 64)
    assert y.shape == (1, 448, 1024, 3)
    assert y[0, :436, :1000].min() == 1 and y[0, 436:].max() == 0
