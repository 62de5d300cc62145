"""Both drivers end to end on the CPU at a tiny size, through the port's
plain paths: a sound run comes out correct, and each fault the cell can
have, planted in the timed path, makes ``correct`` false. (The check for
a card is the run script's, which these tests skip; there is no exchange
between chips in any cell.)"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from flowbench import harness
from flowbench.tests.conftest import cell as get_cell, tiny


def _run(name, plant=None, seed=2 ** 31 + 11, trace=False):
    cell = tiny(get_cell(name))
    drv = harness.driver(cell)
    kw = {}
    if plant is not None:
        kw["predict" if cell.traffic["driver"] == "stream" else "plant"] = \
            plant
    return drv.run(cell, seed, 0.5, trace, "cpu", time.perf_counter(), **kw)


def _predict():
    from pwcnet_tpu_torch.train.evaluate import predict_flow
    return predict_flow


def sign_flip(model, im1, im2):
    """An answer altered where it is produced: v's sign."""
    flow = _predict()(model, im1, im2)
    flow[..., 1] *= -1
    return flow


def stale():
    """Each answer replaced by the one before it, where that was another
    pair's (else by the reversed pair's)."""
    last = []

    def predict(model, im1, im2):
        flow = _predict()(model, im1, im2)
        if last and last[0] is not im1:
            out = last[1]
        else:
            out = _predict()(model, im2, im1)
        last[:] = [im1, flow]
        return out
    return predict


def unchanged(step_fn):
    """A step that returns its state unchanged."""
    def step(state, batch):
        before = [p.detach().clone() for p in state.model.parameters()]
        state, m = step_fn(state, batch)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return state, m
    return step


def half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(state, batch):
        return step_fn(state, {k: v[:v.shape[0] // 2]
                               for k, v in batch.items()})
    return step


def altered_gt(step_fn):
    """An answer altered where it is produced: the batch's flow."""
    def step(state, batch):
        return step_fn(state, dict(batch, flow=-batch["flow"]))
    return step


STREAM = ["pwc-stream-sintel", "raft-stream-sintel"]
TRAIN = ["pwc-train-devgen"]


@pytest.mark.parametrize("name", STREAM + TRAIN)
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.end_to_end) >= {"setup_s"}
    assert all(v > 0 for v in out.end_to_end.values())


@pytest.mark.parametrize("name", STREAM)
@pytest.mark.parametrize("fault", ["sign_flip", "stale"])
def test_stream_fault_is_caught(name, fault):
    plant = sign_flip if fault == "sign_flip" else stale()
    out = _run(name, plant)
    assert not out.correct, out.checks


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_gt],
                         ids=lambda f: f.__name__)
def test_train_fault_is_caught(name, fault):
    out = _run(name, fault)
    assert not out.correct, out.checks


def test_trace_view_on_the_cpu():
    out = _run("pwc-stream-sintel", trace=True)
    view = out.view
    assert view.items >= 3 and view.window_items == out.attempted >= 1
    assert view.stretch[1] > view.stretch[0]
    # The stretch follows the window, and the profiler's lead-in item is
    # not in it: one span per traced pair, each inside the stretch.
    assert [n for n, _, _ in view.spans] == ["flowbench.entry"] * view.items
    assert all(view.stretch[0] <= s < e <= view.stretch[1]
               for _, s, e in view.spans)
    assert view.kernels == []      # no device here: nothing to read
    read = {m: harness.load_module(harness.BENCH / "metrics" / f"{m}.py").read
            for m in ("copy_ms.stream", "device_busy_ms.stream",
                      "idle_share.stream", "mfu.stream",
                      "corr_roofline.stream")}
    assert [read[m](view) for m in list(read)[:3]] == [None] * 3
    assert read["mfu.stream"](view) > 0
    with pytest.raises(RuntimeError, match="kernels matching"):
        read["corr_roofline.stream"](view)


def test_seeded_inputs_repeat():
    from flowbench import frames
    cell = tiny(get_cell("pwc-stream-sintel"))
    a = frames.make(cell.traffic, 2 ** 33 + 1, "cpu")
    b = frames.make(cell.traffic, 2 ** 33 + 1, "cpu")
    c = frames.make(cell.traffic, 2 ** 33 + 2, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    assert not np.array_equal(a[1], a[2])
    w1 = harness.seeded_weights(cell.config, 5, "cpu")
    w2 = harness.seeded_weights(cell.config, 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
