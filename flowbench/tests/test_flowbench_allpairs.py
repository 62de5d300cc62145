"""The published-RAFT cell (``raft-allpairs-stream-sintel``) on the CPU at a
tiny size, through the port's plain paths: a sound run is correct, a sign
flip and a stale answer planted where answers are produced are caught, the
controls fail the limit, K8's and K9's costs by hand, and the two roofline
readers and the peak's share on made-up traces."""

from __future__ import annotations

import time

import pytest
import torch

from flowbench import costs, costs_allpairs, harness
from flowbench.reference import raft_allpairs
from flowbench.tests.conftest import cell as get_cell
from flowbench.tests.test_flowbench_drivers import sign_flip, stale

NAME = "raft-allpairs-stream-sintel"
K8 = "void (anonymous namespace)::corr_pyramid_bf16(bf16 const*, Out)"
K9 = "void (anonymous namespace)::corr_lookup_kernel<__nv_bfloat16>(Levels)"


def _tiny():
    """The cell at 60x120 frames (64x120 padded: a 1/8 grid of 8x15, levels
    down to 1x1) with 3 iterations."""
    cell = get_cell(NAME)
    cell.traffic = dict(cell.traffic, frame_hw=[60, 120], ring_frames=5,
                        sample_answers=3)
    cell.config = dict(cell.config, iters=3, port_model=dict(
        cell.config["port_model"], raft_iters=3))
    return cell


def _run(predict=None, trace=False):
    cell = _tiny()
    return harness.driver(cell).run(cell, 2 ** 31 + 11, 0.5, trace, "cpu",
                                    time.perf_counter(), predict=predict)


def test_sound_run_is_correct():
    out = _run()
    assert out.correct, out.checks
    assert out.attempted >= 1 and out.failed == 0
    assert set(out.end_to_end) == {"stream_pairs_per_s", "stream_p95_ms",
                                   "setup_s"}
    assert [n for n, _, _ in out.checks] == ["flow_err_vs_bf16"]


@pytest.mark.parametrize("fault", ["sign_flip", "stale"])
def test_planted_fault_is_caught(fault):
    out = _run(sign_flip if fault == "sign_flip" else stale())
    assert not out.correct, out.checks


@pytest.mark.parametrize("variant", ["fp8", "stale"])
def test_control_fails_the_limit(variant):
    cell = _tiny()
    got = harness.driver(cell).control(cell, 2 ** 31 + 3, "cpu", variant)
    assert got["flow_err_vs_bf16"] > cell.limits["flow_err_vs_bf16"], got


def test_weights_keep_the_running_variances_positive():
    cell = _tiny()
    drv = harness.driver(cell)
    w = drv.seeded_weights(cell.config, 2 ** 33 + 5, "cpu")
    assert set(w) == set(raft_allpairs.param_shapes(cell.config))
    var = [v for k, v in w.items() if k.endswith(".running_var")]
    assert var and all(bool((v >= 1).all()) for v in var)
    again = drv.seeded_weights(cell.config, 2 ** 33 + 5, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@pytest.mark.parametrize("shape", [(1, 55, 128, 256, 4), (2, 7, 9, 16, 2)])
def test_pyramid_cost_by_hand(shape):
    n, h, w, c, levels = shape
    p = h * w
    sizes = [(h >> lv) * (w >> lv) for lv in range(levels)]
    assert costs_allpairs.pyramid_cost(shape) == (
        (2 * n * p * c + n * p * sum(sizes)) * 2, 2 * n * p * p * c)
    if shape[1:3] == (55, 128):
        assert sizes == [7040, 27 * 64, 13 * 32, 6 * 16]


@pytest.mark.parametrize("shape", [(1, 55, 128, 4, 4), (1, 7, 9, 2, 3)])
def test_lookup_cost_by_hand(shape):
    n, h, w, levels, r = shape
    px = n * h * w
    patch = sum(min(2 * r + 2, h >> lv) * min(2 * r + 2, w >> lv)
                for lv in range(levels))
    outs = px * levels * (2 * r + 1) ** 2
    assert costs_allpairs.lookup_cost(shape) == (
        px * 8 + (px * patch + outs) * 2, 8 * outs)
    if shape == (1, 55, 128, 4, 4):  # levels 55x128, 27x64, 13x32, 6x16
        assert patch == 100 + 100 + 100 + 60 and outs == 7040 * 324


def _view(kernels, items=2):
    cfg = get_cell(NAME).config
    hw = costs.padded_hw(cfg, (436, 1024))
    drv = harness.driver(get_cell(NAME))
    return harness.TraceView(
        kind="stream", stretch=(0.0, 1e5), items=items, pairs_per_item=1,
        kernels=kernels, copies=[], spans=[],
        calls=drv.kernel_calls(cfg, 1, hw), config=cfg, hw=hw,
        window_items=40, window_s=2.0)


def _read(name, view):
    return harness.load_module(harness.BENCH / "metrics"
                               / f"{name}.py").read(view)


def test_rooflines_from_a_made_up_trace():
    other = "sm90_xmma_fprop_implicit_gemm_bf16"
    kernels = [(K8, 0, 100), (other, 100, 200), (K8, 500, 600)]
    kernels += [(K9, 1000 + 20 * i, 1010 + 20 * i) for i in range(64)]
    view = _view(kernels)
    assert view.calls["pyramid"] == [(1, 55, 128, 256, 4)]
    assert view.calls["lookup"] == [(1, 55, 128, 4, 4)] * 32
    k8 = costs.bound_ms(*costs_allpairs.pyramid_cost((1, 55, 128, 256, 4)))
    k9 = costs.bound_ms(*costs_allpairs.lookup_cost((1, 55, 128, 4, 4)))
    assert _read("pyramid_roofline.stream", view) == pytest.approx(
        100 * 2 * k8 / 0.2)
    assert _read("lookup_roofline.stream", view) == pytest.approx(
        100 * 64 * k9 / 0.64)


@pytest.mark.parametrize("name,k8,k9", [("pyramid_roofline.stream", 1, 64),
                                        ("pyramid_roofline.stream", 3, 64),
                                        ("lookup_roofline.stream", 2, 63),
                                        ("lookup_roofline.stream", 2, 65)])
def test_a_wrong_kernel_count_fails_the_reading(name, k8, k9):
    kernels = [(K8, 200 * i, 200 * i + 100) for i in range(k8)]
    kernels += [(K9, 1000 + 20 * i, 1010 + 20 * i) for i in range(k9)]
    with pytest.raises(RuntimeError, match="kernels matching"):
        _read(name, _view(kernels))


def test_mfu_from_a_made_up_window():
    view = _view([])
    flops = costs_allpairs.model_flops(view.config, 1, view.hw)
    # 32 iterations at 440x1024: about 1.4 TFLOP a pair.
    assert 1.2e12 < flops < 1.6e12
    assert _read("mfu_allpairs.stream", view) == pytest.approx(
        100 * flops * 40 / (2.0 * costs.BF16_FLOPS))
