"""The GMFlow cell (``gmflow-stream-hd1080``) on the CPU at a tiny size,
through the port's plain paths: the cell resolves, a sound run is correct,
a sign flip and a stale answer planted where answers are produced are
caught, the fp8, stale and unshifted-window controls read far above the
sound run, K12's cost by hand and the forward's 26 calls, the roofline
reader and the peak's share on made-up traces."""

from __future__ import annotations

import ast
import time

import pytest
import torch

from flowbench import costs, costs_gmflow, harness
from flowbench.reference import gmflow
from flowbench.tests.conftest import cell as get_cell
from flowbench.tests.test_flowbench_drivers import sign_flip, stale

NAME = "gmflow-stream-hd1080"
K12 = ("void (anonymous namespace)::window_attention_bf16<128>(bf16 const*, "
       "bf16 const*, void const*, void*, Win, ...)")
K12_GLOBAL = ("void (anonymous namespace)::window_attention_bf16<2>(bf16 "
              "const*, bf16 const*, void const*, void*, Win, ...)")
SEED = 2 ** 33 + 1


def _tiny():
    """The cell at 60x90 frames (64x96 padded: a 1/8 grid of 8x12 in 2x2
    windows, a 1/4 grid of 16x24 in 8x8 windows)."""
    cell = get_cell(NAME)
    cell.traffic = dict(cell.traffic, frame_hw=[60, 90], ring_frames=5,
                        sample_answers=3)
    return cell


def _run(predict=None, trace=False):
    cell = _tiny()
    return harness.driver(cell).run(cell, 2 ** 31 + 13, 0.5, trace, "cpu",
                                    time.perf_counter(), predict=predict)


def test_cell_resolves():
    cell = get_cell(NAME)
    assert cell.chips == 1 and cell.traffic["driver"] == "stream_gmflow"
    assert cell.config["family"] == cell.config["port_model"]["family"] \
        == "gmflow"
    assert cell.traffic["frame_hw"] == [1080, 1920]
    assert costs.padded_hw(cell.config, (1080, 1920)) == (1088, 1920)
    assert {m["name"] for m in cell.end_to_end} == {
        "stream_pairs_per_s", "stream_p95_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"window_attention_roofline.stream", "mfu_gmflow.stream",
            "corr_roofline.stream", "copy_ms.stream", "device_busy_ms.stream", "idle_share.stream",
            "entry_sync_ms.stream", "entry_host_ms.stream"} == names


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


@pytest.mark.parametrize("variant", ["fp8", "stale", "no_shift"])
def test_control_reads_above_the_limit(variant):
    cell = _tiny()
    got = harness.driver(cell).control(cell, SEED, "cpu", variant)
    assert got["flow_err_vs_bf16"] > cell.limits["flow_err_vs_bf16"], got


def test_an_unknown_control_is_refused():
    cell = _tiny()
    with pytest.raises(ValueError, match="unknown control"):
        harness.driver(cell).control(cell, SEED, "cpu", "no_global")


def test_weights_follow_the_law():
    cell = _tiny()
    drv = harness.driver(cell)
    w = drv.seeded_weights(cell.config, 2 ** 33 + 7, "cpu")
    assert set(w) == set(gmflow.param_shapes(cell.config))
    ln = [v for k, v in w.items() if ".norm" in k and k.endswith(".weight")]
    assert len(ln) == 18 and all(
        bool(((v > 0.1) & (v < 0.5)).all()) for v in ln)
    again = drv.seeded_weights(cell.config, 2 ** 33 + 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    # 4.72 M parameters, as released.
    assert sum(v.numel() for v in w.values()) == 4716720


def test_a_forward_makes_26_k12_calls_of_7_2_ms_bound():
    cell = get_cell(NAME)
    calls = harness.driver(cell).kernel_calls(cell.config, 1, (1088, 1920))[
        "window_attention"]
    assert len(calls) == 26
    assert sum(1 for c in calls if c[3] > 1 and not c[4]) == 12
    assert sum(1 for c in calls if c[4]) == 12
    assert calls[-2:] == [(1, 136, 240, 1, False, 2)] * 2
    flops = sum(costs_gmflow.attention_cost(c)[1] for c in calls)
    bound = sum(costs.bound_ms(*costs_gmflow.attention_cost(c))
                for c in calls)
    assert 7.09e12 < flops < 7.11e12 and 7.17 < bound < 7.19


@pytest.mark.parametrize("call", [(2, 136, 240, 2, True, 128),
                                  (2, 272, 480, 8, False, 128),
                                  (1, 136, 240, 1, False, 2),
                                  (3, 6, 10, 2, True, 128)])
def test_attention_cost_by_hand(call):
    b, h, w, s, _, vw = call
    tokens = (h // s) * (w // s)
    got = costs_gmflow.attention_cost(call)
    vbytes = 2 if vw == 128 else 4
    assert got == (b * h * w * (2 * 128 * 2 + 2 * vw * vbytes),
                   2.0 * b * s * s * tokens * tokens * (128 + vw))
    if call[1:3] == (136, 240) and s == 2:
        # 8160-token windows: 0.273 TFLOP, compute-bound.
        assert 0.2726e12 < got[1] < 0.2728e12
        assert costs.bound_ms(*got) == pytest.approx(got[1] / 989e9)


def _view(kernels, items=2):
    cell = get_cell(NAME)
    cfg = cell.config
    hw = costs.padded_hw(cfg, (1080, 1920))
    return harness.TraceView(
        kind="stream", stretch=(0.0, 1e6), items=items, pairs_per_item=1,
        kernels=kernels, copies=[], spans=[],
        calls=harness.driver(cell).kernel_calls(cfg, 1, hw), config=cfg,
        hw=hw, window_items=40, window_s=5.0)


def _read(name, view):
    return harness.load_module(harness.BENCH / "metrics"
                               / f"{name}.py").read(view)


def _trace(windowed=48, global_=4):
    other = "sm90_xmma_fprop_implicit_gemm_bf16"
    kernels = [(K12, 1000 * i, 1000 * i + 500) for i in range(windowed)]
    kernels += [(other, 60000, 61000)]
    kernels += [(K12_GLOBAL, 70000 + 1000 * i, 70600 + 1000 * i)
                for i in range(global_)]
    return kernels


def test_roofline_from_a_made_up_trace():
    view = _view(_trace())
    bound = sum(costs.bound_ms(*costs_gmflow.attention_cost(c))
                for c in view.calls["window_attention"])
    # Two pairs: 48 windowed launches of 0.5 ms, 4 global ones of 0.6 ms.
    assert _read("window_attention_roofline.stream", view) == pytest.approx(
        100 * 2 * bound / (48 * 0.5 + 4 * 0.6))


@pytest.mark.parametrize("windowed,global_", [(47, 4), (48, 5), (48, 3)])
def test_a_wrong_k12_count_fails_the_reading(windowed, global_):
    with pytest.raises(RuntimeError, match="kernels matching"):
        _read("window_attention_roofline.stream", _view(_trace(windowed,
                                                               global_)))


def test_k1_reads_its_roofline_in_the_cell():
    """The local matching's one K1 call a pair, at 272x480 with 128
    channels, feeds ``corr_roofline.stream``."""
    k1 = "void (anonymous namespace)::corr_band<4, 2, 1>(bf16 const*)"
    view = _view(_trace() + [(k1, 80000, 80120), (k1, 81000, 81120)])
    assert view.calls["corr"] == [(1, 272, 480, 128)]
    bound = costs.bound_ms(*costs.corr_cost((1, 272, 480, 128)))
    assert _read("corr_roofline.stream", view) == pytest.approx(
        100 * 2 * bound / (2 * 0.12))
    with pytest.raises(RuntimeError, match="kernels matching"):
        _read("corr_roofline.stream", _view(_trace() + [(k1, 0, 120)]))


def test_roofline_is_silent_without_k12():
    view = _view(_trace())
    view.calls = {}
    assert _read("window_attention_roofline.stream", view) is None


def test_mfu_from_a_made_up_window():
    view = _view([])
    flops = costs_gmflow.model_flops(view.config, 1, view.hw)
    # 10.1 TFLOP a pair at 1088x1920, the attention's 7.1 of them.
    attn = sum(costs_gmflow.attention_cost(c)[1]
               for c in view.calls["window_attention"])
    assert 10.0e12 < flops < 10.3e12 and 0.68 < attn / flops < 0.72
    assert _read("mfu_gmflow.stream", view) == pytest.approx(
        100 * flops * 40 / (5.0 * costs.BF16_FLOPS))


def test_the_driver_runs_its_own_code():
    """``drivers/stream_gmflow.py`` has its own ``run`` and ``control`` and
    loads no private copy of another driver to swap its globals; the
    reference imports nothing of the port."""
    src = (harness.BENCH / "drivers" / "stream_gmflow.py").read_text()
    tree = ast.parse(src)
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"run", "control", "seeded_weights", "kernel_calls",
            "reference_flow"} <= defs
    assert "load_module" not in src
    ref = (harness.BENCH / "reference" / "gmflow.py").read_text()
    assert "pwcnet_tpu" not in ref and "jax" not in ref
