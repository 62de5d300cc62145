"""The GMA cell (``gma-stream-hd1080``) on the CPU at a tiny size, through
the port's plain paths: the cell resolves, a sound run is correct, a sign
flip and a stale answer planted where answers are produced are caught, the
fp8, stale and no-aggregation controls fail the limit, K11's cost by hand,
the three roofline readers and the peak's share on made-up traces."""

from __future__ import annotations

import time

import pytest
import torch

from flowbench import costs, costs_allpairs, costs_gma, harness
from flowbench.reference import gma
from flowbench.tests.conftest import cell as get_cell
from flowbench.tests.test_flowbench_drivers import sign_flip, stale

NAME = "gma-stream-hd1080"
K8 = "void (anonymous namespace)::corr_pyramid_bf16(bf16 const*, Out)"
K9 = "void (anonymous namespace)::corr_lookup_kernel<__nv_bfloat16>(Levels)"
MAP = ("void (anonymous namespace)::global_attention_map_bf16(bf16 const*, "
       "bf16 const*, bf16*, int, long long, long long, long long, long "
       "long, long long, long long, float)")
AGG = ("void (anonymous namespace)::global_attention_aggregate_bf16(bf16 "
       "const*, bf16 const*, bf16 const*, float const*, bf16*, int, ...)")


def _tiny():
    """The cell at 60x120 frames (64x120 padded: a 1/8 grid of 8x15, P =
    120, levels down to 1x3) with 3 iterations."""
    cell = get_cell(NAME)
    cell.traffic = dict(cell.traffic, frame_hw=[60, 120], ring_frames=5,
                        sample_answers=3)
    cell.config = dict(cell.config, iters=3, port_model=dict(
        cell.config["port_model"], raft_iters=3))
    return cell


def _run(predict=None, trace=False):
    cell = _tiny()
    return harness.driver(cell).run(cell, 2 ** 31 + 13, 0.5, trace, "cpu",
                                    time.perf_counter(), predict=predict)


def test_cell_resolves():
    cell = get_cell(NAME)
    assert cell.chips == 1 and cell.traffic["driver"] == "stream_gma"
    assert cell.config["family"] == cell.config["port_model"]["family"] \
        == "gma"
    assert cell.traffic["frame_hw"] == [1080, 1920]
    # 1080 = 8 x 135: no padding, a 135x240 grid.
    assert costs.padded_hw(cell.config, (1080, 1920)) == (1080, 1920)
    assert {m["name"] for m in cell.end_to_end} == {
        "stream_pairs_per_s", "stream_p95_ms", "setup_s"}
    assert {"attention_roofline.stream", "mfu_gma.stream",
            "pyramid_roofline.stream", "lookup_roofline.stream"} <= {
        m["name"] for m in cell.per_layer}


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


@pytest.mark.parametrize("variant", ["fp8", "stale", "no_global"])
def test_control_fails_the_limit(variant):
    cell = _tiny()
    got = harness.driver(cell).control(cell, 2 ** 31 + 5, "cpu", variant)
    assert got["flow_err_vs_bf16"] > cell.limits["flow_err_vs_bf16"], got


def test_weights_keep_gamma_and_the_running_variances_off_zero():
    cell = _tiny()
    drv = harness.driver(cell)
    w = drv.seeded_weights(cell.config, 2 ** 33 + 7, "cpu")
    assert set(w) == set(gma.param_shapes(cell.config))
    assert 1.0 <= float(w["aggregator.gamma"]) < 1.1
    var = [v for k, v in w.items() if k.endswith(".running_var")]
    assert var and all(bool((v >= 1).all()) for v in var)
    again = drv.seeded_weights(cell.config, 2 ** 33 + 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


@pytest.mark.parametrize("shape", [(1, 135, 240, 128, 32),
                                   (2, 7, 9, 16, 3)])
def test_attention_cost_by_hand(shape):
    n, h, w, d, iters = shape
    p = h * w
    got = costs_gma.attention_cost(shape)
    assert got == ((2 * p * d + 2 * iters * p * d) * n * 2,
                   2 * n * p * p * d * (1 + iters))
    if shape[1:3] == (135, 240):
        # 8.87 TFLOP a pair: compute-bound, 8.97 ms at the bf16 peak.
        assert p == 32400 and 8.86e12 < got[1] < 8.88e12
        assert costs.bound_ms(*got) == pytest.approx(got[1] / 989e9)
        assert 8.96 < costs.bound_ms(*got) < 8.98


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


def _trace(k8=2, k9=64, maps=2, aggs=64):
    other = "sm90_xmma_fprop_implicit_gemm_bf16"
    kernels = [(K8, 1000 * i, 1000 * i + 500) for i in range(k8)]
    kernels += [(other, 5000, 6000)]
    kernels += [(K9, 10000 + 20 * i, 10010 + 20 * i) for i in range(k9)]
    kernels += [(MAP, 20000 + 3000 * i, 22000 + 3000 * i)
                for i in range(maps)]
    kernels += [(AGG, 30000 + 1000 * i, 30700 + 1000 * i)
                for i in range(aggs)]
    return kernels


def test_rooflines_from_a_made_up_trace():
    view = _view(_trace())
    assert view.calls["pyramid"] == [(1, 135, 240, 256, 4)]
    assert view.calls["lookup"] == [(1, 135, 240, 4, 4)] * 32
    assert view.calls["attention"] == [(1, 135, 240, 128, 32)]
    k8 = costs.bound_ms(*costs_allpairs.pyramid_cost((1, 135, 240, 256, 4)))
    k9 = costs.bound_ms(*costs_allpairs.lookup_cost((1, 135, 240, 4, 4)))
    k11 = costs.bound_ms(*costs_gma.attention_cost((1, 135, 240, 128, 32)))
    assert _read("pyramid_roofline.stream", view) == pytest.approx(
        100 * 2 * k8 / 1.0)
    assert _read("lookup_roofline.stream", view) == pytest.approx(
        100 * 64 * k9 / 0.64)
    # Two pairs: 2 maps of 2 ms and 64 aggregations of 0.7 ms.
    assert _read("attention_roofline.stream", view) == pytest.approx(
        100 * 2 * k11 / (2 * 2.0 + 64 * 0.7))


@pytest.mark.parametrize("maps,aggs", [(1, 64), (3, 64), (2, 63), (2, 65)])
def test_a_wrong_k11_count_fails_the_reading(maps, aggs):
    with pytest.raises(RuntimeError, match="kernels matching"):
        _read("attention_roofline.stream", _view(_trace(maps=maps,
                                                        aggs=aggs)))


def test_attention_roofline_is_silent_without_k11():
    view = _view(_trace())
    view.calls = {k: v for k, v in view.calls.items() if k != "attention"}
    assert _read("attention_roofline.stream", view) is None


def test_mfu_from_a_made_up_window():
    view = _view([])
    flops = costs_gma.model_flops(view.config, 1, view.hw)
    # 32 iterations at 1080x1920: RAFT's convs and volume (about 7 TFLOP),
    # the wider GRU and the attention's 8.87 TFLOP.
    attn = costs_gma.attention_cost((1, 135, 240, 128, 32))[1]
    assert 15e12 < flops < 19e12 and 0.45 < attn / flops < 0.6
    assert _read("mfu_gma.stream", view) == pytest.approx(
        100 * flops * 40 / (5.0 * costs.BF16_FLOPS))


def test_stream_allpairs_reads_only_what_the_gma_reference_has():
    """``drivers/stream_gma.py`` runs a private copy of
    ``stream_allpairs`` whose ``raft_allpairs``, ``seeded_weights`` and
    ``kernel_calls`` it replaces: every ``raft_allpairs.<name>`` that
    module reads must exist in ``reference/gma.py``, and the names it
    replaces must still be that module's globals, or the GMA cell would
    silently run or compare published RAFT's code."""
    import ast

    from flowbench.drivers import stream_allpairs
    tree = ast.parse((harness.BENCH / "drivers"
                      / "stream_allpairs.py").read_text())
    read = {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "raft_allpairs"}
    assert read and {n for n in read if not hasattr(gma, n)} == set()
    for name in ("raft_allpairs", "seeded_weights", "kernel_calls", "run",
                 "control"):
        assert hasattr(stream_allpairs, name)


def test_model_flops_of_two_forwards_equal_the_whole_count():
    """The count from the forwards of 1 and 2 iterations equals the
    reference's whole forward counted at once."""
    cfg = dict(get_cell(NAME).config, iters=5)
    assert costs_gma.model_flops(cfg, 1, (64, 128)) == \
        costs_gma._counted(cfg, 1, (64, 128))
