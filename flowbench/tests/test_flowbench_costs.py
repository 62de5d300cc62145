"""The yardstick's arithmetic by hand at two shapes each, the kernel
shapes of each cell, the trace's interval arithmetic and a roofline read
from a made-up trace."""

from __future__ import annotations

import pytest

from flowbench import costs, harness

PWC = {"family": "pwcnet", "num_levels": 6, "output_level": 4,
       "pyramid_channels": [16, 32, 64, 96, 128, 196], "pad_divisor": 64}
RAFT = {"family": "raft", "feature_dim": 128, "iters": 12,
        "pad_divisor": 16}


@pytest.mark.parametrize("shape", [(1, 7, 16, 196), (8, 96, 112, 32)])
def test_corr_costs_by_hand(shape):
    n, h, w, c = shape
    px = n * h * w
    assert costs.corr_cost(shape) == ((2 * px * c + 81 * px) * 2,
                                      2 * 81 * c * px)
    assert costs.corr_bwd_cost(shape) == ((81 * px + 2 * px * c) * 2,
                                          2 * 81 * c * px)


@pytest.mark.parametrize("shape", [(2, 448, 1024, 3), (16, 384, 448, 3)])
def test_stem_costs_by_hand(shape):
    n, h, w, _ = shape
    a, b = (h // 2) * (w // 2), (h // 4) * (w // 4)
    macs = n * (a * 16 * 3 * 9 + a * 16 * 16 * 9 + b * 32 * 16 * 9
                + b * 32 * 32 * 9)
    weights = (16 * 27 + 16 * 144 + 32 * 144 + 32 * 288 + 96) * 4
    assert costs.stem_cost(shape) == ((n * h * w * 3 + n * b * 32) * 2
                                      + weights, 2 * macs)
    fb, ff = costs.stem_cost(shape)
    assert costs.stem_bwd_cost(shape) == (
        fb, 3 * ff - 2 * n * a * 16 * 27)
    assert costs.stem_bwd_cost(shape, True) == (
        fb + n * h * w * 3 * 2, 3 * ff)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert costs.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert costs.bound_ms(0, 989e12) == pytest.approx(1e3)
    assert costs.bound_ms(3.35e9, 989e12) == pytest.approx(1e3)


def test_kernel_shapes_of_the_cells():
    assert costs.padded_hw(PWC, (436, 1024)) == (448, 1024)
    assert costs.corr_shapes(PWC, 1, (448, 1024)) == [
        (1, 7, 16, 196), (1, 14, 32, 128), (1, 28, 64, 96),
        (1, 56, 128, 64), (1, 112, 256, 32)]
    assert costs.stem_shapes(PWC, 8, (384, 448)) == [(16, 384, 448, 3)]
    raft = costs.corr_shapes(RAFT, 1, (448, 1024))
    assert len(raft) == 24 and raft[:2] == [(1, 56, 128, 128),
                                            (1, 28, 64, 128)]
    assert costs.stem_shapes(RAFT, 1, (448, 1024)) == []


def test_union_clips_and_merges():
    iv = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 40, 50)]
    assert harness.union_us(iv, (0, 100)) == 15 + 10 + 10
    assert harness.union_us(iv, (8, 45)) == 7 + 10 + 5
    assert harness.union_us([], (0, 1)) == 0


def _view(kernels, items=2):
    return harness.TraceView(
        kind="stream", stretch=(0.0, 1000.0), items=items, pairs_per_item=1,
        kernels=kernels, copies=[("Memcpy HtoD (Pageable -> Device)", 0, 50)],
        spans=[("flowbench.entry", 0, 600)],
        calls={"corr": [(1, 7, 16, 196)]}, config=PWC, hw=(448, 1024),
        window_items=20, window_s=0.01)


def test_roofline_from_a_made_up_trace():
    k = "void (anonymous namespace)::corr_band<4, 2, 1>(bf16 const*)"
    other = "sm90_xmma_fprop_implicit_gemm_bf16"
    view = _view([(k, 100, 110), (other, 110, 300), (k, 400, 410)])
    bound = costs.bound_ms(*costs.corr_cost((1, 7, 16, 196)))
    got = harness.roofline(view, r"::corr_(band|fwd)\b", ["corr"],
                           {"corr": 1})
    assert got == pytest.approx(100 * 2 * bound / 0.020)


def test_a_missing_kernel_fails_the_reading():
    k = "void (anonymous namespace)::corr_band<4, 2, 1>(bf16 const*)"
    with pytest.raises(RuntimeError, match="1 kernels"):
        harness.roofline(_view([(k, 100, 110)]), r"::corr_(band|fwd)\b",
                         ["corr"], {"corr": 1})


def test_breakdown_names_gaps_by_the_host_span():
    view = _view([("k1", 100, 200), ("k2", 700, 900)])
    b = harness.breakdown(view)
    assert b["device_ops"][0] == ["k2", pytest.approx(200e-6)]
    gaps = dict((round(s * 1e6), n) for n, s in b["idle_gaps"])
    assert gaps[500] == "flowbench.entry"
    assert gaps[100] == "flowbench.other"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("name", ["copy_ms.stream", "device_busy_ms.stream",
                                  "idle_share.stream"])
def test_stream_readers_on_a_made_up_trace(name):
    view = _view([("k1", 100, 200), ("k2", 150, 300)])
    got = harness.load_module(harness.BENCH / "metrics"
                              / f"{name}.py").read(view)
    want = {"copy_ms.stream": 0.025, "device_busy_ms.stream": 0.1,
            # 250 us busy over the stretch's 2 pairs, 20 pairs in 10 ms.
            "idle_share.stream": 100 * (1 - 125 * 20 / 10000)}[name]
    assert got == pytest.approx(want)


def test_model_flops_count_the_reference():
    cfg = dict(PWC, search_range=4, flow_scale=20.0,
               estimator_channels=[128, 128, 96, 64, 32],
               context=[[128, 1], [128, 2], [128, 4], [96, 8], [64, 16],
                        [32, 1]])
    fwd = costs.model_flops(cfg, 1, (64, 64), False)
    train = costs.model_flops(cfg, 1, (64, 64), True)
    assert 0 < fwd < train < 3.5 * fwd
    assert costs.model_flops(cfg, 2, (64, 64), False) == pytest.approx(
        2 * fwd)
