"""The port's tracing (``pwcnet_tpu_torch/trace.py``) on the CPU: spans off
(one shared no-op context, no clock read, no allocation), spans on (names,
nesting, parents, shared ids, the ring's bound), spans switched on by a
``torch.profiler`` and recorded there as ranges, the spans at the
program's sites, the counter registry that holds the kernels' ``LAUNCHES``
dicts, and the benchmark's readers of the spans on hand-built records."""

from __future__ import annotations

import contextlib
import importlib
import sys
import tracemalloc

import numpy as np
import pytest
import torch

from flowbench import harness
from pwcnet_tpu_torch import PWCNet, trace
from pwcnet_tpu_torch.data.pipeline import Loader
from pwcnet_tpu_torch.data.synthetic import SyntheticFlow, make_device_batcher
from pwcnet_tpu_torch.parallel import launch
from pwcnet_tpu_torch.train.evaluate import predict_flow

import torch_port_util  # noqa: F401  (this process's share of the cores)


@pytest.fixture(autouse=True)
def clean_ring():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def ticks(monkeypatch):
    """A clock that advances 1000 ns at every read."""
    now = iter(range(0, 10 ** 12, 1000))
    monkeypatch.setattr(trace, "_clock", lambda: next(now))


def _names(recs):
    return [r.name for r in recs]


# -- spans off ---------------------------------------------------------------

def test_spans_off_return_one_noop_context_and_read_no_clock(monkeypatch):
    def refuse(*_):
        raise AssertionError("an off span did work")

    for name in ("_clock", "_Span", "Record", "record_function"):
        monkeypatch.setattr(trace, name, refuse)
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("a.b"):
            pass
    assert trace.records() == []


def _peak_bytes(make) -> int:
    """Peak bytes allocated over 1000 ``with make(name): pass``."""
    def loop(names):
        for name in names:
            with make(name):
                pass

    names = ["predict_flow"] * 1000
    loop(names)  # first calls out of the way
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(names)
        return tracemalloc.get_traced_memory()[1] - before
    finally:
        tracemalloc.stop()


def test_spans_off_allocate_nothing():
    null = contextlib.nullcontext()
    # The loop's own allocations, then the same loop through trace.span.
    assert _peak_bytes(trace.span) == _peak_bytes(lambda name: null)
    with trace.enabled():
        assert _peak_bytes(trace.span) > _peak_bytes(lambda name: null)


# -- spans on ----------------------------------------------------------------

def test_spans_on_record_names_nesting_parents_and_ids(ticks):
    with trace.enabled():
        with trace.span("call"):
            with trace.span("call.a"):
                with trace.span("call.a.b"):
                    pass
            with trace.span("call.c"):
                pass
        with trace.span("call"):
            pass
    assert trace.span("x") is trace.span("y")  # off again
    recs = trace.records()
    assert _names(recs) == ["call", "call.a", "call.a.b", "call.c", "call"]
    assert [r.index for r in recs] == [0, 1, 2, 3, 4]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert [r.top for r in recs] == [0, 0, 0, 0, 4]
    assert all(r.end_ns > r.start_ns for r in recs)
    call, a, b, c, _ = recs
    assert call.start_ns < a.start_ns < b.start_ns < b.end_ns < a.end_ns
    assert a.end_ns < c.start_ns < c.end_ns < call.end_ns


def test_enabled_nests_and_restores():
    with trace.enabled():
        with trace.enabled():
            pass
        assert trace.span("a") is not trace.span("a")
    assert trace.span("a") is trace.span("a")


def test_ring_keeps_the_last_spans_up_to_its_bound(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 8)
    monkeypatch.setattr(trace, "_ring", [None] * 8)
    with trace.enabled():
        for i in range(20):
            with trace.span(f"s{i}"):
                pass
    recs = trace.records()
    assert _names(recs) == [f"s{i}" for i in range(12, 20)]
    trace.reset()
    assert trace.records() == []


def test_totals_sum_each_top_level_span_by_name(ticks):
    with trace.enabled():
        for _ in range(3):
            with trace.span("call"):
                for _ in range(2):
                    with trace.span("call.a"):
                        with trace.span("deep"):
                            pass
        with trace.span("other"):
            pass
    # Per call: 2 x (a: 3 ticks wide, deep: 1) inside a call 9 wide.
    want = {"call": 9000, "call.a": 6000, "deep": 2000}
    assert trace.totals("call") == [want] * 3
    assert trace.totals("call", 2) == [want] * 2
    assert trace.totals("call", 0) == []
    assert trace.totals("missing") == []


def test_spans_turn_on_under_a_cpu_profiler_as_ranges():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("predict_flow"):
            with trace.span("predict_flow.run"):
                torch.ones(64).add_(1)
    assert trace.span("a") is trace.span("b")  # off once it stops
    assert _names(trace.records()) == ["predict_flow", "predict_flow.run"]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("predict_flow")}
    outer, inner = ranges["predict_flow"], ranges["predict_flow.run"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    adds = [e.time_range for e in prof.events() if e.name == "aten::add_"]
    assert adds and inner.start <= adds[0].start <= adds[0].end <= inner.end


# -- the program's span sites --------------------------------------------------

def test_predict_flow_spans():
    model = PWCNet(num_levels=3, output_level=2, device="cpu")
    rng = np.random.default_rng(0)
    im = rng.random((40, 60, 3), np.float32)
    with trace.enabled():
        flow = predict_flow(model, im, im, capture=False)
    assert flow.shape == (40, 60, 2)
    recs = trace.records()
    assert _names(recs) == ["predict_flow", "predict_flow.pad",
                            "predict_flow.upload", "predict_flow.run",
                            "predict_flow.fetch"]
    assert [r.parent for r in recs] == [-1, 0, 0, 0, 0]


def test_device_batcher_spans():
    batcher = make_device_batcher(2, (32, 32), seed=3, device="cpu")
    counts = trace.counters("device_batcher")
    before = dict(counts)
    with trace.enabled():
        batch = batcher(0)
    assert batch["im1"].shape == (2, 32, 32, 3)
    [calls] = trace.totals("device_batcher")
    recs = trace.records()
    assert _names(recs) == (["device_batcher"]
                            + ["device_batcher.draw"] * 2
                            + ["device_batcher.upload"]
                            + ["device_batcher.render"] * 3)
    assert {r.parent for r in recs[1:]} == {0}
    assert set(calls) == {"device_batcher", "device_batcher.draw",
                          "device_batcher.upload", "device_batcher.render"}
    assert counts["batches"] == before["batches"] + 1
    assert counts["pinned_uploads"] == before["pinned_uploads"]


def test_loader_wait_span():
    ds = SyntheticFlow(hw=(16, 16), length=4)
    loader = Loader(ds, 1, sample_hw=(16, 16), num_threads=1)
    try:
        with trace.enabled():
            next(loader)
    finally:
        loader.close()
    assert _names(trace.records()) == ["loader.wait"]


# -- counters ------------------------------------------------------------------

KERNEL_MODULES = ["conv_folded", "cost_volume", "stem", "warp_corr",
                  "corr_pyramid", "corr_lookup"]


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_launches_dicts_are_the_registry_groups(name):
    mod = importlib.import_module(
        f"pwcnet_tpu_torch.ops.kernels.{name}_kernel")
    assert mod.LAUNCHES is trace.counters(f"launches.{name}")
    assert trace.groups("launches")[f"launches.{name}"] is mod.LAUNCHES


def test_launch_reads_the_launches_through_the_registry():
    from pwcnet_tpu_torch.ops.kernels import cost_volume_kernel as ck
    launch._reset_launches()
    ck.LAUNCHES["corr_fwd"] += 5
    trace.counters("launches.stem")["stem_fwd"] += 1
    assert launch._launches() == {"corr_fwd": 5, "stem_fwd": 1}
    launch._reset_launches()
    assert launch._launches() == {} and ck.LAUNCHES["corr_fwd"] == 0


def test_counters_are_one_dict_per_group():
    group = trace.counters("test_trace.group", ("hits",))
    group["hits"] += 1
    group["hits"] += 2
    again = trace.counters("test_trace.group", ("hits", "misses"))
    assert again is group
    assert group == {"hits": 3, "misses": 0}
    assert trace.groups("test_trace") == {"test_trace.group": group}
    assert trace.groups("test_trace.gr") == {}


# -- the benchmark's readers of the spans ------------------------------------

def _view(kind: str, items: int) -> harness.TraceView:
    return harness.TraceView(kind=kind, stretch=(0.0, 1.0), items=items,
                             pairs_per_item=1)


def _read(metric: str, view):
    return harness.load_module(
        harness.BENCH / "metrics" / f"{metric}.py").read(view)


def _stream_calls(n: int) -> None:
    """``n`` calls shaped as ``predict_flow``'s: the k-th (from 0) with
    upload k + 1 ticks wide, fetch 2 (k + 1) wide, pad 1, and run 4k + 3
    holding a graph launch 4k + 1 wide."""
    for k in range(n):
        with trace.span("predict_flow"):
            with trace.span("predict_flow.pad"):
                pass
            with trace.span("predict_flow.upload"):
                for _ in range(k):
                    trace._clock()
            with trace.span("predict_flow.run"):
                with trace.span("capture.replay"):
                    for _ in range(4 * k):
                        trace._clock()
            with trace.span("predict_flow.fetch"):
                for _ in range(2 * k + 1):
                    trace._clock()


def _train_calls(n: int) -> None:
    """``n`` steps: a device batcher with two samples whose uploads are
    k + 1 ticks wide each, then a train step 4k + 3 wide holding a graph
    launch 3k + 1 wide."""
    for k in range(n):
        with trace.span("device_batcher"):
            for _ in range(2):
                with trace.span("device_batcher.draw"):
                    pass
                with trace.span("device_batcher.upload"):
                    for _ in range(k):
                        trace._clock()
                with trace.span("device_batcher.render"):
                    pass
        with trace.span("train_step"):
            for _ in range(k):
                trace._clock()
            with trace.span("capture.replay"):
                for _ in range(3 * k):
                    trace._clock()


# (metric, kind, ms a call of the k-th call) with 1 tick = 1 us.
READERS = [
    ("entry_sync_ms.stream", "stream", lambda k: 3e-3 * (k + 1)),
    # A call is 12 + 7k ticks wide: upload and fetch 3 (k + 1), the launch
    # 4k + 1, the rest pad (1), run less the launch (2) and the 5 ticks
    # between the spans' edges.
    ("entry_host_ms.stream", "stream", lambda k: 8e-3),
    ("feed_sync_ms.train", "train", lambda k: 2e-3 * (k + 1)),
    # A batch is 13 + 2k ticks wide, its uploads 2 (k + 1).
    ("feed_host_ms.train", "train", lambda k: 11e-3),
    # A step less its launch: k + 2.
    ("step_host_ms.train", "train", lambda k: 1e-3 * (k + 2)),
]


@pytest.mark.parametrize("metric,kind,per_call", READERS,
                         ids=[r[0] for r in READERS])
def test_span_readers_read_the_stretch_alone(ticks, metric, kind, per_call):
    with trace.enabled():
        (_stream_calls if kind == "stream" else _train_calls)(4)
    # Call 0 is the lead-in; the stretch holds calls 1, 2, 3.
    got = _read(metric, _view(kind, 3))
    want = sum(per_call(k) for k in (1, 2, 3)) / 3
    assert got == pytest.approx(want, rel=1e-12)
    assert _read(metric, _view(kind, 5)) is None  # fewer calls than items


@pytest.mark.parametrize("metric", [r[0] for r in READERS])
def test_span_readers_find_nothing(metric, monkeypatch):
    view = _view(metric.rsplit(".", 1)[1], 3)
    assert _read(metric, view) is None  # no spans recorded
    # A program without the module (the benchmark laid over an older one).
    monkeypatch.setitem(sys.modules, "pwcnet_tpu_torch.trace", None)
    monkeypatch.delattr("pwcnet_tpu_torch.trace", raising=False)
    with trace.enabled():
        _stream_calls(3)
        _train_calls(3)
    assert _read(metric, view) is None
