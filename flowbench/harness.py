"""The benchmark's common parts: the manifest and the files a cell names,
the seeded weights, the port's model built as the trainer builds it, the
profiler's records as plain intervals, the result line.

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
``cells/<workload>.json`` (the limits of the comparison that decides
``correct``) and ``metrics/<metric>.py`` (a per-layer reader).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Build and kernel caches of a checkout: a fixed path inside it.
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pwcnet_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: Sequence[dict], name: str) -> List[dict]:
    return [m for m in metrics if name in m.get("workloads", [name])]


def resolve(workload: str, man: Optional[dict] = None) -> Cell:
    """The cell named ``workload`` with its configuration, traffic, limits
    and the metrics it reports."""
    man = manifest() if man is None else man
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    return Cell(name=workload, chips=w["chips"],
                config=_json(ROOT / configs[w["config"]]["file"]),
                traffic=_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=_json(BENCH / "cells" / f"{workload}.json")["limits"],
                end_to_end=_for_cell(man["end_to_end"], workload),
                per_layer=_for_cell(man["per_layer"], workload))


def load_module(path: Path):
    """A file of the benchmark (driver, metric reader) as a module."""
    name = "flowbench_" + re.sub(r"\W", "_", str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``pwcnet_tpu_torch`` is not ``pwcnet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- weights and the port's model --------------------------------------------

def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    from flowbench.reference import pwcnet, raft
    mod = pwcnet if cfg["family"] == "pwcnet" else raft
    return mod.param_shapes(cfg)


def seeded_weights(cfg: dict, seed: int, device) -> Dict[str, "object"]:
    """The cell's f32 weights from ``seed``, drawn on ``device`` in one
    call: truncated-normal-like conv weights of std sqrt(1 / fan_in) (the
    flax default's scale), biases of std 0.01."""
    import torch
    shapes = param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, chunk in zip(names, flat.split(sizes)):
        shape = shapes[k]
        if k.endswith(".weight"):
            std = math.sqrt(1.0 / math.prod(shape[1:]))
            out[k] = (chunk.clamp(-2.0, 2.0) * std).view(shape)
        else:
            out[k] = (chunk * 0.01).view(shape)
    return out


def port_config(cfg: dict, preset: str = "chairs-1chip", **sections):
    """The port's ``Config``: ``preset`` with the configuration's model
    fields (``port_model``) and the given section fields replaced."""
    from pwcnet_tpu_torch.config import PRESETS, ModelConfig
    pc = PRESETS[preset]
    pc = dataclasses.replace(pc, model=ModelConfig(**cfg["port_model"]))
    for name, fields in sections.items():
        pc = dataclasses.replace(pc, **{name: dataclasses.replace(
            getattr(pc, name), **fields)})
    return pc


def port_model(cfg: dict, weights: dict, device, preset="chairs-1chip"):
    """The port's model built as its trainer builds it, then loaded with
    the benchmark's weights."""
    from pwcnet_tpu_torch.train.loop import build_model
    model = build_model(port_config(cfg, preset), device)
    model.load_state_dict(weights)
    return model


# -- the comparison ----------------------------------------------------------

def rel_l2(a, b) -> float:
    """||a - b|| / ||b||."""
    import torch
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def checks(readings: Dict[str, float], limits: Dict[str, float]
           ) -> List[Tuple[str, float, float]]:
    """The readings that the cell compares, each with its limit."""
    return [(name, readings[name], lim) for name, lim in limits.items()]


def median(values: Sequence[float]) -> float:
    v = sorted(values)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def leaf_gaps(prog: dict, ref: dict,
              keep: Optional[Sequence[str]] = None) -> List[float]:
    """Each leaf's gap of norms, | ||prog_k|| - ||ref_k|| |, over the larger
    of ||ref_k|| and the median leaf's ||ref||."""
    import torch
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref.items()}
    med = median(list(norms.values()))
    return [abs(float(torch.linalg.vector_norm(prog[k].double()))
                - norms[k]) / max(norms[k], med, 1e-30)
            for k in (ref if keep is None else keep)]


def reference_precision() -> None:
    """Float32 everywhere for the reference: no TF32 in matmuls or cuDNN."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- the trace ---------------------------------------------------------------

Interval = Tuple[str, float, float]   # (name, start us, end us)


@dataclass
class TraceView:
    """What a per-layer reader reads: the traced stretch's device kernels
    and copies and the benchmark's host spans, in the profiler's clock
    (microseconds), and the measured window, which nothing traces, on the
    host's clock."""
    kind: str                          # "stream" | "train"
    stretch: Tuple[float, float]
    items: int                         # pairs or steps in the stretch
    pairs_per_item: int
    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)
    spans: List[Interval] = field(default_factory=list)
    calls: Dict[str, list] = field(default_factory=dict)   # kernel shapes
    config: dict = field(default_factory=dict)
    hw: Tuple[int, int] = (0, 0)       # padded input size of an item
    window_items: int = 0
    window_s: float = 0.0
    window_feed_s: float = 0.0

    @property
    def stretch_us(self) -> float:
        return self.stretch[1] - self.stretch[0]


def union_us(intervals: Sequence[Interval],
             within: Tuple[float, float]) -> float:
    """Length of the union of the intervals, clipped to ``within``."""
    lo, hi = within
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                   if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_time_us(view: TraceView, pattern: str, expected: int) -> float:
    """Summed time of the stretch's kernels whose name matches
    ``pattern``; raises unless there are exactly ``expected`` of them (a
    kernel missing from the profiler's records would make a roofline read
    too high)."""
    rx = re.compile(pattern)
    hits = [(s, e) for name, s, e in view.kernels if rx.search(name)]
    if len(hits) != expected:
        raise RuntimeError(f"the trace holds {len(hits)} kernels matching "
                           f"{pattern!r}, {expected} expected")
    return sum(e - s for s, e in hits)


def roofline(view: TraceView, pattern: str, groups: Sequence[str],
             kernels_per_call: Dict[str, int]) -> Optional[float]:
    """100 x the summed bound time of the stretch's calls of ``groups``
    (``view.calls``: shapes; costs' functions) over the summed profiler
    time of the kernels matching ``pattern``, which must number
    ``kernels_per_call`` per call. None where the cell makes no such
    call."""
    from flowbench import costs
    cost = {"corr": costs.corr_cost, "corr_bwd": costs.corr_bwd_cost,
            "stem": costs.stem_cost, "stem_bwd": costs.stem_bwd_cost}
    calls = [(g, s) for g in groups for s in view.calls.get(g, [])]
    if not calls:
        return None
    bound = view.items * sum(costs.bound_ms(*cost[g](s)) for g, s in calls)
    expected = view.items * sum(kernels_per_call[g] for g, _ in calls)
    return 100.0 * bound / (kernel_time_us(view, pattern, expected) / 1e3)


def idle_share(view: TraceView) -> Optional[float]:
    """100 x the share of the measured window with nothing on the device:
    1 - the stretch's device time an item (the union of its kernels and
    copies) times the window's items, over the window's length. The
    stretch's own idle share reads higher, since the profiler slows the
    host's launches inside it; ``device.busy_s / device.window_s`` give
    that one. None without device kernels."""
    if not view.kernels or not view.window_items:
        return None
    busy_us = union_us(view.kernels + view.copies, view.stretch) / view.items
    return 100.0 * (1.0 - busy_us * view.window_items
                    / (view.window_s * 1e6))


def mfu(view: TraceView, train: bool) -> float:
    """100 x the model FLOPs of the pairs done in the measured window over
    its seconds times the bf16 peak."""
    from flowbench import costs
    flops = costs.model_flops(view.config, view.pairs_per_item, view.hw,
                              train)
    return 100.0 * flops * view.window_items / (view.window_s
                                                * costs.BF16_FLOPS)


def from_profiler(prof, stretch_name: str) -> Tuple[Tuple[float, float],
                                                     List[Interval],
                                                     List[Interval],
                                                     List[Interval]]:
    """(stretch, kernels, copies, host spans) from a ``torch.profiler``
    run whose stretch is the host range ``stretch_name``. What ran before
    the stretch (the profiler's lead-in) is left out: a device operation
    by its midpoint, a span by its start."""
    from torch.autograd import DeviceType
    kernels, copies, spans = [], [], []
    stretch = None
    events = list(prof.events())
    for ev in events:
        if ev.name == stretch_name and ev.device_type == DeviceType.CPU:
            stretch = (ev.time_range.start, ev.time_range.end)
    if stretch is None:
        raise RuntimeError(f"the profiler recorded no {stretch_name!r} range")
    for ev in events:
        start, end = ev.time_range.start, ev.time_range.end
        if ev.name.startswith("flowbench."):
            if (ev.device_type == DeviceType.CPU and ev.name != stretch_name
                    and start >= stretch[0]):
                spans.append((ev.name, start, end))
            continue
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or start + end < 2 * stretch[0]):
            continue
        if ev.name.startswith(("Memcpy", "Memset")):
            copies.append((ev.name, start, end))
        else:
            kernels.append((ev.name, start, end))
    return stretch, kernels, copies, spans


def breakdown(view: TraceView) -> dict:
    """The stretch's 10 device operations that took most time, by name,
    and its 10 longest idle gaps, each named by the benchmark span the
    host was in when the gap began (seconds)."""
    by_name: Dict[str, float] = {}
    for name, s, e in view.kernels + view.copies:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda t: -t[1])[:10]
    lo, hi = view.stretch
    busy = sorted((max(s, lo), min(e, hi)) for _, s, e in
                  view.kernels + view.copies if e > lo and s < hi)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))

    def host_at(t: float) -> str:
        inside = [(s, name) for name, s, e in view.spans if s <= t < e]
        return max(inside)[1] if inside else "flowbench.other"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[host_at(s), (e - s) / 1e6] for s, e in longest]}


# -- the result --------------------------------------------------------------

@dataclass
class Outcome:
    """What a driver's run gives the harness."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Tuple[str, float, float]]   # (name, value, limit)
    memory_peak_bytes: int
    readings: Dict[str, float] = field(default_factory=dict)
    view: Optional[TraceView] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def read_per_layer(cell: Cell, view: TraceView) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, outcome: Outcome, metrics: Dict[str, dict],
                device: dict, breakdown_: Optional[dict]) -> str:
    res = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown_ is not None:
        res["breakdown"] = breakdown_
    res["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in outcome.checks}
    return json.dumps(res)


# -- the measured window -----------------------------------------------------

class Spans:
    """The benchmark's host spans around its calls into the program: summed
    on the host's clock, and inside the traced stretch also recorded as
    profiler ranges ``flowbench.<name>``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            from torch.profiler import record_function
            with record_function("flowbench." + name):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)


@dataclass
class Window:
    """A measured window: items done, seconds and the host spans summed over
    it; with a trace, the profiler of the stretch that followed it."""
    items: int
    seconds: float
    spans: Dict[str, float] = field(default_factory=dict)
    prof: object = None
    stretch_items: int = 0


def run_window(one: Callable[[int], None], seconds: float, sync: Callable,
               spans: Spans, trace_seconds: Optional[float] = None
               ) -> Window:
    """Call ``one(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host's clock, then ``sync()``: the window closes once the device
    is done. Nothing inside the window is traced. With ``trace_seconds``,
    a stretch follows the closed window under ``torch.profiler``: one
    lead-in item and a ``sync()``, so that the profiler's start lies
    outside the stretch, then the range ``flowbench.stretch``, items for
    ``trace_seconds`` (3 at least) ending with a ``sync()``."""
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one(i)
        i += 1
    sync()
    win = Window(items=i, seconds=time.perf_counter() - t0,
                 spans=dict(spans.totals))
    if trace_seconds is None:
        return win
    from torch.profiler import ProfilerActivity, profile, record_function
    win.prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    with win.prof:
        one(i)
        i += 1
        sync()
        spans.traced = True
        with record_function("flowbench.stretch"):
            t1 = time.perf_counter()
            while (win.stretch_items < 3
                   or time.perf_counter() - t1 < trace_seconds):
                one(i)
                i += 1
                win.stretch_items += 1
            sync()
        spans.traced = False
    return win
