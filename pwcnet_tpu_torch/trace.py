"""The port's tracing: host spans where a call or a step waits on the
device or works on the host, and one registry of counters.

**Spans.** ``with trace.span("predict_flow.upload"):`` records a
``Record``: the span's name, its start and end on
``time.perf_counter_ns``, the index of the span that encloses it
(``parent``, -1 at the top) and the index of the outermost one (``top``:
the spans of one call share it). Spans are off by default: ``span`` then
checks two flags and returns one shared no-op context, with no clock
read and no allocation. They are on inside ``with trace.enabled():`` and
while a ``torch.profiler`` records; under a profiler each span is also a
``record_function`` range, on the profiler's clock beside the kernels and
copies in every trace it exports (``train.profile_dir``'s too). Closed
spans go into an in-memory ring of the last ``CAPACITY``; ``records()``
reads it, ``totals()`` sums it per top-level span, ``reset()`` clears it.

The spans, each child named after its parent:

- ``predict_flow``: ``.pad`` (reading the frames, acquiring the model's
  staging buffers of their shape), ``.upload`` (the frames' copy into the
  host buffer, pinned on a GPU, and the issue of its one non-blocking copy
  into the padded device buffer), ``.run`` (``infer_flow``), ``.fetch``
  (crop, cast, device-to-host copy: waits for the forward);
- ``capture.key``, ``capture.load``, ``capture.replay`` (the launch) and
  ``capture.record`` (warm-up and capture) inside ``Captured.__call__``;
- ``device_batcher``: ``.draw`` (a sample's numpy draws), ``.upload`` (the
  batch's one copy of the draws, pinned and non-blocking on a GPU),
  ``.render`` (a sample's rendering launches, then the stack);
- ``train_step``: ``.draw`` (the augmentation's host draws),
  ``.schedule`` (``scheduler.step()``), and the ``capture.*`` spans;
- ``trainer.feed`` around getting a batch in ``train()``, with
  ``to_device.pin`` and ``to_device.copy``; ``loader.wait``, the wait on
  the ``Loader``'s queue.

No span lies inside the models: host ranges recorded while a CUDA graph
is captured do not recur when it is replayed.

**Counters.** Named groups of counters, always on: ``counters(group)``
is the group's dict (the same object at every call), which its owner
adds to in place. The kernel modules' ``LAUNCHES`` dicts are their
``launches.<module>`` groups (among them ``launches.encoder_norm``:
``stats`` and ``apply``, 13 and 26 a published-RAFT forward; and
``launches.global_attention``: ``map`` and ``aggregate``, GMA's map, one
a forward, and its aggregation, one an iteration, and ``aggregate_split``,
the aggregations that split their keys across a cluster; and
``launches.window_attention``: ``window``, ``shifted`` and ``global``,
GMFlow's attention over unshifted and shifted windows and over the whole
grid, 12, 12 and 2 a forward); each
``Captured`` counts
``capture.<name>.captures`` (signatures recorded) and ``.replays``
(signatures found); the device batcher counts ``device_batcher.batches``
and ``.pinned_uploads``; ``predict_flow`` counts ``predict_flow.calls``
and ``.pinned_uploads`` (one a call on a GPU, none on the CPU).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

CAPACITY = 1 << 16


class Record(NamedTuple):
    index: int      # order of opening
    name: str
    start_ns: int
    end_ns: int
    parent: int     # index of the enclosing span; -1 at the top
    top: int        # index of the outermost enclosing span (its own at the top)


_on = False
_clock = time.perf_counter_ns
_ring: List[Optional[Record]] = [None] * CAPACITY
_index = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "index", "parent", "top", "start", "range", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.index = next(_index)
        if stack:
            self.parent, self.top = stack[-1].index, stack[-1].top
        else:
            self.parent, self.top = -1, self.index
        stack.append(self)
        self.stack = stack
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        _ring[self.index % CAPACITY] = Record(
            self.index, self.name, self.start, end, self.parent, self.top)
        return False


def span(name: str):
    """A context that records a span named ``name`` while spans are on
    (inside ``enabled()`` or under a recording ``torch.profiler``), and
    the shared no-op context otherwise."""
    if _on or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


@contextlib.contextmanager
def enabled():
    """Spans on while open, with or without a profiler."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before


def records() -> List[Record]:
    """The ring's records (the last ``CAPACITY`` closed spans), in the
    order they were opened."""
    return sorted((r for r in _ring if r is not None),
                  key=lambda r: r.index)


def totals(name: str, last: Optional[int] = None) -> List[Dict[str, int]]:
    """Per top-level span named ``name`` (the last ``last`` of them), its
    nanoseconds and each descendant's, summed by name: ``{name: ns,
    child name: ns, ...}``, oldest first."""
    recs = records()
    tops = [r.index for r in recs if r.parent < 0 and r.name == name]
    if last is not None:
        tops = tops[max(len(tops) - last, 0):]
    out: Dict[int, Dict[str, int]] = {i: {} for i in tops}
    for r in recs:
        ns = out.get(r.top)
        if ns is not None:
            ns[r.name] = ns.get(r.name, 0) + r.end_ns - r.start_ns
    return list(out.values())


def reset() -> None:
    """Empties the ring (call it with no span open)."""
    global _index
    _ring[:] = [None] * CAPACITY
    _index = itertools.count()


# -- counters ----------------------------------------------------------------

_GROUPS: Dict[str, Dict[str, float]] = {}


def counters(group: str, names: Iterable[str] = ()) -> Dict[str, float]:
    """The registry's dict of ``group``, made on first use, with each of
    ``names`` present (0 where new)."""
    d = _GROUPS.setdefault(group, {})
    for n in names:
        d.setdefault(n, 0)
    return d


def groups(prefix: str) -> Dict[str, Dict[str, float]]:
    """The registry's groups named ``prefix`` or ``prefix.<...>``."""
    return {g: d for g, d in _GROUPS.items()
            if g == prefix or g.startswith(prefix + ".")}
