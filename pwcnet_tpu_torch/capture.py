"""Step capture: the port's counterpart of ``jax.jit``.

JAX compiles each step into one program and dispatches it once
(``pwcnet_tpu/train/step.py``, ``train/evaluate.py``, ``frontend.py``).
Here ``Captured(fn)`` records ``fn`` as a ``torch.cuda.CUDAGraph`` once per
input signature and replays it from static buffers:

- **Signature.** The shapes, dtypes and devices of the tensor arguments,
  the hashable static arguments (``train=False``, a loss kind, ...), a
  module argument's identity and the ``data_ptr`` of each of its
  parameters and buffers, and the grad and inference modes. As JAX
  re-traces on a new shape, a new signature is captured anew; a moved or
  rebuilt model misses the cache, while ``load_state_dict`` (which copies
  in place) keeps it.
- **Static buffers.** A call ``copy_``s its tensors into the entry's
  buffers, replays, and returns clones of the outputs: JAX returns fresh
  arrays, and a caller may keep them across calls. A module argument is
  held weakly.
- **Memory.** The entries of one ``Captured`` share one graph pool.
- **Warm-up.** ``warmup`` eager calls on the static buffers, then the
  capture, both on a side stream, as PyTorch's whole-network capture
  recipe does. A function with side effects (the train step) takes
  ``warmup=0`` and makes its own first call through ``warm``.
- **Failure.** A capture that fails raises ``RuntimeError`` naming the
  signature. Nothing falls back to the eager path.

``capture_enabled`` resolves an entry point's ``capture`` argument: None
means on for a CUDA model outside a mesh of several processes (whose
collectives are not captured), ``True`` on the CPU raises. ``model_captured``
keeps a model's graphs with the model, for as long as it lives.

The port's kernel wrappers launch on ``torch.cuda.current_stream()``, so a
capture records them, and a replay launches what the capture recorded:
their ``LAUNCHES`` counters add a signature's launches once, at its
capture. ``Captured`` counts in ``trace.py``'s registry
``capture.<name>.captures`` (signatures recorded) and ``.replays``
(signatures found), and records the spans ``capture.key``, ``capture.load``,
``capture.replay`` and ``capture.record``.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from pwcnet_tpu_torch import trace


def capture_enabled(capture: Optional[bool], device,
                    distributed: bool = False) -> bool:
    """Whether an entry point captures: ``capture`` None means on a CUDA
    device outside a mesh of several processes. ``True`` on another device
    raises ``RuntimeError``, and under such a mesh ``ValueError``."""
    dev = torch.device(device)
    if capture is None:
        return dev.type == "cuda" and not distributed
    if capture and dev.type != "cuda":
        raise RuntimeError(f"step capture needs a CUDA device; the model is "
                           f"on {dev}")
    if capture and distributed:
        raise ValueError("a mesh of several processes runs eagerly: its "
                         "collectives are not captured (pass capture=None)")
    return bool(capture)


def _flatten(tree, leaves: List[Any]):
    """``tree``'s tensors, modules and static values into ``leaves``;
    returns its structure, which ``_build`` fills again."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves))
                            for k, v in tree.items()))
    leaves.append(tree)
    return None


def _build(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, items = spec
    if kind is dict:
        return {k: _build(s, leaves) for k, s in items}
    return kind(_build(s, leaves) for s in items)


def _leaf_key(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, nn.Module):
        return ("module", id(x), tuple(
            t.data_ptr() for t in (*x.parameters(), *x.buffers())))
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a captured function's non-tensor argument must be "
                        f"hashable; got {type(x).__name__}") from None
    return ("static", type(x), x)


def _split(tree) -> Tuple[Any, List[Any]]:
    leaves: List[Any] = []
    return _flatten(tree, leaves), leaves


def _key(spec, leaves: List[Any]) -> tuple:
    return (spec, tuple(_leaf_key(x) for x in leaves),
            torch.is_grad_enabled(), torch.is_inference_mode_enabled())


def signature(*args, **kwargs) -> tuple:
    """The cache key of a call (see the module docstring)."""
    return _key(*_split((args, kwargs)))


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _keep(x):
    """A leaf as an entry keeps it: a tensor as a static buffer of its
    own, a module through a weak reference (a model's graphs must not keep
    the model alive), any other value as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, nn.Module):
        return weakref.ref(x)
    return x


def _kept(x):
    return x() if isinstance(x, weakref.ReferenceType) else x


class _Entry:
    """One signature's graph, its static inputs and its outputs."""

    def __init__(self, spec, static: List[Any]):
        self.spec, self.static = spec, static
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None

    def args(self) -> Tuple[tuple, dict]:
        return _build(self.spec, (_kept(x) for x in self.static))

    def load(self, leaves: List[Any]) -> None:
        for buf, x in zip(self.static, leaves):
            if isinstance(buf, torch.Tensor):
                buf.copy_(x)


class Captured:
    """``fn`` captured once per signature and replayed (module docstring).
    ``warmup`` eager calls on the static buffers precede each capture."""

    def __init__(self, fn: Callable, warmup: int = 1, name: str = ""):
        self.fn, self.warmup = fn, warmup
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self._counts = trace.counters(
            "capture." + self.name.replace(" ", "_"), ("captures", "replays"))
        self.entries: Dict[tuple, _Entry] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __contains__(self, key: tuple) -> bool:
        return key in self.entries

    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def warm(self, *args, **kwargs):
        """``fn(*args, **kwargs)`` once, eagerly, on the capture stream:
        the first call of a function with side effects."""
        _, leaves = _split((args, kwargs))
        dev = next(x.device for x in leaves if isinstance(x, torch.Tensor))
        side, main = self._side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*args, **kwargs)
        main.wait_stream(side)
        return out

    def _record(self, key: tuple, entry: _Entry) -> None:
        """Warm up on the static buffers, then capture into the pool."""
        for x in entry.static:
            if isinstance(x, torch.Tensor) and x.device.type != "cuda":
                raise RuntimeError(f"step capture needs CUDA tensors; "
                                   f"{self.name} got one on {x.device}")
        args, kwargs = entry.args()
        for _ in range(self.warmup):
            self.warm(*args, **kwargs)
        dev = next(x.device for x in entry.static
                   if isinstance(x, torch.Tensor))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._side_stream(dev)):
                entry.outputs = self.fn(*args, **kwargs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed "
                               f"for the signature {key}: {e}") from e
        entry.graph = graph

    def _replay(self, entry: _Entry) -> None:
        entry.graph.replay()

    def __call__(self, *args, **kwargs):
        with trace.span("capture.key"):
            spec, leaves = _split((args, kwargs))
            key = _key(spec, leaves)
        entry = self.entries.get(key)
        if entry is None:
            self._counts["captures"] += 1
            with trace.span("capture.record"):
                entry = _Entry(spec, [_keep(x) for x in leaves])
                self._record(key, entry)
            self.entries[key] = entry
        else:
            self._counts["replays"] += 1
            with trace.span("capture.load"):
                entry.load(leaves)
        with trace.span("capture.replay"):
            self._replay(entry)
        return _clone(entry.outputs)


# Each model's captured functions, by name, for as long as the model lives.
_BY_MODEL: "weakref.WeakKeyDictionary[nn.Module, Dict[str, Captured]]" = \
    weakref.WeakKeyDictionary()


def model_captured(model: nn.Module, name: str, fn: Callable,
                   warmup: int = 1) -> Captured:
    """``model``'s ``Captured`` of ``fn`` under ``name``, made on first use.
    ``fn`` takes the model as an argument and holds no reference to it,
    and an entry holds its module arguments weakly, so the graphs go when
    the model goes."""
    per = _BY_MODEL.setdefault(model, {})
    if name not in per:
        per[name] = Captured(fn, warmup, name)
    return per[name]
