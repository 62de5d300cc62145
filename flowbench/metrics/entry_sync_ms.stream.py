"""Host ms per pair that ``predict_flow`` spends blocked on the device:
its ``.upload`` span (two host-to-device copies from pageable memory) and
its ``.fetch`` span (the device-to-host copy of the flow, which waits for
the forward). From the program's own spans (``pwcnet_tpu_torch.trace``),
which the profiler turns on: the traced stretch's calls, the lead-in call
before it left out. It reads lower there than without the profiler, which
holds the host in the graph's launch while the forward runs, so that less
of the forward is left to wait for in ``.fetch`` (RAFT on an H100: 4-6.5 ms
in the stretch against 11.3 ms untraced)."""


def read(view):
    try:
        from pwcnet_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    calls = trace.totals("predict_flow", view.items)
    if not calls or len(calls) < view.items:
        return None
    ns = sum(c.get("predict_flow.upload", 0) + c.get("predict_flow.fetch", 0)
             for c in calls)
    return ns / 1e6 / view.items
