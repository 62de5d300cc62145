"""Host ms per step that the device batcher spends on host work: its
``device_batcher`` span less its ``.upload`` spans
(``feed_sync_ms.train``), so the numpy draws, the rendering's launches and
the stack. From the program's own spans (``pwcnet_tpu_torch.trace``),
which the profiler turns on: the traced stretch's batches, the lead-in
step's left out. It reads higher there than without the profiler, which
records every operator the rendering launches (on an H100: 22-26.5 ms a
step in the stretch against 10.1-10.6 ms untraced)."""


def read(view):
    try:
        from pwcnet_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    calls = trace.totals("device_batcher", view.items)
    if not calls or len(calls) < view.items:
        return None
    ns = sum(c["device_batcher"] - c.get("device_batcher.upload", 0)
             for c in calls)
    return ns / 1e6 / view.items
