"""Host ms per step that the device batcher spends in synchronous copies
of its draws to the device (its ``device_batcher.upload`` spans, one per
sample), each of which waits for the work queued before it. From the
program's own spans (``pwcnet_tpu_torch.trace``), which the profiler turns
on: the traced stretch's batches, the lead-in step's left out. It reads
lower there than without the profiler, which holds the host in the
previous step's graph launch while that step runs, so that less of it is
left to wait for (on an H100: 8-9.5 ms a step in the stretch against
12.5 ms untraced)."""


def read(view):
    try:
        from pwcnet_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    calls = trace.totals("device_batcher", view.items)
    if not calls or len(calls) < view.items:
        return None
    ns = sum(c.get("device_batcher.upload", 0) for c in calls)
    return ns / 1e6 / view.items
