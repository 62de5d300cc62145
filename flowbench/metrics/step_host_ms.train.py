"""Host ms per step inside the train step's call (its ``train_step`` span)
less the graph's launch (``capture.replay``): the signature keys, the
loads into the graph's buffers and the scheduler's step. From the
program's own spans (``pwcnet_tpu_torch.trace``), which the profiler turns
on: the traced stretch's steps, the lead-in step left out. The launch is
left out because the profiler inflates it: under it ``cudaGraphLaunch``
holds the host for about 8 ms a step on an H100, against 0.3 ms without
it."""


def read(view):
    try:
        from pwcnet_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    calls = trace.totals("train_step", view.items)
    if not calls or len(calls) < view.items:
        return None
    return sum(c["train_step"] - c.get("capture.replay", 0)
               for c in calls) / 1e6 / view.items
