"""Host ms per pair that ``predict_flow`` spends on host work: its span
less its ``.upload`` and ``.fetch`` spans (``entry_sync_ms.stream``) and
less the graph's launch (``capture.replay``), so the padding, the
capture's key and buffer loads and the output's clone. From the program's
own spans (``pwcnet_tpu_torch.trace``), which the profiler turns on: the
traced stretch's calls, the lead-in call before it left out. The launch is
left out because the profiler inflates it: under it ``cudaGraphLaunch``
holds the host for milliseconds (2 ms for PWC-Net, 9.5 ms for RAFT on an
H100) against 0.03-0.3 ms without it."""


def read(view):
    try:
        from pwcnet_tpu_torch import trace
    except ImportError:  # a program without spans of its own
        return None
    calls = trace.totals("predict_flow", view.items)
    if not calls or len(calls) < view.items:
        return None
    ns = sum(c["predict_flow"] - c.get("predict_flow.upload", 0)
             - c.get("predict_flow.fetch", 0) - c.get("capture.replay", 0)
             for c in calls)
    return ns / 1e6 / view.items
