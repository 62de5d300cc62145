"""K1's share (%) of its roofline in the traced stretch: the bound time of
every correlation call at its shapes (``costs.corr_cost``) over the
profiler's time of the bf16 correlation kernel, one per call."""

from flowbench.harness import roofline

PATTERN = r"::corr_(band|fwd)\b"


def read(view):
    return roofline(view, PATTERN, ["corr"], {"corr": 1})
