"""K1 + K2 + K3's share (%) of their roofline in the traced stretch: the
bound time of every correlation call and of both backward kernels of each
(``costs.corr_cost``, ``costs.corr_bwd_cost``) over the profiler's time
of the three kernels, one per call each."""

from flowbench.harness import roofline

PATTERN = r"::corr_(band|fwd)\b|::corr_bwd(_band)?<"


def read(view):
    return roofline(view, PATTERN, ["corr", "corr_bwd"],
                    {"corr": 1, "corr_bwd": 1})
