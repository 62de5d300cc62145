"""K12's share (%) of its roofline in the traced stretch: the bound time
of GMFlow's window attention of each pair at its calls' shapes
(``costs_gmflow.attention_cost``: every window's whole q k^T and P v,
compute-bound) over the profiler's time of K12's kernels, 26 a pair."""

from flowbench.costs_gmflow import roofline


def read(view):
    return roofline(view)
