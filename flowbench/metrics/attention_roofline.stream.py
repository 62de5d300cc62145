"""K11's share (%) of its roofline in the traced stretch: the bound time of
GMA's global attention of each pair at its shape
(``costs_gma.attention_cost``: the map once, the aggregation once an
iteration, compute-bound) over the profiler's time of K11's kernels, one
map and one aggregation an iteration a pair."""

from flowbench.costs_gma import roofline


def read(view):
    return roofline(view)
