"""K9's share (%) of its roofline in the traced stretch: the bound time of
every lookup of each pair at its shape (``costs_allpairs.lookup_cost``)
over the profiler's time of the lookup kernel, one an iteration."""

from flowbench.costs_allpairs import roofline


def read(view):
    return roofline(view, "lookup")
