"""K8's share (%) of its roofline in the traced stretch: the bound time of
the all-pairs pyramid of each pair at its shape
(``costs_allpairs.pyramid_cost``) over the profiler's time of the
pyramid kernel, one a pair."""

from flowbench.costs_allpairs import roofline


def read(view):
    return roofline(view, "pyramid")
