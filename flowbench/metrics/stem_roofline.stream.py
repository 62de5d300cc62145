"""K4's share (%) of its roofline in the traced stretch: the bound time of
the stem's forward of both frames (``costs.stem_cost``) over the
profiler's time of the bf16 stem's kernels, 5 per call (the weights'
pack and four convs on the tensor-core tile)."""

from flowbench.harness import roofline

PATTERN = r"::(pack_params|conv3x3)\b"


def read(view):
    return roofline(view, PATTERN, ["stem"], {"stem": 5})
