"""K4 + K5's share (%) of their roofline in the traced stretch: the bound
time of the stem's forward and backward (``costs.stem_cost``,
``costs.stem_bwd_cost`` without the image gradient) over the profiler's
time of the bf16 stem's kernels: 5 per forward, 13 per backward (the
pack, the forward's four convs again, three input-gradient convs, four
weight-gradient splits and their reduction)."""

from flowbench.harness import roofline

PATTERN = r"::(pack_params|conv3x3|conv3x3_t2|wgrad|reduce_wgrad)\b"


def read(view):
    return roofline(view, PATTERN, ["stem", "stem_bwd"],
                    {"stem": 5, "stem_bwd": 13})
