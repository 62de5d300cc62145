"""The whole step's share (%) of the bf16 peak: the reference's forward
and backward FLOPs per pair at the crop (``costs.model_flops``) times the
pairs trained in the measured window, over its seconds."""

from flowbench.harness import mfu


def read(view):
    return mfu(view, train=True)
