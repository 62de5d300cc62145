"""The whole forward's share (%) of the bf16 peak: the reference's FLOPs
per pair at the cell's padded size (``costs.model_flops``) times the
pairs done in the measured window, over its seconds."""

from flowbench.harness import mfu


def read(view):
    return mfu(view, train=False)
