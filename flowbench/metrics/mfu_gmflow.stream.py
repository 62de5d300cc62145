"""GMFlow's whole forward's share (%) of the bf16 peak: the reference's
FLOPs per pair at the cell's padded size (``costs_gmflow.model_flops``)
times the pairs done in the measured window, over its seconds."""

from flowbench import costs
from flowbench.costs_gmflow import model_flops


def read(view):
    flops = model_flops(view.config, view.pairs_per_item, view.hw)
    return 100.0 * flops * view.window_items / (view.window_s
                                                * costs.BF16_FLOPS)
