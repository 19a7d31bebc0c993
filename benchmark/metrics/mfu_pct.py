"""The whole step: the model's operations of one epoch
(``counts.epoch_flops``: dense products forward and backward, aggregations
forward and backward, from the graph's nodes, edges and the layer widths)
over the window's epoch time, over the bf16 peak of the cards used."""
from benchmark.counts import mfu_pct


def read(record):
    if record["epoch_s"] <= 0:
        return None
    return mfu_pct(record["flops_per_epoch"], record["epoch_s"], record["chips"])
