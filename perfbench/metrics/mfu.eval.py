"""The eval step's UNet forward work over the window's time, as a share of
the card's peak for the configuration's activation type
(``work.forward_flops`` a pair)."""
from perfbench import work


def read(run):
    if run.mode != "eval" or run.window_s <= 0:
        return None
    flops = work.forward_flops(run.model["enc_channels"], work.input_size(run.model)) * run.pairs
    return 100.0 * flops / run.window_s / work.PEAK_MATMUL_FLOPS[run.model["dtype"]]
