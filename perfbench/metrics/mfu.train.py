"""The train step's UNet work over the window's time, as a share of the
card's peak for the configuration's activation type: per pair the forward,
dx and dk of every 3x3 conv and of the head (``work.train_flops``), times
the pairs trained, over the window's seconds, over the tensor cores' peak
(``work.PEAK_MATMUL_FLOPS``). Work outside the UNet (the ICP, the loss, Adam)
is not counted."""
from perfbench import work


def read(run):
    if run.mode != "train" or run.window_s <= 0:
        return None
    flops = work.train_flops(run.model["enc_channels"], work.input_size(run.model)) * run.pairs
    return 100.0 * flops / run.window_s / work.PEAK_MATMUL_FLOPS[run.model["dtype"]]
