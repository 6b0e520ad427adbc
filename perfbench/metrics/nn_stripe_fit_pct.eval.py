"""The share of the stripe association's calls (K4) whose tiles all fit the
stripe's budget, over the run: 100 × (1 − the device counters
``nn.stripe_over`` ÷ ``nn.stripe_searched``), the calls in which some item
searched; a call over the budget scans the whole map, at K1's dense cost.
None where no call was counted."""
from perfbench import program


def read(run):
    if run.mode != "eval":
        return None
    r = program.ratio("nn.stripe_over", "nn.stripe_searched")
    return None if r is None else 100.0 * (1.0 - r)
