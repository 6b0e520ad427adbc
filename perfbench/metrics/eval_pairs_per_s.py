"""Pairs localized by ``Trainer.eval_step`` in the window over its seconds."""


def read(run):
    if run.mode != "eval" or run.window_s <= 0:
        return None
    return run.pairs / run.window_s
