"""The share of a dense scan that the stripe association (K4) scans, over
the run: 100 × the device counters ``nn.blocks_scanned`` (Σ the map blocks
of each searching tile's run) ÷ ``nn.blocks_dense`` (the searching tiles ×
the map's blocks). None where no call was counted, or where the program
does not count blocks."""
from perfbench import program


def read(run):
    if run.mode != "train":
        return None
    r = program.ratio("nn.blocks_scanned", "nn.blocks_dense")
    return None if r is None else 100.0 * r
