"""The benchmark of ``mm_masking_tpu_torch`` on the card: ``python3 perfbench/run.py``."""
