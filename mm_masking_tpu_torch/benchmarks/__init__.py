"""Measurement scripts of the port; the counterparts of the JAX package's
top-level ``benchmarks/`` that have been ported."""
