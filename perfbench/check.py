"""The comparison that decides ``correct``: the numbers the timed path's
results are judged by. A cell's ``limits/<cell>.json`` names the numbers it
compares and their limits; the others are computed for the calibration.

Training cells (the first three steps of the train step that the window
then drives, against the reference from the same weights and batches):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (the program's read back from Adam's
  first moment after one step, (1 − β₁)·g: :func:`first_gradient`), over
  the larger of the reference's norm of that leaf and of the median leaf;
  ``grad_gap_median``: the median leaf's such gap;
* ``change_gap``, ``change_gap_median``: the same for the parameters'
  change over the three steps, leaving out leaves whose reference gradient
  is under a thousandth of the median leaf's (they move by round-off alone).

The worst leaf is most often a bias of a few elements, whose gradient is a
sum with heavy cancellation and whose Adam steps flip with the gradient's
sign; the cells compare the median leaf's gaps, which hold still from seed
to seed and separate the control and the faults.

Eval cells (batches of the window drawn from the seed):

* ``err_gap``: the largest relative gap of an error triple's component;
* ``mask_gap``: the largest absolute gap of the weight mask (values in
  [0, 1]).
"""
from __future__ import annotations

import math
import statistics

import torch

ADAM_B1 = 0.9
ROUND_OFF_LEAF = 1e-3  # of the median leaf's reference gradient norm


def _norms(leaves: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keys) -> dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference's norm of
    that leaf and of the median leaf."""
    keys = list(keys)
    if not keys:
        return {}
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def _worst_and_median(gaps: dict[str, float]) -> tuple[float, float]:
    if not gaps:
        return math.nan, math.nan
    return max(gaps.values()), statistics.median(gaps.values())


def first_gradient(first_moment: dict) -> dict:
    """The first step's gradient from Adam's first moment after that step."""
    return {k: v.float() / (1.0 - ADAM_B1) for k, v in first_moment.items()}


def train_numbers(prog_losses, ref_losses, prog_first: dict, ref_first: dict,
                  start: dict, prog_after: dict, ref_after: dict) -> dict[str, float]:
    """The training cell's numbers from the program's and the reference's
    readings (dicts of leaves by name)."""
    if len(prog_losses) != len(ref_losses):
        return dict.fromkeys(("loss_gap", "grad_gap", "grad_gap_median", "change_gap",
                              "change_gap_median"), math.inf)
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_losses, ref_losses))
    g_prog = _norms(prog_first)
    g_ref = _norms(ref_first)
    median_g = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= ROUND_OFF_LEAF * median_g]
    d_prog = _norms({k: prog_after[k].float() - start[k].float() for k in start})
    d_ref = _norms({k: ref_after[k].float() - start[k].float() for k in start})
    grad, grad_median = _worst_and_median(leaf_gaps(g_prog, g_ref, g_ref))
    change, change_median = _worst_and_median(leaf_gaps(d_prog, d_ref, moving))
    return {"loss_gap": loss_gap, "grad_gap": grad, "grad_gap_median": grad_median,
            "change_gap": change, "change_gap_median": change_median}


def eval_numbers(prog: list, ref: list) -> dict[str, float]:
    """prog, ref: [(error triple (3,), mask (B, H, W))] of the same batches;
    no batch at all reads as an infinite gap."""
    if not prog:
        return {"err_gap": math.inf, "mask_gap": math.inf}
    err_gap = mask_gap = 0.0
    for (e_p, m_p), (e_r, m_r) in zip(prog, ref):
        if m_p.shape != m_r.shape:
            return {"err_gap": math.inf, "mask_gap": math.inf}
        e_p, e_r = e_p.double().cpu(), e_r.double().cpu()
        err_gap = max(err_gap, float(((e_p - e_r).abs() / e_r.abs().clamp(min=1e-30)).max()))
        mask_gap = max(mask_gap, float((m_p.float() - m_r.float()).abs().max()))
    return {"err_gap": err_gap, "mask_gap": mask_gap}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number that has a limit finite and within it, {name: {value,
    limit}} of those numbers)."""
    compared = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
