"""The comparison that decides ``correct``: the numbers a run's outputs give
against the plain reference's, each held to its limit (``h100_bench/limits/
<cell>.json``).

Training (the first steps of the timed path, against the reference's steps
on the same batches, draws and weights):

  * ``loss_gap``: the largest |program - reference| / |reference| over the
    steps' losses;
  * ``pred_gap_mean``: the first step's frame tokens (the step's ``preds``):
    a frame's gap is the amount by which the reference's log-prob of the
    program's token lies below the reference's best; the mean over the
    valid frames;
  * a tensor's gradient gap: the first step's gradient norm (the
    program's from its optimizer's second moment after one step), |program
    - reference| against the larger of the reference's norm of that
    tensor and of the median tensor; its change gap: the same of the
    tensor's change over the steps.  ``grad_gap.<group>`` and
    ``change_gap.<group>`` are the worst tensor's of each group of the
    network (``model.param_groups``: the stem, the trunk's blocks, the
    context branch, the head), ``grad_gap`` and ``change_gap`` the worst of
    all, ``grad_gap_median`` and ``change_gap_median`` the median tensor's.

Tensors whose reference gradient is under a thousandth of the median
tensor's (round-off alone moves them under NovoGrad) are left out.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path
from typing import Dict

import torch

ROUND_OFF_SHARE = 1e-3
LIMITS = Path(__file__).resolve().parents[1] / "limits"


def limits_for(cell: str) -> Dict[str, float]:
    """The cell's limits, {number: limit}, from ``limits/<cell>.json``."""
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def frame_gaps(ref_lp: torch.Tensor, frames, tokens: torch.Tensor) -> torch.Tensor:
    """Every valid frame's gap: the reference's best log-prob less its
    log-prob of ``tokens``, over the rows of ``tokens`` (the first rows of
    ``ref_lp``)."""
    out = []
    for r in range(tokens.shape[0]):
        n = int(frames[r])
        lp, tok = ref_lp[r, :n], tokens[r, :n].to(device=ref_lp.device, dtype=torch.int64)
        out.append(lp.max(dim=-1).values - lp.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)


def tensor_gaps(prog: dict, ref: dict):
    """({tensor: gradient gap}, {tensor: change gap}, the tensors left out)."""
    gref = ref["grad_norms"]
    med_g = statistics.median(gref.values())
    counted = [k for k, v in gref.items() if v >= ROUND_OFF_SHARE * med_g]
    med_c = statistics.median(ref["change"][k] for k in counted)
    grad = {k: abs(prog["grad_norms"][k] - gref[k]) / max(gref[k], med_g) for k in counted}
    change = {k: abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
              for k in counted}
    return grad, change, sorted(set(gref) - set(counted))


def _top(gaps: dict, n: int = 3) -> list:
    return [[k, gaps[k]] for k in sorted(gaps, key=gaps.get, reverse=True)[:n]]


def train_gaps(prog: dict, ref: dict, groups: Dict[str, str]) -> dict:
    """``prog``/``ref``: {"losses": [...], "grad_norms": {name: norm},
    "change": {name: norm}, "preds": the first step's frame tokens}, the
    reference's with the first step's "log_probs" and "out_lens";
    ``groups``: {tensor: its group}.  The numbers above, each step's loss
    gap, the three tensors with the largest gaps and those left out."""
    grad, change, left_out = tensor_gaps(prog, ref)
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    pred = frame_gaps(ref["log_probs"], ref["out_lens"], prog["preds"])
    out = {"loss_gap": max(losses), "pred_gap_mean": float(pred.mean()),
           "grad_gap": max(grad.values()), "change_gap": max(change.values()),
           "grad_gap_median": statistics.median(grad.values()),
           "change_gap_median": statistics.median(change.values())}
    for g in sorted(set(groups[k] for k in grad)):
        out[f"grad_gap.{g}"] = max(v for k, v in grad.items() if groups[k] == g)
        out[f"change_gap.{g}"] = max(v for k, v in change.items() if groups[k] == g)
    out.update(step_loss_gaps=losses, grad_top=_top(grad), change_top=_top(change),
               left_out=left_out)
    return out


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> list:
    """Each number the cell's limits name, with its limit, and whether it
    holds (the other numbers are printed beside them, not compared)."""
    return [{"name": k, "value": numbers[k], "limit": limits[k],
             "ok": bool(numbers[k] <= limits[k])} for k in limits]
