"""Plain float32 reference of the supervised train step: the frontend
(``frontend.py``), the network in train mode (``model.py``), the batch mean
of the per-row CTC losses (blank the last class, no division by target
length), autograd, and NovoGrad as NVIDIA's implementation steps it:

  * the second moment a scalar a tensor, set to the first step's squared
    gradient norm, later beta2 v + (1 - beta2) |g|^2;
  * g / (sqrt(v) + eps) + weight_decay p, then m = beta1 m + that;
  * p -= lr m, the learning rate read before the step counter rises;
  * lr from the cosine schedule with warm-up restarts: during the warm-up
    min_lr + (max_lr - min_lr) step / warmup_steps.

Random draws (dither, then SpecAugment) come from a generator seeded as
the program's step is, before every step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import frontend
from .model import Net, Tensors, is_stat


def lr_at(step: int, recipe: dict) -> float:
    """The cosine-with-warm-up-restarts learning rate of ``step`` in the
    first cycle."""
    lo, hi, warm = recipe["min_lr"], recipe["learning_rate"], recipe["warmup_steps"]
    cycle = recipe["total_epoch"] * recipe["steps_per_epoch"]
    if step < warm:
        return lo + (hi - lo) * step / max(warm, 1)
    return lo + (hi - lo) * (1 + math.cos(math.pi * (step - warm) / (cycle - warm))) / 2


def ctc_mean(log_probs, out_lens, targets, target_lens, blank: int):
    per_row = F.ctc_loss(log_probs.transpose(0, 1), targets.long(), out_lens.long(),
                         target_lens.long(), blank=blank, reduction="none", zero_infinity=False)
    return per_row.mean()


class RefTrainer:
    """The reference's steps from ``params`` (a dict of float32 tensors,
    BatchNorm statistics included, which train mode does not read)."""

    def __init__(self, cfg: dict, params: Tensors, precision: str = "fp32"):
        self.cfg, self.recipe = cfg, cfg["recipe"]
        self.net = Net(cfg, precision)
        self.params = {k: v.detach().clone() for k, v in params.items() if not is_stat(k)}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v: Dict[str, torch.Tensor] = {}
        self.count = 0

    def loss_and_grads(self, batch: dict, generator):
        r = self.recipe
        aug = (r["freq_mask"], r["time_mask"]) if r.get("augment") else None
        with torch.no_grad():
            feats, percents = frontend.features(batch["waves"], batch["wave_lens"],
                                                self.cfg["frontend"], generator, aug,
                                                self.net.precision)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        log_probs, out_lens = self.net.forward(leaves, feats, percents)
        loss = ctc_mean(log_probs, out_lens, batch["targets"], batch["target_lens"],
                        self.cfg["num_classes"] - 1)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads)), log_probs.detach(), out_lens

    def step(self, batch: dict, generator) -> dict:
        """One step; returns its loss, the per-tensor gradient norms and
        the log-probs with their valid frames."""
        r = self.recipe
        b1, b2 = r["betas"]
        loss, grads, log_probs, out_lens = self.loss_and_grads(batch, generator)
        lr = lr_at(self.count, r)
        norms = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                sq = (g * g).sum()
                norms[k] = sq.sqrt()
                self.v[k] = sq if k not in self.v else b2 * self.v[k] + (1 - b2) * sq
                gn = g / (self.v[k].sqrt() + r["eps"]) + r["weight_decay"] * p
                self.m[k] = b1 * self.m[k] + gn
                self.params[k] = p - lr * self.m[k]
        self.count += 1
        return {"loss": loss, "grad_norms": norms, "log_probs": log_probs, "out_lens": out_lens}


def run_steps(cfg: dict, params: Tensors, batches: List[dict], generators: list,
              precision: str = "fp32") -> dict:
    """The reference's steps over ``batches`` (each with its own seeded
    generator): each step's loss, the first step's gradient norm a tensor,
    its log-probs and valid frames, and each tensor's change over all the
    steps."""
    tr = RefTrainer(cfg, params, precision)
    start = {k: v.clone() for k, v in tr.params.items()}
    losses, first = [], None
    for batch, gen in zip(batches, generators):
        out = tr.step(batch, gen)
        losses.append(float(out["loss"]))
        first = out if first is None else first
    change = {k: (tr.params[k] - start[k]).norm() for k in start}
    return {"losses": losses, "grad_norms": {k: float(v) for k, v in first["grad_norms"].items()},
            "change": {k: float(v) for k, v in change.items()},
            "log_probs": first["log_probs"], "out_lens": first["out_lens"],
            "preds": first["log_probs"].argmax(dim=-1)}
