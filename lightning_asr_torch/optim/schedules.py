"""Learning-rate schedules (port of ``lightning_asr_tpu/optim/schedules.py``).

``cosine_annealing_warmup_restarts`` is the schedule the recipe trains with
(``train.py`` wires first_cycle_steps = total_epochs · steps_per_epoch,
cycle_mult 2, min_lr 1e-4, warmup 1000, gamma 0.5, stepped per optimizer
step).  It is a pure function of the step count, evaluated in float32 on
the count's device, so the optimizer reads it without a host round trip:
cycle boundaries are precomputed on the host, the cycle index is a
``searchsorted``.  Its constants go to the device once, on the first
call there: a call uploads nothing, so a captured CUDA graph can hold it.

``ReduceLROnPlateau`` is the host-side controller of the plateau recipe
(the trainer writes its lr into ``novograd_with_runtime_lr``'s state).

The NVIDIA LR-policy zoo (the reference's ``scheduler/lr_policy.py``) is a
set of schedule factories, ``LR_POLICIES``, picked by name with
``get_lr_policy``: each is a linear warmup ``initial_lr·(step + 1) /
(warmup_steps + 1)`` below ``warmup_steps``, then its own body, and past
``total_steps`` a constant (0, or ``min_lr`` for the hold policies), all in
float32 as the JAX package computes them.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import numpy as np
import torch

Schedule = Callable[[Union[int, torch.Tensor]], torch.Tensor]


def cosine_annealing_warmup_restarts(
    first_cycle_steps: int,
    cycle_mult: float = 1.0,
    max_lr: float = 0.1,
    min_lr: float = 0.001,
    warmup_steps: int = 0,
    gamma: float = 1.0,
    max_total_steps: int = 1 << 40,
) -> Schedule:
    """lr(step): with c the cycle index and s the step within the cycle,
      s < warmup:  min_lr + (max_lr·gamma^c - min_lr) · s / warmup
      else:        min_lr + (max_lr·gamma^c - min_lr) ·
                   (1 + cos(π·(s - warmup)/(cycle_len - warmup))) / 2
    Cycle lengths grow as len_{c+1} = (len_c - warmup)·cycle_mult + warmup.
    """
    if warmup_steps >= first_cycle_steps:
        raise ValueError(f"warmup_steps {warmup_steps} must be < first_cycle_steps "
                         f"{first_cycle_steps}")
    lengths = [first_cycle_steps]
    while sum(lengths) < max_total_steps and len(lengths) < 64:
        lengths.append(int((lengths[-1] - warmup_steps) * cycle_mult) + warmup_steps)
    starts = np.concatenate([[0], np.cumsum(lengths)])[:-1].astype(np.float32)
    lengths32 = np.asarray(lengths, np.float32)
    cycle_repeats = cycle_mult == 1.0
    tables = {}

    def schedule(step) -> torch.Tensor:
        stepf = torch.as_tensor(step).to(torch.float32)
        dev = stepf.device
        if dev not in tables:
            tables[dev] = [torch.tensor(v, dtype=torch.float32).to(dev)
                           for v in (starts, lengths32, float(first_cycle_steps), gamma)]
        starts_t, lengths_t, first_len, gamma_t = tables[dev]
        if cycle_repeats:
            cycle = torch.floor(stepf / first_cycle_steps)
            sic = stepf - cycle * first_cycle_steps
            cycle_len = first_len
        else:
            # indexed by a (1,) tensor: a 0-d index is read back to the host
            cycle = torch.clamp(torch.searchsorted(starts_t, stepf.reshape(1), right=True) - 1,
                                0, len(lengths) - 1)
            sic = stepf - starts_t[cycle][0]
            cycle_len = lengths_t[cycle][0]
            cycle = cycle[0]
        cur_max = max_lr * torch.pow(gamma_t, cycle.to(torch.float32))
        warm = min_lr + (cur_max - min_lr) * sic / max(warmup_steps, 1)
        cos = min_lr + (cur_max - min_lr) * (
            1.0 + torch.cos(math.pi * (sic - warmup_steps) / (cycle_len - warmup_steps))) / 2.0
        return torch.where(sic < warmup_steps, warm, cos).to(torch.float32)

    return schedule


class ReduceLROnPlateau:
    """Host-side plateau controller with torch's semantics, mode 'min'.

    Call ``step(metric)`` after each validation and read ``lr``.  Defaults
    are the reference's train-100 recipe: factor 0.1, patience 10, relative
    threshold 1e-4, cooldown 3, min_lr 1e-4."""

    def __init__(self, init_lr: float, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel", cooldown: int = 3,
                 min_lr: float = 1e-4):
        if factor >= 1.0:
            raise ValueError("factor must be < 1.0")
        self.init_lr = init_lr
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.best = math.inf

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    @property
    def scale(self) -> float:
        return self.lr / self.init_lr

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in ("lr", "cooldown_counter", "num_bad_epochs", "best")}

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


def _with_warmup(body, initial_lr, warmup_steps, total_steps, after_total) -> Schedule:
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = initial_lr * (step + 1.0) / (warmup_steps + 1.0)
        out = torch.where(step < warmup_steps, warm, torch.as_tensor(body(step), dtype=torch.float32))
        if total_steps is not None:
            out = torch.where(step > total_steps, torch.full_like(out, after_total), out)
        return out
    return schedule


def warmup_policy(initial_lr, warmup_steps=0, total_steps=None, warmup_ratio=None) -> Schedule:
    if warmup_ratio is not None:
        warmup_steps = int(warmup_ratio * total_steps)
    return _with_warmup(lambda s: torch.full_like(s, initial_lr), initial_lr, warmup_steps,
                        total_steps, 0.0)


def warmup_hold_policy(initial_lr, warmup_steps=0, hold_steps=0, total_steps=None,
                       min_lr=0.0) -> Schedule:
    return _with_warmup(lambda s: torch.full_like(s, initial_lr), initial_lr, warmup_steps,
                        total_steps, min_lr)


def square_annealing(initial_lr, total_steps, warmup_steps=0, min_lr=1e-5) -> Schedule:
    def body(step):
        span = total_steps - warmup_steps
        mult = ((span - (step - warmup_steps)) / span) ** 2
        return torch.clamp(initial_lr * mult, min=min_lr)
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def squareroot_annealing(initial_lr, total_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    def body(step):
        mult = torch.sqrt(torch.clamp((total_steps - step) / total_steps, min=0.0))
        return torch.clamp(initial_lr * mult, min=min_lr)
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def cosine_annealing(initial_lr, total_steps, warmup_steps=0, min_lr=0.0) -> Schedule:
    if initial_lr < min_lr:
        raise ValueError("initial lr below minimum lr")

    def body(step):
        span = total_steps - warmup_steps
        mult = 0.5 * (1.0 + torch.cos(math.pi * (step - warmup_steps) / span))
        return (initial_lr - min_lr) * mult + min_lr
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def warmup_annealing(initial_lr, total_steps, warmup_steps=0) -> Schedule:
    def body(step):
        progress = step / total_steps
        warmup_ratio = warmup_steps / total_steps
        return initial_lr * torch.clamp((progress - 1.0) / (warmup_ratio - 1.0), min=0.0)
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def inverse_squareroot_annealing(initial_lr, total_steps, warmup_steps=0) -> Schedule:
    def body(step):
        return initial_lr / torch.sqrt((step + 1.0) / (warmup_steps + 1.0))
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def polynomial_decay_annealing(initial_lr, total_steps, warmup_steps=0, min_lr=0.0,
                               power=1.0) -> Schedule:
    def body(step):
        s = torch.clamp(step - warmup_steps, max=total_steps - warmup_steps)
        p = s / (total_steps - warmup_steps)
        return (initial_lr - min_lr) * torch.pow(1.0 - p, power) + min_lr
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, 0.0)


def polynomial_hold_decay_annealing(initial_lr, total_steps, warmup_steps=0, hold_steps=0,
                                    min_lr=0.0, power=1.0) -> Schedule:
    hold_end = warmup_steps + hold_steps

    def body(step):
        span = total_steps - max(warmup_steps, hold_end)
        p = torch.clamp(step - hold_end, 0.0, span) / span
        decay = (initial_lr - min_lr) * torch.pow(1.0 - p, power) + min_lr
        return torch.where(step < hold_end, torch.full_like(decay, initial_lr), decay)
    return _with_warmup(body, initial_lr, warmup_steps, total_steps, min_lr)


LR_POLICIES = {
    "WarmupPolicy": warmup_policy,
    "WarmupHoldPolicy": warmup_hold_policy,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": squareroot_annealing,
    "CosineAnnealing": cosine_annealing,
    "WarmupAnnealing": warmup_annealing,
    "InverseSquareRootAnnealing": inverse_squareroot_annealing,
    "PolynomialDecayAnnealing": polynomial_decay_annealing,
    "PolynomialHoldDecayAnnealing": polynomial_hold_decay_annealing,
    "CosineAnnealingWarmupRestarts": cosine_annealing_warmup_restarts,
}


def get_lr_policy(name: str, **kwargs) -> Schedule:
    """The schedule of policy ``name`` (a key of ``LR_POLICIES``) built
    from ``kwargs``."""
    if name not in LR_POLICIES:
        raise ValueError(f"{name} is not a supported lr policy. Supported: {sorted(LR_POLICIES)}")
    return LR_POLICIES[name](**kwargs)
