"""Learning-rate schedules (port of ``lightning_asr_tpu/optim/schedules.py``).

``cosine_annealing_warmup_restarts`` is the schedule the recipe trains with
(``train.py`` wires first_cycle_steps = total_epochs · steps_per_epoch,
cycle_mult 2, min_lr 1e-4, warmup 1000, gamma 0.5, stepped per optimizer
step).  It is a pure function of the step count, evaluated in float32 on
the count's device, so the optimizer reads it without a host round trip:
cycle boundaries are precomputed on the host, the cycle index is a
``searchsorted``.

``ReduceLROnPlateau`` is the host-side controller of the plateau recipe
(the trainer writes its lr into ``novograd_with_runtime_lr``'s state).  The
NVIDIA LR-policy zoo is not ported yet.
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
        if cycle_repeats:
            cycle = torch.floor(stepf / first_cycle_steps)
            sic = stepf - cycle * first_cycle_steps
            cycle_len = torch.tensor(float(first_cycle_steps), dtype=torch.float32, device=dev)
        else:
            if dev not in tables:
                tables[dev] = (torch.from_numpy(starts).to(dev), torch.from_numpy(lengths32).to(dev))
            starts_t, lengths_t = tables[dev]
            cycle = torch.clamp(torch.searchsorted(starts_t, stepf.reshape(1), right=True)[0] - 1,
                                0, len(lengths) - 1)
            sic = stepf - starts_t[cycle]
            cycle_len = lengths_t[cycle]
        cur_max = max_lr * torch.pow(torch.tensor(gamma, dtype=torch.float32, device=dev),
                                     cycle.to(torch.float32))
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
