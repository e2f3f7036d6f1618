"""What the benchmark takes from the program under test: the port's train
step, built from a configuration file as the port's entry point builds it
(``lightning_asr_torch/train.py``).  The weights are the benchmark's (drawn
from the seed), handed in as a state dict."""

from __future__ import annotations

import torch

from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd, \
    with_gradient_clipping
from lightning_asr_torch.training.steps import create_train_state, make_train_step

_DTYPES = {"bf16": torch.bfloat16, "f32": None}


def frontend_config(cfg: dict) -> MelFrontendConfig:
    return MelFrontendConfig(**cfg["frontend"])


def model_of(cfg: dict, params: dict, device) -> torch.nn.Module:
    """``build_model`` as the configuration gives it, with ``params``."""
    bm = cfg["build_model"]
    model = build_model(num_classes=cfg["num_classes"], encoder=bm["encoder"],
                        drop_rate=bm["drop_rate"], mask=bm["mask"],
                        dtype=_DTYPES[bm["compute_dtype"]], conv_kernel=bm["conv_kernel"],
                        fuse_directions=bm["fuse_directions"])
    model.load_state_dict({k: v.detach().cpu() for k, v in params.items()}, strict=True)
    return model.to(device)


def train_step(cfg: dict, params: dict, device):
    """(train_step, state) of the recipe: fused NovoGrad with the cosine warm-up schedule and clipping as
    ``train.py`` wraps it, and ``make_train_step`` with SpecAugment."""
    r = cfg["recipe"]
    model = model_of(cfg, params, device)
    schedule = cosine_annealing_warmup_restarts(
        first_cycle_steps=max(r["total_epoch"] * r["steps_per_epoch"], 2),
        cycle_mult=r["cycle_mult"], max_lr=r["learning_rate"], min_lr=r["min_lr"],
        warmup_steps=r["warmup_steps"], gamma=r["lr_gamma"])
    optimizer = with_gradient_clipping(
        novograd(schedule, betas=tuple(r["betas"]), weight_decay=r["weight_decay"],
                 fused=r["optimizer"] == "novograd_fused"),
        float(r["gradient_clip_val"]), "value")
    step = make_train_step(model, optimizer, cfg["num_classes"] - 1,
                           frontend=frontend_config(cfg), augment=r["augment"],
                           freq_mask=r["freq_mask"], time_mask=r["time_mask"])
    return step, create_train_state(model, optimizer)
