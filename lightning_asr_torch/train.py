"""Supervised CTC training, the port's counterpart of the repository's
``train.py`` over the shared ``conf/`` tree:

    python -m lightning_asr_torch.train train.learning_rate=1e-2 \\
        data.train_manifest='["a.json"]' [--device cpu] [--config conf/conf.yaml]

Builds the datamodule, the model (seeded weights), NovoGrad with cosine
warmup restarts (or the plateau recipe, ``train.scheduler=reduce_on_plateau``),
gradient clipping, then runs ``Trainer.fit`` and a test pass.  It runs on
the card unless ``--device cpu`` asks for the CPU, and raises without one.

Data parallelism (``parallel/``): one process a card, each with its rows of
every global batch of ``train_batch_size`` rows.  Under a launcher
(``torchrun --nproc_per_node=N [--nnodes=M ...] -m lightning_asr_torch.train
...``) every process joins the group its environment describes.  Started
alone, it starts ``train.n_devices`` processes itself (null: one a visible
card; 1: this process alone), this one being rank 0, as the reference's
Lightning DDP launcher does; on the CPU (``--device cpu``) ``n_devices`` is
the count of gloo processes.  More processes than cards share the cards
over gloo (``parallel/distributed.py``, the backend rule).
``train.num_nodes`` > 1 needs a launcher on every node, and
``train.dist_timeout_s`` (default 1800) ends a run whose collective hangs.
Rank 0 alone prints, logs and writes checkpoints.

Tensor parallelism (``train.tp`` = T > 1, ``parallel/tp.py``): the
processes form a (N / T) x T layout, N = ``train.n_devices`` (or the
launcher's world), which must divide by T; the T ranks of a model group
split the conv trunk's channels and hold the same rows, the N / T model
groups split the rows.  The optimizer is the per-tensor NovoGrad there, as
in the JAX package's ``train.py``; checkpoints hold whole tensors, so a
data-parallel run (or one process) resumes from a tensor-parallel
checkpoint and the other way round.  On one card, ``python -m
lightning_asr_torch.train train.tp=2 train.n_devices=2`` runs 2 ranks
sharing it over gloo.

The JAX package picks its opt-in kernels by environment; here they are read
once, in this entry point, and become ``build_model`` arguments:
``LASR_LSTM_FUSED_BIDIR=1`` -> ``fuse_directions=True`` (K7, K8),
``LASR_SEPCONV_PALLAS=1`` -> ``conv_kernel="sepconv"`` (K9, K10),
``LASR_DW_WGRAD_PALLAS=1`` -> ``conv_kernel="dw_wgrad"`` (K11).
The resolved config is printed as JSON.

The encoder is ``model.encoder`` (``conf/conf.yaml``'s list, and the port's
own ``conformer_ctc_large``, which wants ``data.n_mels=80
data.win_length=400``); the model's input width follows ``data.n_mels``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import torch

from .data.datamodule import AsrDataModule
from .models.quartznet import build_model, reset_parameters
from .ops.frontend import MelFrontendConfig
from .optim import (ReduceLROnPlateau, cosine_annealing_warmup_restarts, novograd,
                    novograd_with_runtime_lr, with_gradient_clipping)
from .parallel import distributed
from .training.loggers import init_loggers
from .training.trainer import Trainer
from .utils.config import load_config
from .utils.logging import get_logger, seed_everything, setup_run_dir

DEFAULT_CONFIG = Path(__file__).resolve().parents[1] / "conf" / "conf.yaml"
_COMPUTE_DTYPES = {"bf16": torch.bfloat16, "f32": None}


def kernel_switches(environ=os.environ) -> dict:
    """``build_model`` arguments for the JAX package's kernel switches."""
    on = lambda name: environ.get(name, "0") == "1"  # noqa: E731
    # with both conv switches on, the reference's blocks take the sepconv
    # branch first and never reach the depthwise-wgrad one
    conv_kernel = "sepconv" if on("LASR_SEPCONV_PALLAS") else (
        "dw_wgrad" if on("LASR_DW_WGRAD_PALLAS") else None)
    return {"fuse_directions": on("LASR_LSTM_FUSED_BIDIR"), "conv_kernel": conv_kernel}


def frontend_config(data_cfg) -> MelFrontendConfig:
    """The training frontend: ``data.frontend_precision`` (default
    "default"), ``data.n_mels`` (64) and ``data.win_length`` (320 samples),
    the rest ``MelFrontendConfig``'s defaults.  The model's input width is
    ``n_mels``."""
    return MelFrontendConfig(precision=data_cfg.get("frontend_precision", "default"),
                             n_mels=int(data_cfg.get("n_mels", 64)),
                             win_length=int(data_cfg.get("win_length", 320)))


def main(argv=None) -> dict:
    """Train as configured; returns {"trainer", "state", "test"} (rank 0's
    where this process started the other ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--config", default=str(DEFAULT_CONFIG))
    args, rest = ap.parse_known_args(argv)
    bad = [a for a in rest if "=" not in a]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    cfg = load_config(args.config, rest)
    return distributed.launch("lightning_asr_torch.train", argv, cfg.train, args.device,
                              lambda device: _train(cfg, device),
                              tp=int(cfg.train.get("tp", 1) or 1))


def _train(cfg, device: torch.device) -> dict:
    primary = distributed.is_primary()
    log = get_logger("lightning_asr_torch.train")
    for name in ("lightning_asr_torch", log.name):     # the other ranks say only what is wrong
        logging.getLogger(name).setLevel(logging.INFO if primary else logging.WARNING)
    if primary:
        print(cfg.to_json(), flush=True)
    data_cfg, train_cfg, model_cfg = cfg.data, cfg.train, cfg.model
    seed = int(train_cfg.get("seed", 0))
    seed_everything(seed)

    dm = AsrDataModule(
        train_manifest=data_cfg.get("train_manifest"),
        dev_manifest=data_cfg.get("val_manifest"),
        test_manifest=data_cfg.get("test_manifest"),
        labels=data_cfg.get("labels"),
        train_bs=train_cfg.get("train_batch_size", 32),
        dev_bs=train_cfg.get("dev_batch_size", 32),
        train_max_duration=data_cfg.get("train_max_duration", 16.7),
        dev_max_duration=data_cfg.get("dev_max_duration", 40),
        seed=seed,
        bucket_seconds=data_cfg.get("bucket_seconds"),
        prefetch_depth=data_cfg.get("prefetch_depth", 2),
        cache=data_cfg.get("cache"),
        cache_dir=data_cfg.get("cache_dir"),
        wire=data_cfg.get("wire", "int16"),
    )
    frontend = frontend_config(data_cfg)
    model = build_model(
        num_classes=dm.vocab.num_classes,
        encoder=model_cfg.get("encoder", "quartznet12_context"),
        in_c=frontend.n_mels,
        drop_rate=model_cfg.get("drop_rate", 0.0),
        mask=model_cfg.get("mask", True),
        dtype=_COMPUTE_DTYPES[model_cfg.get("compute_dtype", "bf16")],
        **kernel_switches(),
    )
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)

    total_epoch = train_cfg.get("total_epoch", 100)
    lr = float(train_cfg.get("learning_rate", 1e-2))
    steps_per_epoch = dm.steps_per_epoch()
    log.info("steps per epoch: %d", steps_per_epoch)
    betas = tuple(train_cfg.get("novograd_betas", (0.8, 0.5)))
    wd = float(train_cfg.get("weight_decay", 1e-3))
    # the fused flat buffer has no channel structure to split (JAX train.py)
    fused = distributed.model_size() == 1
    plateau = schedule = None
    if train_cfg.get("scheduler", "cosine_warmup_restarts") == "cosine_warmup_restarts":
        schedule = cosine_annealing_warmup_restarts(
            first_cycle_steps=max(total_epoch * steps_per_epoch, 2),
            cycle_mult=train_cfg.get("cycle_mult", 2), max_lr=lr,
            min_lr=float(train_cfg.get("min_lr", 1e-4)),
            warmup_steps=train_cfg.get("warmup_steps", 1000),
            gamma=train_cfg.get("lr_gamma", 0.5))
        optimizer = novograd(schedule, betas=betas, weight_decay=wd, fused=fused)
    else:                                        # the reduce_on_plateau recipe
        plateau = ReduceLROnPlateau(init_lr=lr)
        optimizer = novograd_with_runtime_lr(lr, betas=betas, weight_decay=wd, fused=fused)
    optimizer = with_gradient_clipping(optimizer, float(train_cfg.get("gradient_clip_val", 0) or 0),
                                       train_cfg.get("gradient_clip_algorithm", "value"))

    # rank 0's run directory (a templated one names the time) on every rank
    run_dir = Path(distributed.broadcast_str(
        str(setup_run_dir(cfg, default="outputs/run")) if primary else ""))
    log.info("run dir: %s", run_dir)
    trainer = Trainer(
        model=model,
        optimizer=optimizer,
        datamodule=dm,
        total_epochs=total_epoch,
        check_val_every_n_epoch=train_cfg.get("check_val_every_n_epoch", 1),
        log_every_n_steps=train_cfg.get("log_every_n_steps", 10),
        run_dir=run_dir,
        loggers=init_loggers(cfg.get("loggers"), run_dir) if primary else None,
        lr_schedule=schedule,
        frontend=frontend,
        augment=data_cfg.get("augment", True),
        freq_mask=data_cfg.get("freq_mask", 27),
        time_mask=data_cfg.get("time_mask", 0.07),
        seed=seed,
        plateau=plateau,
        device_cache=train_cfg.get("device_cache", False),
        accumulate_grad_batches=int(train_cfg.get("accumulate_grad_batches", 1)),
        limit_train_batches=train_cfg.get("limit_train_batches", 1.0),
        limit_val_batches=train_cfg.get("limit_val_batches", 1.0),
        hparams={
            "labels": dm.vocab.labels,
            "use_cer": dm.vocab.use_cer,
            "encoder": model_cfg.get("encoder", "quartznet12_context"),
            "in_c": frontend.n_mels,
            "drop_rate": model_cfg.get("drop_rate", 0.0),
            "mask": model_cfg.get("mask", True),
            "learning_rate": lr,
            "weight_decay": wd,
            "total_epoch": total_epoch,
        },
    )
    state = trainer.fit(resume=train_cfg.get("checkpoint"))
    test = trainer.test(state)
    trainer.loggers.finalize()
    return {"trainer": trainer, "state": state, "test": test}


if __name__ == "__main__":
    main()
