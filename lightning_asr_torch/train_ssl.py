"""SSL-feature CTC training with pseudo-labeling, the port's counterpart of
the repository's ``train_ssl.py`` over ``conf/ssl-conf.yaml``:

    python -m lightning_asr_torch.train_ssl ssl.feature_folder=feats/ \\
        data.train_manifest='["a.json"]' data.pseudo_manifest=unlabeled.json \\
        [--device cpu] [--config conf/ssl-conf.yaml]

wav2vec2 features (offline ``{stem}.pkl`` pickles in ``ssl.feature_folder``,
or ``ssl.on_the_flying=true`` for a ``Wav2Vec2Extractor`` in the loader) ->
``feature_mapping`` 512 -> 64 -> the encoder, with the epoch-gated
pseudo-labeling loop (``SSLTrainer``).  ``ssl.retrain=true`` trains the
wav2vec2 feature encoder with the model from raw waves instead
(``SSLRetrainAsrModel``; ``ssl.hf_encoder_state_dict`` warm-starts it from a
local HuggingFace checkpoint file).  It runs on the card unless
``--device cpu`` asks for the CPU, and raises without one; the kernel
switches are read as ``python -m lightning_asr_torch.train`` reads them.
The resolved config is printed as JSON.

Data parallelism, as the JAX entry point trains over a ``data`` mesh of
``train.n_devices`` devices of one host: one process a card, started as
``python -m lightning_asr_torch.train`` starts them
(``parallel/distributed.py::launch``): ``train.n_devices`` local ranks (null:
one a visible card; on the CPU the count of gloo processes, 1 by default),
or the ranks of a launcher on this host (``torchrun --nproc_per_node=N -m
lightning_asr_torch.train_ssl ...``).  ``train.num_nodes`` > 1 is refused:
the JAX entry point runs in one process on one host.  Every rank assembles
its rows of each global batch, the steps take the global BatchNorm
statistics and draws and average the gradients, and the pseudo-label pool
is decoded by all the ranks and gathered (``SSLTrainer``).  Rank 0 alone
prints, logs and writes checkpoints; the retrain warm start reaches every
rank as rank 0's state.  There is no ``train.tp``: the JAX SSL entry points
read none.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pathlib import Path
from typing import Callable

import torch

from .data.datamodule import AsrDataModule
from .models.quartznet import build_model, reset_parameters
from .optim import cosine_annealing_warmup_restarts, novograd
from .parallel import distributed
from .ssl_codec.extractor import DEFAULT_MODEL
from .ssl_codec.retrain import SSLRetrainAsrModel, load_hf_encoder_into_params
from .ssl_codec.ssl_datamodule import SSLDataModule
from .train import _COMPUTE_DTYPES, kernel_switches
from .training.loggers import init_loggers
from .training.retrain_trainer import SSLRetrainTrainer
from .training.ssl_trainer import SSLTrainer
from .utils.config import load_config
from .utils.logging import get_logger, seed_everything, setup_run_dir

DEFAULT_CONFIG = Path(__file__).resolve().parents[1] / "conf" / "ssl-conf.yaml"
LOG_NAME = "lightning_asr_torch.train_ssl"


def launch(module: str, argv, description: str, body: Callable) -> dict:
    """Parse ``--device``, ``--config`` and key=value overrides and run
    ``body(config, device)`` as every rank of the run of ``module`` on this
    host (``distributed.launch``); rank 0 prints the resolved config, the
    other ranks log only what is wrong."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--config", default=str(DEFAULT_CONFIG))
    args, rest = ap.parse_known_args(argv)
    bad = [a for a in rest if "=" not in a]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    cfg = load_config(args.config, rest)

    def run(device):
        primary = distributed.is_primary()
        get_logger(LOG_NAME)
        for name in ("lightning_asr_torch", LOG_NAME):
            logging.getLogger(name).setLevel(logging.INFO if primary else logging.WARNING)
        if primary:
            print(cfg.to_json(), flush=True)
        seed_everything(int(cfg.get("train.seed", 0)))
        return body(cfg, device)

    return distributed.launch(module, argv, cfg.train, args.device, run, one_host=True)


def data_kwargs(cfg) -> dict:
    """The datamodule arguments every SSL entry point shares."""
    data_cfg, train_cfg = cfg.data, cfg.train
    return dict(train_manifest=data_cfg.get("train_manifest"),
                dev_manifest=data_cfg.get("val_manifest"),
                test_manifest=data_cfg.get("test_manifest"),
                labels=data_cfg.get("labels"),
                train_bs=train_cfg.get("train_batch_size", 32),
                dev_bs=train_cfg.get("dev_batch_size", 32),
                train_max_duration=data_cfg.get("train_max_duration", 16.7),
                dev_max_duration=data_cfg.get("dev_max_duration", 40),
                seed=int(cfg.get("train.seed", 0)),
                bucket_seconds=data_cfg.get("bucket_seconds"),
                prefetch_depth=data_cfg.get("prefetch_depth", 2),
                pseudo_manifest=data_cfg.get("pseudo_manifest"))


def feature_kwargs(cfg, device) -> dict:
    """Where the SSL datamodules find their features."""
    ssl_cfg = cfg.ssl
    on_the_fly = bool(ssl_cfg.get("on_the_flying"))
    return dict(ssl_folder=None if on_the_fly else ssl_cfg.get("feature_folder"),
                on_the_fly=on_the_fly, ssl_model_name=ssl_cfg.get("model_name", DEFAULT_MODEL),
                extractor_device=device)


def trainer_kwargs(cfg, model, device, dm, run_default: str, hparams: dict) -> dict:
    """The model's seeded weights on ``device``, the schedule, fused
    NovoGrad and the trainer arguments every SSL entry point shares: rank
    0's run directory on every rank, loggers on rank 0 alone."""
    train_cfg, ssl_cfg = cfg.train, cfg.ssl
    seed = int(cfg.get("train.seed", 0))
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    total_epoch = train_cfg.get("total_epoch", 400)
    schedule = cosine_annealing_warmup_restarts(
        first_cycle_steps=max(total_epoch * dm.steps_per_epoch(), 2),
        cycle_mult=train_cfg.get("cycle_mult", 1),
        max_lr=float(train_cfg.get("learning_rate", 1e-2)),
        min_lr=float(train_cfg.get("min_lr", 1e-4)),
        warmup_steps=train_cfg.get("warmup_steps", 1000),
        gamma=train_cfg.get("lr_gamma", 0.1))
    optimizer = novograd(schedule, betas=tuple(train_cfg.get("novograd_betas", (0.8, 0.5))),
                         weight_decay=float(train_cfg.get("weight_decay", 1e-3)), fused=True)
    primary = distributed.is_primary()
    run_dir = Path(distributed.broadcast_str(
        str(setup_run_dir(cfg, default=run_default)) if primary else ""))
    return dict(model=model, optimizer=optimizer, datamodule=dm, total_epochs=total_epoch,
                check_val_every_n_epoch=train_cfg.get("check_val_every_n_epoch", 1),
                log_every_n_steps=train_cfg.get("log_every_n_steps", 10), run_dir=run_dir,
                loggers=init_loggers(cfg.get("loggers"), run_dir) if primary else None,
                lr_schedule=schedule,
                seed=seed, pseudo_start_epoch=ssl_cfg.get("pseudo_start_epoch", 300),
                pseudo_every_n_epochs=ssl_cfg.get("pseudo_every_n_epochs", 7),
                pseudo_confidence_threshold=ssl_cfg.get("pseudo_confidence_threshold", 0.01),
                hparams={"labels": dm.vocab.labels, "use_cer": dm.vocab.use_cer,
                         "encoder": cfg.model.get("encoder", "quartznet12_context"), **hparams})


def fit_and_test(trainer, resume=None, initial_state=None) -> dict:
    state = trainer.fit(resume=resume, initial_state=initial_state)
    test = trainer.test(state)
    trainer.loggers.finalize()
    return {"trainer": trainer, "state": state, "test": test}


def main(argv=None) -> dict:
    """Train as configured; returns {"trainer", "state", "test"} (rank 0's
    where this process started the other ranks)."""
    return launch("lightning_asr_torch.train_ssl", argv, __doc__.splitlines()[0], _main)


def _main(cfg, device) -> dict:
    if cfg.ssl.get("retrain"):
        return _main_retrain(cfg, device)
    model_cfg = cfg.model
    dm = SSLDataModule(**data_kwargs(cfg), **feature_kwargs(cfg, device))
    model = build_model(
        num_classes=dm.vocab.num_classes,
        encoder=model_cfg.get("encoder", "quartznet12_context"),
        in_c=64, feature_in=512,
        drop_rate=model_cfg.get("drop_rate", 0.0),
        mask=model_cfg.get("mask", True),
        dtype=_COMPUTE_DTYPES[model_cfg.get("compute_dtype", "bf16")],
        **kernel_switches())
    trainer = SSLTrainer(**trainer_kwargs(
        cfg, model, device, dm, "outputs/ssl-run",
        {"feature_in": 512, "in_c": 64, "drop_rate": model_cfg.get("drop_rate", 0.0),
         "mask": model_cfg.get("mask", True),
         "ssl_model_name": cfg.ssl.get("model_name", DEFAULT_MODEL)}))
    return fit_and_test(trainer, cfg.train.get("checkpoint"))


def _main_retrain(cfg, device) -> dict:
    """``ssl.retrain=true``: raw-wave batches, the wav2vec2 feature encoder
    trained with the model."""
    model_cfg, ssl_cfg = cfg.model, cfg.ssl
    norm = ssl_cfg.get("feat_extract_norm", "layer")
    # the crop would move the wav2vec2 frames of an utterance from epoch to epoch
    dm = AsrDataModule(**data_kwargs(cfg), crop=False)
    model = SSLRetrainAsrModel(
        num_classes=dm.vocab.num_classes,
        encoder_name=model_cfg.get("encoder", "quartznet12_context"),
        drop_rate=model_cfg.get("drop_rate", 0.0),
        mask=model_cfg.get("mask", True),
        feat_extract_norm=norm, conv_bias=ssl_cfg.get("conv_bias", True),
        **kernel_switches())
    trainer = SSLRetrainTrainer(**trainer_kwargs(cfg, model, device, dm, "outputs/ssl-retrain",
                                                 {"ssl_retrain": True}))
    initial_state = None
    init_ckpt = ssl_cfg.get("hf_encoder_state_dict")
    if init_ckpt:
        sd = torch.load(init_ckpt, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        state = trainer.init_state()
        params = load_hf_encoder_into_params(state.params, sd, norm=norm)
        # the fused NovoGrad state keeps a master copy of the parameters:
        # build it from the warm-started ones
        initial_state = dataclasses.replace(state, params=params,
                                            opt_state=trainer.optimizer.init(params))
        get_logger(LOG_NAME).info(
            "warm-started the wav2vec2 encoder from %s", init_ckpt)
    return fit_and_test(trainer, cfg.train.get("checkpoint"), initial_state)


if __name__ == "__main__":
    main()
