"""Dual-stream SSL training (wav2vec2 + mel), the port's counterpart of the
repository's ``train_ssl_double.py`` over ``conf/ssl-conf.yaml``:

    python -m lightning_asr_torch.train_ssl_double ssl.feature_folder=feats/ \\
        data.train_manifest='["a.json"]' [--device cpu] [--config ...]

The wav2vec2 features mapped 512 -> 64 and a 20 ms-hop log-mel stream
computed on the device from the raw waves, concatenated into the encoder
(``in_c=128``, float32), with the pseudo-labeling loop of ``train_ssl``.
It runs on the card unless ``--device cpu`` asks for the CPU, and raises
without one; the kernel switches are read as ``python -m
lightning_asr_torch.train`` reads them.  The resolved config is printed as
JSON.  ``train.n_devices`` (or a launcher on this host) trains over
data-parallel ranks as ``train_ssl`` does.
"""

from __future__ import annotations

from .models.dual_stream import DualStreamAsrModel
from .ssl_codec.dual_datamodule import DualSSLDataModule
from .train import kernel_switches
from .train_ssl import data_kwargs, feature_kwargs, fit_and_test, launch, trainer_kwargs
from .training.dual_trainer import DualSSLTrainer


def main(argv=None) -> dict:
    """Train as configured; returns {"trainer", "state", "test"} (rank 0's
    where this process started the other ranks)."""
    return launch("lightning_asr_torch.train_ssl_double", argv, __doc__.splitlines()[0], _main)


def _main(cfg, device) -> dict:
    model_cfg = cfg.model
    dm = DualSSLDataModule(**data_kwargs(cfg), **feature_kwargs(cfg, device))
    model = DualStreamAsrModel(
        num_classes=dm.vocab.num_classes,
        encoder_name=model_cfg.get("encoder", "quartznet12_context"),
        drop_rate=model_cfg.get("drop_rate", 0.0),
        mask=model_cfg.get("mask", True),
        **kernel_switches())
    trainer = DualSSLTrainer(**trainer_kwargs(cfg, model, device, dm, "outputs/ssl-double-run",
                                              {"dual_stream": True, "in_c": 128}))
    return fit_and_test(trainer, cfg.train.get("checkpoint"))


if __name__ == "__main__":
    main()
