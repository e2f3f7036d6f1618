#!/usr/bin/env python
"""Convert a reference (pytorch-lightning) .ckpt into a checkpoint
directory of the PyTorch port, which ``AsrTranslator`` and the port's
predict CLI load with no config:

    python scripts/torch_import_ckpt.py --ckpt asr-epoch93-val_wer0.16.ckpt \\
        --out outputs/imported --encoder quartznet12_context

The state_dict's names are mapped by
``lightning_asr_torch/utils/torch_import.py``; labels come from --labels (a
vocab file, which flips CER, or comma-separated labels) or the default
English set.  The model is built and loaded on the CPU to check every key
and shape, and run once on zeros.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lightning_asr_torch.data.vocab import Vocabulary  # noqa: E402
from lightning_asr_torch.inference.predict import AsrTranslator  # noqa: E402
from lightning_asr_torch.models.quartznet import MODEL_REGISTRY, build_model  # noqa: E402
from lightning_asr_torch.training.checkpoint import save_checkpoint  # noqa: E402
from lightning_asr_torch.utils.torch_import import load_reference_checkpoint  # noqa: E402


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="reference .ckpt path")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    ap.add_argument("--encoder", default="quartznet12_context", choices=MODEL_REGISTRY)
    ap.add_argument("--labels", default=None,
                    help="vocab file (flips CER) or comma-separated labels")
    args = ap.parse_args(argv)

    if args.labels is None:
        vocab = Vocabulary(AsrTranslator.EN_LABELS)
    elif Path(args.labels).exists():
        vocab = Vocabulary.from_config(args.labels)
    else:
        vocab = Vocabulary(args.labels.split(","))

    state_dict, ref_hparams = load_reference_checkpoint(args.ckpt)
    print(f"converted {sum(t.numel() for t in state_dict.values()) / 1e6:.2f}M parameters "
          f"(reference hparams: {sorted(ref_hparams)})")
    mask = bool(ref_hparams.get("mask", True))
    model = build_model(vocab.num_classes, args.encoder, mask=mask)
    model.load_state_dict(state_dict, strict=True)
    hparams = {"labels": vocab.labels, "use_cer": vocab.use_cer, "encoder": args.encoder,
               "in_c": 64, "mask": mask, "drop_rate": float(ref_hparams.get("drop_rate", 0.0)),
               "compute_dtype": "float32"}          # the reference model's precision
    out = save_checkpoint(args.out, model.state_dict(), hparams,
                          {"epoch": int(ref_hparams.get("total_epoch", 0))})
    print(f"wrote {out}")
    model.eval()
    with torch.no_grad():
        log_probs, _ = model(torch.zeros(1, 64, 64), torch.ones(1))
    print(f"forward smoke OK: {tuple(log_probs.shape)}")
    return out


if __name__ == "__main__":
    main()
