"""Data-parallel training of the PyTorch port over the cards of one host:
``python -m lightning_asr_torch.train`` (its ``main``) with
``train.n_devices=N``, this process being rank 0 and starting ranks 1..N-1
(NCCL when each rank has a card of its own), on a seeded corpus of noise
utterances of 2 s to ``--seconds`` padded to one bucket, the default
full-width bf16 model and recipe:

    python3 tools/torch_dp_scaling.py [--ranks 1 2 4] [--rows 32] [--utts 1024] [--tp 2]
    python3 tools/torch_dp_scaling.py --entry train_ssl [--ranks 1 2 4] ...
    python3 tools/torch_dp_scaling.py --device cpu --ranks 1 4 --rows 2 \\
        --utts 32 --dev-utts 8 --seconds 2 --epochs 2     # gloo on the CPU

  * parity: the largest N against one process on the same global batches
    (N x ``--rows`` rows, ``PARITY_STEPS`` steps): the logged losses (the
    global batch's) within ``LOSS_RTOL``;
  * scaling: ``--rows`` rows a rank (a global batch of N x rows) for
    ``--epochs`` epochs, validated after the last: each epoch's wall,
    steps and global rows a second, and the last epoch's weak-scaling
    efficiency against one process.

With ``--entry train_ssl`` the runs are ``python -m
lightning_asr_torch.train_ssl`` (its ``main``, over ``conf/ssl-conf.yaml``):
the feature model on seeded wav2vec2 feature pickles of each utterance's
frame count (50 a second), with no pseudo pass.

With ``--tp T`` every run of N > 1 ranks (N a multiple of T) is
tensor-parallel (``train.tp=T``: N / T model groups of T ranks, which
split the conv trunk's channels and hold the same rows): ``--rows`` rows a
model group, so a global batch of N / T x rows, and the efficiency counts
a model group as one data rank.

Prints one JSON line a run, then a summary line with each card's name and
power limit.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lightning_asr_torch.data.audio import write_wav  # noqa: E402
from lightning_asr_torch.ops import kernel_build  # noqa: E402
from lightning_asr_torch.parallel import distributed  # noqa: E402
from lightning_asr_torch.train import main as train_main  # noqa: E402
from lightning_asr_torch.train_ssl import main as ssl_main  # noqa: E402

SR = 16000
LABELS = " 'abcdefghijklmnopqrstuvwxyz"
CHARS_PER_S = 15
PARITY_STEPS = 4
# bf16 losses of N ranks against one process on the same global batches:
# the BatchNorm, loss and gradient sums in another order and cuDNN's
# algorithms at fewer rows, through a few steps (chip_smoke.py's
# DP_BF16_LOSS_RTOL)
LOSS_RTOL = 2e-2


def corpus(root: Path, n: int, seconds: float, seed: int, name: str,
           features: bool = False) -> Path:
    """``n`` WAVs of noise of 2 s to ``seconds`` with random texts of ~15
    characters a second, and their JSONL manifest; with ``features`` a
    (1, frames, 512) wav2vec2 feature pickle of each in ``root/feats``."""
    rng = np.random.default_rng(seed)
    rows = []
    (root / "feats").mkdir(exist_ok=True)
    for i in range(n):
        dur = float(rng.uniform(2.0, seconds))
        wave = (0.1 * rng.standard_normal(int(dur * SR))).astype(np.float32)
        text = "".join(rng.choice(list(LABELS[2:]), int(CHARS_PER_S * dur)))
        path = root / f"{name}_{i}.wav"
        write_wav(path, wave, SR)
        if features:
            with open(root / "feats" / f"{name}_{i}.pkl", "wb") as f:
                pickle.dump(rng.standard_normal((1, int(dur * 50), 512)).astype(np.float32), f)
        rows.append({"audio_filepath": str(path), "duration": len(wave) / SR, "text": text})
    manifest = root / f"{name}.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def split(args, n: int) -> int:
    """The model group's size of a run over ``n`` ranks."""
    return args.tp if n > 1 and n % args.tp == 0 else 1


def run(args, root: Path, train: Path, dev: Path, n: int, batch: int, epochs: int,
        limit=None) -> dict:
    """One training run over ``n`` ranks with a global batch of ``batch``
    rows; rank 0's trainer."""
    run_dir = root / f"run_{n}_{batch}_{limit}"
    argv = [f"data.train_manifest={train}", f"data.val_manifest={dev}",
            f"data.test_manifest={dev}", f"data.bucket_seconds=[{args.seconds}]",
            f"data.train_max_duration={args.seconds}", f"train.n_devices={n}",
            f"train.train_batch_size={batch}", f"train.dev_batch_size={batch}",
            f"train.total_epoch={epochs}", f"train.check_val_every_n_epoch={epochs}",
            "train.warmup_steps=1", "train.log_every_n_steps=1", f"log.run.dir={run_dir}",
            "--device", args.device]
    argv += ([f"ssl.feature_folder={root / 'feats'}"] if args.entry == "train_ssl"
             else [f"train.tp={split(args, n)}"])
    if limit is not None:
        argv.append(f"train.limit_train_batches={limit}")
    with contextlib.redirect_stdout(io.StringIO()):
        out = (ssl_main if args.entry == "train_ssl" else train_main)(argv)
    return out["trainer"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rows", type=int, default=32, help="rows a rank")
    ap.add_argument("--utts", type=int, default=1024)
    ap.add_argument("--dev-utts", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=16.7)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--tp", type=int, default=1, help="ranks of a model group (train.tp)")
    ap.add_argument("--entry", choices=["train", "train_ssl"], default="train")
    args = ap.parse_args()
    if args.entry == "train_ssl" and args.tp > 1:
        ap.error("the SSL entry points split rows only: no --tp")
    cards = []
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_dp_scaling: no card; pass --device cpu", file=sys.stderr)
            return 2
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.strip().splitlines()
        if max(args.ranks) > len(cards):
            print(f"torch_dp_scaling: {max(args.ranks)} ranks need as many cards, "
                  f"{len(cards)} visible", file=sys.stderr)
            return 2
        kernel_build.build_all()            # once, before the ranks start
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ssl = args.entry == "train_ssl"
        train = corpus(root, args.utts, args.seconds, 0, "train", ssl)
        dev = corpus(root, args.dev_utts, args.seconds, 1, "dev", ssl)
        top = max(args.ranks)
        rows = top // split(args, top) * args.rows          # the parity runs' global batch
        parity = {}
        for n in sorted({1, top}):
            tr = run(args, root, train, dev, n, rows, 1, PARITY_STEPS)
            parity[n] = tr.epoch_stats[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(parity[top], parity[1]))
        ok &= len(parity[top]) == PARITY_STEPS and rel <= LOSS_RTOL
        print(json.dumps({"phase": "parity", "ranks": top, "tp": split(args, top),
                          "global_rows": rows, "losses": parity[top],
                          "one_process_losses": parity[1], "loss_rel": rel,
                          "loss_rtol": LOSS_RTOL}), flush=True)
        rates, groups = {}, {}
        for n in args.ranks:
            groups[n] = n // split(args, n)
            batch = groups[n] * args.rows
            tr = run(args, root, train, dev, n, batch, args.epochs)
            epochs = [{"epoch": e["epoch"], "steps": e["batches"], "wall_s": e["wall_sec"],
                       "global_rows_per_s": e["batches"] * batch / e["wall_sec"],
                       "loss_mean": e["loss_mean"]} for e in tr.epoch_stats]
            rates[n] = epochs[-1]["global_rows_per_s"]
            ok &= all(np.isfinite(e["loss_mean"]) for e in epochs)
            print(json.dumps({"phase": "scaling", "ranks": n, "tp": split(args, n),
                              "rows_per_model_group": args.rows,
                              "backend": distributed.backend_for(args.device, n, len(cards)),
                              "epochs": epochs}), flush=True)
    base = rates.get(1)
    print(json.dumps({"cards": cards, "device": args.device, "ok": bool(ok), "tp": args.tp,
                      "entry": args.entry,
                      "global_rows_per_s": rates,
                      "weak_scaling_efficiency": {n: r / (groups[n] * base)
                                                  for n, r in rates.items()}
                      if base else None}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
