"""The port's SSL entry points through ``main(argv)`` with ``--device cpu``
on a small corpus written here (WAVs of 1-1.8 s, their feature pickles,
manifests; the full-width models in float32): ``python -m
lightning_asr_torch.train_ssl`` with the pseudo-labeling loop on (a pass at
the end of epochs 1 and 2 that decodes the pool, injects it and grows the
next epoch), ``train_ssl ssl.retrain=true`` warm-started from a local
HuggingFace-named feature encoder state_dict, and ``python -m
lightning_asr_torch.train_ssl_double``; each resumes nothing, checkpoints,
and runs a test pass.  Without ``--device`` each asks for the card and
raises here."""

import json
import pickle

import numpy as np
import pytest
import torch

from lightning_asr_torch.data.audio import write_wav
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.ssl_codec.wav2vec import Wav2Vec2FeatureEncoder
from lightning_asr_torch.train_ssl import main as ssl_main
from lightning_asr_torch.train_ssl_double import main as double_main

LABELS = [" ", "a", "b", "c"]


def _corpus(root, name, n, rng):
    rows = []
    for i in range(n):
        dur = float(rng.uniform(1.0, 1.8))
        path = root / f"{name}{i}.wav"
        write_wav(path, (rng.standard_normal(int(dur * 16000)) * 0.1).astype(np.float32), 16000)
        with open(root / "feats" / f"{name}{i}.pkl", "wb") as f:
            pickle.dump(rng.standard_normal((1, int(dur * 50), 512)).astype(np.float32), f)
        rows.append({"audio_filepath": str(path), "duration": dur,
                     "text": "".join(rng.choice(list("abc "), size=5)).strip() or "a"})
    manifest = root / f"{name}.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl_cli")
    (root / "feats").mkdir()
    rng = np.random.default_rng(51)
    return root, {name: _corpus(root, name, n, rng)
                  for name, n in (("train", 8), ("dev", 4), ("pool", 6))}


def _args(corpus, run, *extra):
    root, m = corpus
    return [f"data.train_manifest={m['train']}", f"data.val_manifest={m['dev']}",
            f"data.test_manifest={m['dev']}", f"data.labels={json.dumps(LABELS)}",
            f"ssl.feature_folder={root / 'feats'}", "data.bucket_seconds=[2.0]",
            "train.train_batch_size=4", "train.dev_batch_size=4", "train.warmup_steps=1",
            "train.log_every_n_steps=1", "model.compute_dtype=f32", f"log.run.dir={run}",
            *extra]


def _metrics(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_train_ssl_with_pseudo_labels(corpus, tmp_path):
    root, m = corpus
    run = tmp_path / "run"
    out = ssl_main(_args(corpus, run, "train.total_epoch=3", f"data.pseudo_manifest={m['pool']}",
                         "ssl.pseudo_start_epoch=1", "ssl.pseudo_every_n_epochs=1",
                         "ssl.pseudo_confidence_threshold=1e9") + ["--device", "cpu"])
    trainer = out["trainer"]
    assert trainer.model.feature_mapping.weight.shape == (64, 512)
    assert trainer.hparams["from_features"] and not trainer.hparams["normalize"]
    rows = [r for r in _metrics(run) if "pseudo_total" in r]
    assert [r["pseudo_total"] for r in rows] == [6, 6]              # epochs 1 and 2
    kept = rows[0]["pseudo_kept"]
    assert 0 < kept <= 6 and len(trainer.dm.pseudo_entries) == rows[1]["pseudo_kept"]
    batches = [e["batches"] for e in trainer.epoch_stats]
    assert batches[0] == batches[1] == 2 and batches[2] == (8 + kept) // 4
    assert all(np.isfinite(e["loss_mean"]) for e in trainer.epoch_stats)
    assert np.isfinite(out["test"]["test_loss"])
    translator = AsrTranslator(run / "checkpoints" / "last", device="cpu")
    assert translator.ssl_extractor is not None
    sd = translator.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in out["state"].params.items())


def test_train_ssl_retrain_warm_started(corpus, tmp_path):
    """The HuggingFace-named state_dict (``conv_layers.{i}.conv.weight``,
    ``...layer_norm.weight``, under ``wav2vec2.feature_extractor.``) is what
    the trained encoder starts from: after an epoch of two steps at a warmup
    lr its weights lie within 1e-2 of it."""
    gen = torch.Generator().manual_seed(5)
    enc = Wav2Vec2FeatureEncoder("layer", True)
    hf = {}
    for i in range(7):
        for mod, ours in (("conv", f"conv{i}"), ("layer_norm", f"ln{i}")):
            for leaf in ("weight", "bias"):
                shape = getattr(getattr(enc, ours), leaf).shape
                hf[f"wav2vec2.feature_extractor.conv_layers.{i}.{mod}.{leaf}"] = \
                    torch.randn(shape, generator=gen) * 0.1
    torch.save({"state_dict": hf}, tmp_path / "hf.pt")
    run = tmp_path / "run"
    out = ssl_main(_args(corpus, run, "ssl.retrain=true", "train.total_epoch=1",
                         f"ssl.hf_encoder_state_dict={tmp_path / 'hf.pt'}") + ["--device", "cpu"])
    state, trainer = out["state"], out["trainer"]
    assert int(state.step) == 2 and trainer.hparams["ssl_retrain"]
    assert not trainer.dm.crop and trainer.dm.wire == "int16"
    w = state.params["wav2vec.conv3.weight"]
    assert (w - hf["wav2vec2.feature_extractor.conv_layers.3.conv.weight"]).abs().max() < 1e-2
    assert (state.params["wav2vec.ln2.weight"]
            - hf["wav2vec2.feature_extractor.conv_layers.2.layer_norm.weight"]).abs().max() < 1e-2
    assert np.isfinite(out["test"]["test_loss"])


def test_train_ssl_double(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("LASR_LSTM_FUSED_BIDIR", "1")
    run = tmp_path / "run"
    out = double_main(_args(corpus, run, "train.total_epoch=1") + ["--device", "cpu"])
    trainer = out["trainer"]
    assert trainer.model.encoder.context_rnn.fuse_directions
    assert trainer.hparams["dual_stream"] and trainer.hparams["in_c"] == 128
    assert trainer.hparams["compute_dtype"] == "float32"
    assert [e["batches"] for e in trainer.epoch_stats] == [2]
    assert np.isfinite(trainer.epoch_stats[0]["loss_mean"]) and np.isfinite(out["test"]["test_loss"])
    assert (run / "checkpoints" / "last").is_dir()


@pytest.mark.parametrize("entry,extra", [(ssl_main, []), (ssl_main, ["ssl.retrain=true"]),
                                         (double_main, [])])
def test_entry_points_ask_for_the_card(corpus, tmp_path, entry, extra):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(_args(corpus, tmp_path / "run", *extra))
