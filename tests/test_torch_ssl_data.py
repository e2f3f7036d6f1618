"""Parity: the SSL path's host side against the JAX package on the CPU:
``SSLBucketBatcher`` batches and the datamodule's pseudo-label pool bit for
bit, the confidence measures and ``seq_sum_logprob`` bit for bit, the
``Wav2Vec2Extractor`` wrapper with one tiny random HuggingFace model (built
from a config, no download) injected into both packages' wrappers, the
offline pickles; then the port alone: ``SSLTrainer``'s pseudo pass and its
gating at epoch ends and on resume (as the JAX package's own SSL tests
check its trainer), and ``AsrTranslator``'s feature branch on a saved
``feature_in`` checkpoint against the JAX model's forward of the same
features (1e-5), and a static check that the new SSL modules import no JAX.
"""

import ast
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.data.manifest import read_manifests as jax_read_manifests
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ssl_codec import confidence as jc
from lightning_asr_tpu.ssl_codec.extractor import Wav2Vec2Extractor as JaxExtractor
from lightning_asr_tpu.ssl_codec.extractor import load_feature_pkl as jax_load_feature_pkl
from lightning_asr_tpu.ssl_codec.ssl_datamodule import SSLBucketBatcher as JaxSSLBatcher
from lightning_asr_tpu.ssl_codec.ssl_datamodule import SSLDataModule as JaxSSLDataModule
from lightning_asr_torch.data.audio import write_wav
from lightning_asr_torch.data.manifest import read_manifests
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.ssl_codec import confidence as tc
from lightning_asr_torch.ssl_codec.extractor import Wav2Vec2Extractor, convert, load_feature_pkl
from lightning_asr_torch.ssl_codec.ssl_datamodule import SSLBucketBatcher, SSLDataModule
from lightning_asr_torch.ssl_codec.wav2vec import output_lengths
from lightning_asr_torch.training.checkpoint import save_checkpoint
from lightning_asr_torch.training.ssl_trainer import SSLTrainer
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, class_std, with_teeth

REPO = Path(__file__).resolve().parents[1]
LABELS = [" ", "a", "c", "d", "g", "o", "t"]
FIELDS = ("waves", "wave_lens", "prev_samples", "targets", "target_lens")


@pytest.fixture(scope="module")
def ssl_corpus(tmp_path_factory):
    """Twelve utterances of 1-7 s as offline feature pickles (no audio) and
    their manifest."""
    root = tmp_path_factory.mktemp("ssl")
    rng = np.random.default_rng(41)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    rows = []
    for i in range(12):
        dur = float(rng.uniform(1.0, 7.0))
        with open(feat_dir / f"utt{i}.pkl", "wb") as f:
            pickle.dump(rng.standard_normal((1, int(dur * 50), 512)).astype(np.float32), f)
        rows.append({"audio_filepath": str(root / f"utt{i}.wav"), "duration": dur,
                     "text": ["cat dog", "dog", "a cat", ""][i % 4]})
    manifest = root / "m.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest, feat_dir


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for field in FIELDS:
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert g.paths == w.paths and g.texts == w.texts and g.extra is None


@pytest.mark.parametrize("train", [True, False])
def test_ssl_batches_equal_jax(ssl_corpus, train):
    """Train (shuffled, last batches dropped) over two epochs and eval
    batches, two frame buckets and an overflow past them."""
    manifest, feat_dir = ssl_corpus
    kw = dict(batch_size=3, ssl_folder=str(feat_dir), train=train, bucket_seconds=(2.0, 4.0),
              seed=7)
    want = JaxSSLBatcher(jax_read_manifests(manifest, 16.7), JaxVocabulary(LABELS), **kw)
    got = SSLBucketBatcher(read_manifests(manifest, 16.7), Vocabulary(LABELS), **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        batches = list(got)
        _assert_batches_equal(batches, list(want))
    shapes = {b.waves.shape[1] for b in batches}
    assert 200 in shapes and max(shapes) > 200 and max(shapes) % 50 == 0


def test_pseudo_pool_and_injection_equal_jax(ssl_corpus):
    """The unlabeled pool, its loader, ``inject_pseudo_datasets`` (train
    batches drawing from train + pseudo entries, ``steps_per_epoch``
    growing, a re-injection replacing the last) as the JAX datamodule."""
    manifest, feat_dir = ssl_corpus
    kw = dict(train_manifest=str(manifest), dev_manifest=str(manifest), labels=LABELS,
              train_bs=3, dev_bs=3, ssl_folder=str(feat_dir), pseudo_manifest=str(manifest),
              pseudo_max_duration=5.0, bucket_seconds=(4.0,), seed=2)
    want, got = JaxSSLDataModule(**kw), SSLDataModule(**kw)
    _assert_batches_equal(list(got.pseudo_train_dataloader()), list(want.pseudo_train_dataloader()))
    assert [e.audio_filepath for e in got.unlabeled_entries] == \
        [e.audio_filepath for e in want.unlabeled_entries]
    assert all(e.duration <= 5.0 for e in got.unlabeled_entries)
    before = got.steps_per_epoch()
    pairs = [(e.audio_filepath, "cat", e.duration) for e in got.unlabeled_entries[:6]]
    for dm in (want, got):
        dm.inject_pseudo_datasets(pairs)
    assert got.steps_per_epoch() == want.steps_per_epoch() > before
    _assert_batches_equal(list(got.train_dataloader(1)), list(want.train_dataloader(1)))
    got.inject_pseudo_datasets(pairs[:1])
    assert len(got.pseudo_entries) == 1 and got.steps_per_epoch() == before


@pytest.mark.parametrize("measure", ["ref", "nonblank", "min_maxlp", "entropy"])
def test_confidence_scores_equal_jax(measure):
    rng = np.random.default_rng(42)
    B, T, C = 4, 37, 29
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    logits[:2] += 6.0 * np.eye(C, dtype=np.float32)[rng.integers(0, C, (2, T))]
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = np.array([37, 20, 5, 1])
    want = jc.confidence_scores(lp, lens, C - 1, measure)
    got = tc.confidence_scores(lp, lens, C - 1, measure)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for blank in (None, C - 1):
        assert tc.seq_sum_logprob((3, lp[1], 20), blank) == jc.seq_sum_logprob((3, lp[1], 20), blank)
    with pytest.raises(ValueError, match="unknown confidence measure"):
        tc.confidence_scores(lp, lens, C - 1, "nope")


def _tiny_hf(extractor_cls):
    """An extractor of each package with one tiny random HuggingFace
    wav2vec2 (32-channel conv stack, one transformer layer) injected."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Wav2Vec2Config(conv_dim=(32,) * 7, hidden_size=32, num_hidden_layers=1,
                                      num_attention_heads=2, intermediate_size=64,
                                      feat_extract_norm="layer", conv_bias=True)
    model = transformers.Wav2Vec2Model(cfg).eval()
    processor = transformers.Wav2Vec2FeatureExtractor(do_normalize=True)
    out = []
    for cls in extractor_cls:
        ext = cls("tiny") if cls is JaxExtractor else cls("tiny", device="cpu")
        ext._model, ext._processor, ext._torch = model, processor, torch
        out.append(ext)
    return out


def test_extractor_equals_jax_wrapper(tmp_path):
    """Features and valid shares of paths and waveforms equal the JAX
    wrapper's; ``convert`` writes the (1, T, C) pickle both packages'
    ``load_feature_pkl`` read back."""
    port, ref = _tiny_hf((Wav2Vec2Extractor, JaxExtractor))
    rng = np.random.default_rng(43)
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (16000, 11000)]
    path = tmp_path / "a.wav"
    write_wav(path, waves[1], 16000)
    for audio in (waves, [str(path), waves[0]]):
        (got, got_p), (want, want_p) = port(audio), ref(audio)
        assert got.dtype == np.float32 and np.array_equal(got, want) and np.array_equal(got_p, want_p)
    assert got.shape == (2, output_lengths(16000), 32)
    pkl = convert(port, path, tmp_path / "feats")
    assert pkl.name == "a.pkl" and pickle.loads(pkl.read_bytes()).shape[0] == 1
    np.testing.assert_array_equal(load_feature_pkl(path, tmp_path / "feats"),
                                  jax_load_feature_pkl(path, tmp_path / "feats"))


def test_translator_feature_branch_matches_jax(tmp_path):
    """A ``feature_in`` checkpoint's translator: the extractor's features,
    frames from ``output_lengths`` capped at the feature length, rows padded
    to a power of two; its log-probs within 1e-5 of the JAX model's on the
    same padded features; ``long_log_probs`` refuses."""
    rng = np.random.default_rng(44)
    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, feature_in=512)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 512)), jnp.ones((1,)), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    hparams = {"labels": AsrTranslator.EN_LABELS, "encoder": "quartznet12_context", "in_c": 64,
               "feature_in": 512, "mask": True, "compute_dtype": "float32", "normalize": False,
               "from_features": True, "ssl_model_name": "tiny"}
    translator = AsrTranslator(save_checkpoint(tmp_path / "ckpt", from_jax(params, stats), hparams),
                               device="cpu")
    assert translator.ssl_extractor.model_name == "tiny"

    class Fixed:
        """An extractor stand-in: 512-channel features of 20 ms frames."""

        def __call__(self, waves):
            T = max(int(output_lengths(len(w))) for w in waves) + 1
            return rng.standard_normal((len(waves), T, 512)).astype(np.float32), None

    translator.ssl_extractor = Fixed()
    waves = [np.zeros(n, np.float32) for n in (32000, 20000, 9000)]
    feats, frames = translator.feature_batch(waves)
    assert feats.shape[0] == 4 and np.array_equal(feats[3], feats[0])
    np.testing.assert_array_equal(frames, [99, 62, 27, 99])
    lp, out_lens = translator._forward_feats(torch.from_numpy(feats), torch.from_numpy(frames))
    percents = frames.astype(np.float32) / np.float32(feats.shape[1])
    want_lp, want_lens = jax.jit(lambda f, p: jmodel.apply(
        {"params": params, "batch_stats": stats}, f, p, False))(jnp.asarray(feats),
                                                                jnp.asarray(percents))
    assert class_std(np.asarray(want_lp)) >= 0.5
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    texts = translator.transcribe_batch(waves)
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    with pytest.raises(NotImplementedError, match="mel path"):
        translator.long_log_probs(np.zeros(16000 * 30, np.float32))


class _Loggers:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append(metrics)


def _bare_trainer(dm, start, every, threshold, eval_step):
    t = SSLTrainer.__new__(SSLTrainer)
    t.dm, t.vocab, t.loggers, t.global_step = dm, dm.vocab, _Loggers(), 0
    t.pseudo_start_epoch, t.pseudo_every_n_epochs = start, every
    t.pseudo_confidence_threshold, t.pseudo_confidence_measure = threshold, "ref"
    t._device_iter = lambda batcher: ((b, b) for b in batcher)
    t._eval_step = eval_step
    return t


def test_ssl_trainer_pseudo_pass_and_gating(ssl_corpus):
    """The pass at an epoch end that the gate opens decodes the pool,
    keeps the confident non-empty texts with the manifest's durations (a
    feature corpus has no WAV to read them from) and logs kept/total; a
    closed gate or an empty pool does nothing; on resume the pass runs
    again only if a scheduled one fired before the resume epoch."""
    manifest, feat_dir = ssl_corpus
    dm = SSLDataModule(train_manifest=str(manifest), labels=LABELS, train_bs=3, dev_bs=5,
                       ssl_folder=str(feat_dir), pseudo_manifest=str(manifest),
                       bucket_seconds=(4.0,))
    blank = dm.vocab.blank_id

    def eval_step(state, batch):
        """'cat' for every row but the first (all blank) of each batch."""
        B, T = batch.waves.shape[0], 8
        preds = np.full((B, T), blank, np.int32)
        preds[1:, :3] = [LABELS.index(c) for c in "cat"]
        lp = np.full((B, T, len(LABELS) + 1), -10.0, np.float32)
        np.put_along_axis(lp, preds[..., None], -0.001, axis=-1)
        return {"preds": torch.from_numpy(preds), "pred_lens": torch.full((B,), T),
                "log_probs": torch.from_numpy(lp)}

    t = _bare_trainer(dm, start=2, every=2, threshold=0.01, eval_step=eval_step)
    dm.setup()
    pool = dm.unlabeled_entries
    n_batches = len(dm.pseudo_train_dataloader())           # one all-blank row a batch
    t.on_train_epoch_end(None, 1)                   # before the start
    t.on_train_epoch_end(None, 3)                   # off the period
    assert dm.pseudo_entries == [] and t.loggers.rows == []
    t.on_train_epoch_end(None, 4)
    assert t.loggers.rows == [{"pseudo_kept": len(pool) - n_batches, "pseudo_total": len(pool)}]
    durs = {e.audio_filepath: e.duration for e in pool}
    assert len(dm.pseudo_entries) == len(pool) - n_batches
    assert all(e.text == "cat" and e.duration == durs[e.audio_filepath] for e in dm.pseudo_entries)

    calls = []
    t._pseudo_pass = calls.append
    t.pseudo_start_epoch, t.pseudo_every_n_epochs = 15, 4
    t.on_resume("s", 10)
    t.on_resume("s", 16)                            # epoch 16's pass has not run yet
    assert calls == []
    t.on_resume("s", 17)
    assert calls == ["s"]
    dm.unlabeled_entries = []
    t.on_resume("s", 30)
    t.on_train_epoch_end("s", 16)
    assert calls == ["s"]


_NEW_MODULES = ("ssl_codec/confidence.py", "ssl_codec/extractor.py", "ssl_codec/wav2vec.py",
                "ssl_codec/retrain.py", "ssl_codec/ssl_datamodule.py",
                "ssl_codec/dual_datamodule.py", "models/dual_stream.py",
                "training/ssl_trainer.py", "training/dual_trainer.py",
                "training/retrain_trainer.py", "train_ssl.py", "train_ssl_double.py")


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_ssl_modules_import_no_jax(module):
    """The SSL modules import neither JAX, flax nor the JAX package, and
    ``transformers`` only inside a function."""
    tree = ast.parse((REPO / "lightning_asr_torch" / module).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "orbax", "lightning_asr_tpu"}, roots
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names} | {node.module.split(".")[0] for node in tree.body
                                   if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert "transformers" not in top
