"""SSL training over data-parallel ranks on the CPU (``train_ssl``,
``ssl.retrain``, ``train_ssl_double``), and the server's Flask route.

Ranks are worker processes of ``torch_dp_worker.py`` (torch and the port
only) in a gloo group on 127.0.0.1, as in ``test_torch_data_parallel.py``.
The step and pool tests run the SSL models with ``torch_dp_worker``'s
narrow encoder and decoder in place of the full-width ones
(``ssl_model``); the CLI tests run the entry points' full-width models.
The corpus: tone-language WAVs of 1-1.9 s (``test_torch_pipeline``) with
wav2vec2 feature pickles of their frame counts, in one 2 s bucket of 100
frames, so that a pad row's 160 frames exceed T; the retrain model's raw
waves are of 0.24-0.4 s in a 0.5 s bucket (its wav2vec2 encoder is
full-width).

Tolerances:
  * the sharded batches against one process's and the JAX batchers' with
    the JAX trainer's pad rows: bit for bit;
  * one float32 step of each SSL mode over 2 ranks against the port's one
    process on the padded global batch, with dither, SpecAugment, cutout
    and dropout on (the ranks draw for the global rows): ``FEATURE_TOL``;
    with every draw off, against the JAX package's step of the mode's flax
    twin on that batch: ``RECIPE_TOL`` of ``test_torch_train_step.py``;
    one rank with ``data_parallel=True`` against the step without it: bit
    for bit;
  * the pseudo-label pool: equal (paths, texts, order, durations).
"""

import dataclasses
import json
import os
import pickle
import socket
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
import lightning_asr_tpu.training.steps as jax_steps
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.models import layers as jl
from lightning_asr_tpu.models.dual_stream import DUAL_MEL_CONFIG as JAX_DUAL_MEL
from lightning_asr_tpu.models.dual_stream import DualStreamAsrModel as JaxDualModel
from lightning_asr_tpu.models.quartznet import _ENCODERS as JAX_ENCODERS
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.parallel import batch_sharding, make_mesh
from lightning_asr_tpu.ssl_codec.dual_datamodule import DualSSLBucketBatcher as JaxDualBatcher
from lightning_asr_tpu.ssl_codec.ssl_datamodule import SSLBucketBatcher as JaxSSLBatcher
from lightning_asr_tpu.ssl_codec.retrain import SSLRetrainAsrModel as JaxRetrainModel
from lightning_asr_tpu.ssl_codec.ssl_datamodule import SSLDataModule as JaxSSLDataModule
from lightning_asr_tpu.training.ssl_trainer import SSLTrainer as JaxSSLTrainer
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_dual_train_step as jax_make_dual_train_step
from lightning_asr_tpu.training.steps import make_eval_step as jax_make_eval_step
from lightning_asr_tpu.training.steps import make_raw_ssl_train_step as jax_make_raw_train_step
from lightning_asr_tpu.training.steps import make_train_step as jax_make_train_step
from lightning_asr_tpu.training.trainer import Trainer as JaxTrainer
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.data.manifest import read_manifests
from lightning_asr_torch.data.pipeline import BucketBatcher
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.inference import server
from lightning_asr_torch.optim import novograd
from lightning_asr_torch.models.quartznet import reset_parameters
from lightning_asr_torch.parallel import distributed
from lightning_asr_torch.ssl_codec import dual_datamodule, ssl_datamodule
from lightning_asr_torch.ssl_codec.dual_datamodule import DualSSLBucketBatcher
from lightning_asr_torch.ssl_codec.ssl_datamodule import SSLBucketBatcher, SSLDataModule
from lightning_asr_torch.train_ssl import main as ssl_main
from lightning_asr_torch.train_ssl_double import main as double_main
from lightning_asr_torch.training.checkpoint import load_checkpoint
from lightning_asr_torch.training.ssl_trainer import SSLTrainer
from lightning_asr_torch.utils.jax_params import from_jax, to_jax
from test_torch_data_parallel import JaxSmallEncoder, _compare_port, run_ranks
from test_torch_model import with_teeth
from test_torch_pipeline import LABELS, tone_corpus
from test_torch_train_step import FEATURE_TOL, RECIPE_TOL, SCHEDULE, compare_step, jax_capture
from torch_dp_worker import ssl_model, ssl_step

NUM_CLASSES = len(LABELS) + 1
FIELDS = ("waves", "wave_lens", "prev_samples", "targets", "target_lens")
EXTRA = ("raw_waves", "raw_wave_lens")


def _features(root, manifest, seed):
    """A (1, frames, 512) pickle for each WAV of ``manifest``."""
    rng = np.random.default_rng(seed)
    for line in manifest.read_text().splitlines():
        row = json.loads(line)
        stem = os.path.splitext(os.path.basename(row["audio_filepath"]))[0]
        with open(root / "feats" / f"{stem}.pkl", "wb") as f:
            pickle.dump(rng.standard_normal((1, int(row["duration"] * 50), 512)).astype(np.float32), f)
    return manifest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl_dp")
    (root / "feats").mkdir()
    manifests = {name: _features(root, tone_corpus(root, n, seed, name=name), seed)
                 for name, n, seed in (("train", 7, 0), ("dev", 4, 1), ("pool", 5, 2))}
    manifests["short"] = tone_corpus(root, 3, 3, lo=0.3, hi=0.45, name="short")
    return root, manifests


def _arrays(batch) -> dict:
    return {**{k: getattr(batch, k) for k in FIELDS}, **(batch.extra or {})}


def _jax_padded(batch, world: int) -> dict:
    """The JAX trainer's ``_device_batch`` of ``batch`` on a mesh of
    ``world`` devices: the batch with its pad rows."""
    trainer = JaxTrainer.__new__(JaxTrainer)
    trainer.mesh = make_mesh(world)
    trainer._batch_sharding = batch_sharding(trainer.mesh)
    return {k: np.asarray(v) for k, v in trainer._device_batch(batch).items()}


def _reads(monkeypatch, dual: bool) -> list:
    """The files each batcher reads: feature pickles, and WAVs in dual mode."""
    reads = []
    load, read = ssl_datamodule.load_feature_pkl, dual_datamodule.read_audio
    monkeypatch.setattr(ssl_datamodule, "load_feature_pkl",
                        lambda path, folder: (reads.append(path), load(path, folder))[1])
    if dual:
        monkeypatch.setattr(dual_datamodule, "read_audio",
                            lambda path, **kw: (reads.append(path), read(path, **kw))[1])
    return reads


# --- the sharded batchers ---

@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_sharded_ssl_batches_equal_one_process_and_jax(corpus, monkeypatch, dual, train):
    """3 ranks over batches of 4 (a global batch of 6: rank 2 holds pad rows
    only) and of 3: the ranks' rows, concatenated, equal the JAX batcher's
    batch with the pad rows the JAX trainer adds for a mesh of 3 (zero
    features, ``wave_lens`` 160 > T = 100, zero targets; in dual mode zero
    raw waves of length 0), and their first rows one process's batch, bit
    for bit; each rank reads the files of its own rows only."""
    root, m = corpus
    entries = read_manifests([str(m["train"])], 16.7)
    cls, jcls = (DualSSLBucketBatcher, JaxDualBatcher) if dual else (SSLBucketBatcher, JaxSSLBatcher)
    kw = dict(ssl_folder=str(root / "feats"), train=train, seed=3, bucket_seconds=(2.0,))
    full = list(cls(entries, Vocabulary.from_config(LABELS), 4, **kw))
    jax_batches = list(jcls(entries, JaxVocabulary.from_config(LABELS), 4, **kw))
    reads = _reads(monkeypatch, dual)
    shards = []
    for r in range(3):
        shards.append(list(cls(entries, Vocabulary.from_config(LABELS), 4, shard_rank=r,
                               shard_count=3, pad_to=3, **kw)))
        mine = [p for b in shards[-1] for p in b.paths]
        assert sorted(reads) == sorted(mine * (2 if dual else 1)), r
        reads.clear()
    assert len(full) == len(jax_batches) == (1 if train else 2)
    assert any(b.size == 4 for b in full)
    for b, j, *s in zip(full, jax_batches, *shards):
        want = _jax_padded(j, 3)
        G = want["waves"].shape[0]
        assert all(x.global_size == G for x in s) and sum(x.size for x in s) == b.size
        assert sum((x.paths for x in s), []) == b.paths == j.paths
        for key in FIELDS + (EXTRA if dual else ()):
            got = np.concatenate([_arrays(x)[key] for x in s])
            assert got.dtype == want[key].dtype and np.array_equal(got, want[key]), key
            assert np.array_equal(got[:b.size], _arrays(b)[key]), key
        if G > b.size:
            assert (want["wave_lens"][b.size:] == 160).all() and want["waves"].shape[1] == 100
    # the datamodule hands its batcher this rank's place in the group
    monkeypatch.setattr(AsrDataModule, "_shard_info", staticmethod(lambda: (1, 3)))
    dm = (dual_datamodule.DualSSLDataModule if dual else SSLDataModule)(
        train_manifest=str(m["train"]), dev_manifest=str(m["train"]), labels=LABELS,
        train_bs=4, dev_bs=4, seed=3, bucket_seconds=(2.0,), ssl_folder=str(root / "feats"))
    for got, want in zip(dm.train_dataloader(0) if train else dm.val_dataloader(), shards[1]):
        assert got.paths == want.paths and got.global_size == want.global_size
        assert all(np.array_equal(_arrays(got)[k], _arrays(want)[k]) for k in _arrays(want))


# --- the steps ---

class JaxSmallSslAsr(fnn.Module):
    """``ssl_model("feature")`` in flax: ``feature_mapping`` 512 -> 64, the
    narrow encoder, the 1x1 decoder."""

    @fnn.compact
    def __call__(self, x, percents, train=False):
        x = fnn.Dense(64, kernel_init=jl.torch_uniform_init(512),
                      bias_init=jl.torch_uniform_init(512), name="feature_mapping")(x)
        x = JaxSmallEncoder(name="encoder")(x, percents, train).astype(jnp.float32)
        x = fnn.Conv(NUM_CLASSES, (1,), use_bias=True, kernel_init=jl.torch_uniform_init(64),
                     bias_init=jl.torch_uniform_init(64), name="decoder")(x)
        log_probs = fnn.log_softmax(x, axis=-1)
        return log_probs, jl._lengths_from_percents(log_probs.shape[1], percents)


@pytest.fixture(scope="module")
def small_encoder():
    """The narrow encoder under the name "small" in the JAX models' encoder
    registry, so that the JAX package's own dual and retrain models build
    ``ssl_model``'s twins; taken out again after the module."""
    JAX_ENCODERS["small"] = (JaxSmallEncoder, {})
    yield
    del JAX_ENCODERS["small"]


def _jax_ssl_models() -> dict:
    """The flax twins of ``ssl_model``'s three modes."""
    return {"feature": JaxSmallSslAsr(),
            "dual": JaxDualModel(NUM_CLASSES, encoder_name="small", mask=True),
            "raw": JaxRetrainModel(NUM_CLASSES, encoder_name="small", mask=True,
                                   augment_cutout=False)}


@pytest.fixture(scope="module")
def ssl_input(corpus, tmp_path_factory):
    """The ranks' input.  Steps: seeded narrow models of the three modes
    (and the same weights in their flax twins' trees) and their padded
    global batches of 4 rows (3 utterances and a pad row) over 2 ranks:
    features (and raw waves) from the sharded dual batcher, int16 waves
    from the sharded ``BucketBatcher`` (no crop, as the retrain
    datamodule).  Pool: the narrow feature model's weights from its flax
    twin, the pool of 5 in batches of 4, threshold 1e9."""
    root, m = corpus
    vocab = Vocabulary.from_config(LABELS)
    kw = dict(train=False, seed=0, shard_count=2, pad_to=2)

    def global_batch(make) -> dict:
        shards = [next(iter(make(r))) for r in range(2)]
        assert shards[1].size == 1 and shards[1].global_size == 4
        return {k: torch.from_numpy(np.concatenate([_arrays(s)[k] for s in shards]))
                for k in _arrays(shards[0])}

    entries = read_manifests([str(m["train"])], 16.7)[:3]
    feature = global_batch(lambda r: DualSSLBucketBatcher(
        entries, vocab, 3, shard_rank=r, ssl_folder=str(root / "feats"), bucket_seconds=(2.0,),
        **kw))
    raw = global_batch(lambda r: BucketBatcher(read_manifests([str(m["short"])], 16.7), vocab, 3,
                                               crop=False, shard_rank=r, bucket_seconds=(0.5,),
                                               **kw))
    state_dicts, jax_steps_in = {}, {}
    for i, mode in enumerate(("feature", "dual", "raw")):
        model = ssl_model(mode, NUM_CLASSES)
        reset_parameters(model, torch.Generator().manual_seed(20 + i))
        state_dicts[mode] = model.state_dict()
        jax_steps_in[mode] = to_jax(state_dicts[mode])
    steps = {"num_classes": NUM_CLASSES, "drop_rate": 0.1, "schedule": SCHEDULE,
             "state_dicts": state_dicts,
             "batches": {"feature": {k: v for k, v in feature.items() if k not in EXTRA},
                         "dual": feature, "raw": raw}}
    jmodel = JaxSmallSslAsr()
    v = jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 40, 512)), jnp.ones((1,)), False)
    params, stats = with_teeth(v["params"], v["batch_stats"], np.random.default_rng(4))
    pool = {"num_classes": NUM_CLASSES, "state_dict": from_jax(params, stats), "threshold": 1e9,
            "run_dir": str(tmp_path_factory.mktemp("pool_run")),
            "datamodule": dict(train_manifest=str(m["train"]), labels=LABELS, dev_bs=4,
                               ssl_folder=str(root / "feats"), pseudo_manifest=str(m["pool"]),
                               bucket_seconds=(2.0,))}
    return {"steps": steps, "pool": pool, "jax": (jmodel, params, stats),
            "jax_steps": jax_steps_in}


@pytest.fixture(scope="module")
def ssl_ranks(ssl_input, tmp_path_factory):
    return run_ranks("ssl", {k: ssl_input[k] for k in ("steps", "pool")},
                     tmp_path_factory.mktemp("ssl_ranks"))


def test_two_rank_ssl_steps_match_one_process(ssl_input, ssl_ranks):
    """One float32 step of each SSL mode (feature: cutout; dual: dither,
    SpecAugment and cutout; raw: the retrain model's cutout; dropout 0.1 in
    each) over 2 ranks of 2 rows, one of them a pad row of 160 frames (or
    160 samples; in dual mode its raw wave of length 0), the feature rows'
    160 past T, against the port's one process on the padded global batch:
    finite, the ranks' states bit for bit, FEATURE_TOL."""
    inp = ssl_input["steps"]
    for mode, batch in inp["batches"].items():
        r0, r1 = (r["steps"][mode] for r in ssl_ranks)
        assert torch.isfinite(r0["loss"]) and int(r0["state"].nan_count) == 0, mode
        assert torch.equal(r0["loss"], r1["loss"]), mode
        for a, b in ((r0["state"].params, r1["state"].params),
                     (r0["state"].batch_stats, r1["state"].batch_stats)):
            assert all(torch.equal(a[k], b[k]) for k in a), mode
        want, want_metrics = ssl_step(mode, inp, batch)
        got = {"loss": r0["loss"], "grad_norm": r0["grad_norm"],
               "preds": torch.cat([r0["preds"], r1["preds"]]),
               "pred_lens": torch.cat([r0["pred_lens"], r1["pred_lens"]])}
        _compare_port(want, want_metrics, r0["state"], got, FEATURE_TOL[0])


@pytest.mark.parametrize("mode", ["feature", "dual", "raw"])
def test_two_rank_ssl_steps_match_jax(ssl_input, ssl_ranks, small_encoder, monkeypatch, mode):
    """One float32 step of the ``mode`` model with every draw off (no
    dither, zero SpecAugment widths, no cutout, no dropout) over 2 ranks
    against the JAX package's jitted step of its twin on the padded global
    batch, which is the batch its trainer shards over its mesh: RECIPE_TOL
    (as ``test_torch_data_parallel`` holds the supervised 2-rank step); the
    ranks' losses bit for bit.  The JAX step's CTC gets its input lengths
    capped at T: the feature and dual pad row's 160 frames pass T = 100,
    and for such a row the JAX Pallas kernel never reaches the last frame
    and gives the loss 1e30, where its scan reference (``ops/ctc.py``) and
    the port's K4 end the row at T (ROADMAP C19)."""
    pallas = jax_steps.ctc_loss
    monkeypatch.setattr(jax_steps, "ctc_loss", lambda log_probs, lens, *a: pallas(
        log_probs, jnp.minimum(lens, log_probs.shape[1]), *a))
    params, stats = ssl_input["jax_steps"][mode]
    jmodel = _jax_ssl_models()[mode]
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                                    fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    if mode == "feature":
        jstep = jax_make_train_step(jmodel, jopt, NUM_CLASSES - 1, augment=None,
                                    from_features=True, normalize=False)
    elif mode == "dual":
        monkeypatch.setattr(jax_steps, "cutout", lambda feats, *a, **k: feats)
        jstep = jax_make_dual_train_step(jmodel, jopt, NUM_CLASSES - 1,
                                         dataclasses.replace(JAX_DUAL_MEL, dither=0.0),
                                         freq_mask=0, time_mask=0)
    else:
        jstep = jax_make_raw_train_step(jmodel, jopt, NUM_CLASSES - 1)
    batch = {k: jnp.asarray(v.numpy()) for k, v in ssl_input["steps"]["batches"][mode].items()}
    jstate, jmetrics = jax.jit(jstep)(jstate, batch, jax.random.PRNGKey(0))

    r0, r1 = (r["plain_steps"][mode] for r in ssl_ranks)
    assert torch.equal(r0["loss"], r1["loss"])
    got = {"loss": r0["loss"], "grad_norm": r0["grad_norm"],
           "preds": torch.cat([r0["preds"], r1["preds"]]),
           "pred_lens": torch.cat([r0["pred_lens"], r1["pred_lens"]])}
    compare_step(jstate, jmetrics, r0["state"], got, RECIPE_TOL[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_one_rank_is_the_step_without_the_flag(ssl_input):
    """In a gloo group of one rank, ``data_parallel=True`` gives each SSL
    mode's step without it bit for bit (loss, state, gradients)."""
    distributed.init({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                      "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}, "cpu", 60.0)
    try:
        inp = ssl_input["steps"]
        for mode, batch in inp["batches"].items():
            got, got_metrics = ssl_step(mode, inp, batch, data_parallel=True)
            want, want_metrics = ssl_step(mode, inp, batch)
            assert torch.equal(got_metrics["loss"], want_metrics["loss"]), mode
            for a, b in ((got.params, want.params), (got.batch_stats, want.batch_stats),
                         (got.opt_state[0], want.opt_state[0])):
                assert all(torch.equal(a[k], b[k]) for k in b), mode
    finally:
        distributed.shutdown()
    assert distributed.current() is None


# --- the pseudo-label pool ---

class _Rows:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append(dict(metrics))


def test_pseudo_pool_over_two_ranks_equals_one_process_and_jax(ssl_input, ssl_ranks, tmp_path):
    """The pass over a pool of 5 in batches of 4 (the second a global
    batch of 2 over 2 ranks: rank 1's share holds only a pad row, which it
    skips), threshold 1e9: the 2-rank
    pool equals one process's (paths, texts, durations, in the pool
    loader's order) on both ranks, counted once on rank 0; one process's
    equals JAX's ``SSLTrainer._pseudo_pass`` on the same weights; the pool
    is not empty."""
    inp = ssl_input["pool"]
    jmodel, params, stats = ssl_input["jax"]
    model = ssl_model("feature", NUM_CLASSES)
    model.load_state_dict(inp["state_dict"])
    one = SSLTrainer(model, novograd(1e-3), SSLDataModule(**inp["datamodule"]),
                     run_dir=tmp_path / "one", loggers=_Rows(),
                     pseudo_confidence_threshold=inp["threshold"])
    one._pseudo_pass(one.init_state())
    pool = [(e.audio_filepath, e.text, e.duration) for e in one.dm.pseudo_entries]

    jt = JaxSSLTrainer.__new__(JaxSSLTrainer)
    jt.dm = JaxSSLDataModule(**inp["datamodule"])
    jt.vocab, jt.loggers = jt.dm.vocab, _Rows()
    jt.pseudo_confidence_threshold, jt.pseudo_confidence_measure = inp["threshold"], "ref"
    jt._device_batch = lambda batch: {k: jnp.asarray(getattr(batch, k)) for k in FIELDS}
    jt._eval_step = jax.jit(jax_make_eval_step(jmodel, NUM_CLASSES - 1, from_features=True,
                                               normalize=False))
    jt._pseudo_pass(JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                             opt_state=None, nan_count=jnp.zeros((), jnp.int32)))
    jax_pool = [(e.audio_filepath, e.text, e.duration) for e in jt.dm.pseudo_entries]

    assert len(pool) > 0 and pool == jax_pool
    r0, r1 = (r["pool"] for r in ssl_ranks)
    assert r0["pool"] == r1["pool"] == pool
    assert r0["logged"] == one.loggers.rows == jt.loggers.rows == [
        {"pseudo_kept": len(pool), "pseudo_total": 5}]
    assert r1["logged"] == []


# --- the entry points ---

def _cli_args(corpus, run, *extra):
    root, m = corpus
    return [f"data.train_manifest={m['train']}", f"data.val_manifest={m['dev']}",
            f"data.test_manifest={m['dev']}", f"ssl.feature_folder={root / 'feats'}",
            "data.bucket_seconds=[2.0]", "train.train_batch_size=4", "train.dev_batch_size=4",
            "train.warmup_steps=1", "train.log_every_n_steps=1", "model.compute_dtype=f32",
            f"log.run.dir={run}", "train.dist_timeout_s=120", *extra]


def _metrics(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_train_ssl_with_pseudo_labels_over_two_ranks(corpus, tmp_path):
    """``python -m lightning_asr_torch.train_ssl --device cpu`` as 2 ranks of
    a launcher (each rank's ``main``), 2 epochs with a pseudo pass after
    each (threshold 1e9): both ranks report the same val and test metrics
    and inject the same pool, rank 0 alone writes ``last`` (once an epoch)
    and the metrics, whose ``pseudo_total`` counts the pool of 5 once."""
    root, m = corpus
    run = tmp_path / "run"
    args = _cli_args(corpus, run, "train.total_epoch=2", f"data.pseudo_manifest={m['pool']}",
                     "ssl.pseudo_start_epoch=0", "ssl.pseudo_every_n_epochs=1",
                     "ssl.pseudo_confidence_threshold=1e9", "--device", "cpu")
    r0, r1 = run_ranks("cli", {"module": "lightning_asr_torch.train_ssl", "args": args}, tmp_path)
    assert r0["data_parallel"] and r1["data_parallel"]
    assert r0["val"] == r1["val"] and len(r0["val"]) == 2 and r0["test"] == r1["test"]
    assert np.isfinite(r0["test"]["test_loss"])
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert r0["pseudo"] == r1["pseudo"] and len(r0["pseudo"]) > 0
    assert r0["batches"] == r1["batches"] == [1, (7 + len(r0["pseudo"])) // 4]
    assert [len(r0["writes"]), len(r1["writes"])] == [2, 0]
    rows = [r for r in _metrics(run) if "pseudo_total" in r]
    assert [r["pseudo_total"] for r in rows] == [5, 5]
    sd, meta = load_checkpoint(run / "checkpoints" / "last")
    assert meta["epoch"] == 1 and all(torch.equal(sd[k], v) for k, v in r0["params"].items())


def test_train_ssl_double_starts_its_second_rank(corpus, tmp_path, monkeypatch):
    """``python -m lightning_asr_torch.train_ssl_double train.n_devices=2
    --device cpu`` through ``main()``: this process is rank 0 and starts
    rank 1; one epoch over 2 ranks of 2 rows, a validation and a test pass;
    rank 0 returns, alone wrote the metrics and ``last``, and the group is
    gone after."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = tmp_path / "run"
    out = double_main(_cli_args(corpus, run, "train.total_epoch=1", "train.n_devices=2",
                                "--device", "cpu"))
    assert distributed.current() is None and not torch.distributed.is_initialized()
    assert out["trainer"].data_parallel and int(out["state"].step) == 1
    assert np.isfinite(out["test"]["test_loss"])
    rows = _metrics(run)
    assert sum("train_loss" in r for r in rows) == 1 and sum("val_loss" in r for r in rows) == 1
    sd, _ = load_checkpoint(run / "checkpoints" / "last")
    assert all(torch.equal(sd[k], v) for k, v in out["state"].params.items())


@pytest.mark.parametrize("entry", [ssl_main, double_main])
def test_entry_points_stay_on_one_host(corpus, tmp_path, entry):
    """``train.num_nodes`` > 1 is refused before any rank starts, as is a
    ``--device`` other than cpu or cuda when there are ranks."""
    args = _cli_args(corpus, tmp_path / "run", "--device", "cpu")
    with pytest.raises(RuntimeError, match="one host"):
        entry(args + ["train.num_nodes=2"])
    with pytest.raises(ValueError, match="cuda:1"):
        entry(_cli_args(corpus, tmp_path / "run", "train.n_devices=2", "--device", "cuda:1"))
    assert distributed.current() is None


def test_ssl_trainer_refuses_accumulation_over_ranks(monkeypatch):
    """The SSL batchers lay out a rank's rows for one micro-batch, so
    ``accumulate_grad_batches`` > 1 over several ranks is refused."""
    monkeypatch.setattr(distributed, "data_size", lambda: 2)
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        SSLTrainer(None, None, None, accumulate_grad_batches=2)


# --- the Flask route ---

class _FakeFlask:
    """``flask.Flask``'s surface that ``create_flask_app`` uses."""

    def __init__(self, name):
        self.routes, self.ran = {}, None

    def route(self, path, methods):
        def register(fn):
            self.routes[(path, tuple(methods))] = fn
            return fn
        return register

    def run(self, host, port):
        self.ran = (host, port)


class _Upload:
    def __init__(self, data: bytes):
        self.data = data

    def save(self, stream):
        stream.write(self.data)


@pytest.fixture
def fake_flask(monkeypatch):
    mod = types.ModuleType("flask")
    mod.request = types.SimpleNamespace(files={})
    apps = []
    mod.Flask = lambda name: apps.append(_FakeFlask(name)) or apps[-1]
    mod.apps = apps
    monkeypatch.setitem(sys.modules, "flask", mod)
    return mod


class _Translator:
    def __init__(self):
        self.got = []

    def translate(self, audio):
        self.got.append(audio.read())
        return "a cat"


def test_flask_route_returns_the_translation(fake_flask):
    translator = _Translator()
    app = server.create_flask_app(translator)
    fake_flask.request.files["audio"] = _Upload(b"RIFF....WAVE")
    assert app.routes[("/", ("POST",))]() == "a cat"
    assert translator.got == [b"RIFF....WAVE"]


@pytest.mark.parametrize("case", ["flask", "batching", "warmup", "no_flask"])
def test_serve_picks_flask_by_the_jax_rule(fake_flask, monkeypatch, case):
    """``serve(use_flask=None)``: the Flask app's ``run`` when ``flask``
    imports, batching is off and no warmup is asked; else the stdlib
    server."""
    stdlib = []

    class Stdlib:
        def serve_forever(self):
            stdlib.append("served")

        def server_close(self):
            pass

    monkeypatch.setattr(server, "make_stdlib_server", lambda *a, **k: stdlib.append(k) or Stdlib())
    monkeypatch.setattr(server, "AsrTranslator", lambda path, **kw: _Translator())
    if case == "no_flask":
        monkeypatch.setitem(sys.modules, "flask", None)        # import flask raises
    server.serve("unused", host="127.0.0.1", port=5001,
                 batching="on" if case == "batching" else "off",
                 warmup_seconds=[1.0] if case == "warmup" else None)
    if case == "flask":
        assert stdlib == [] and fake_flask.apps[0].ran == ("127.0.0.1", 5001)
    else:
        assert fake_flask.apps == [] and stdlib[-1] == "served"
        assert stdlib[0]["batching"] is (case == "batching")
