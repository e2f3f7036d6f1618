"""The port's trainer path on the CPU (``lightning_asr_torch/training/
trainer.py``, ``checkpoint.py``, ``train.py``) and the slice against the JAX
package: ``Trainer.fit`` of both on one corpus, step by step.

The model is the full-width ``quartznet12_context`` in float32 on a
tone-language corpus of 1-1.9 s utterances padded to one 2 s bucket, a few
steps an epoch.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.data import AsrDataModule as JaxDataModule
from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.training import Trainer as JaxTrainer
from lightning_asr_tpu.training.loggers import BaseLogger as JaxBaseLogger
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.models.quartznet import build_model, reset_parameters
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.ops.lstm_kernels import lstm_recurrence_stacked
from lightning_asr_torch.optim import (ReduceLROnPlateau, cosine_annealing_warmup_restarts,
                                       novograd, novograd_with_runtime_lr)
from lightning_asr_torch.optim.novograd import FlatLayout, NovogradState
from lightning_asr_torch.train import kernel_switches, main
from lightning_asr_torch.training.checkpoint import TRAIN_STATE_FILE
from lightning_asr_torch.training.loggers import BaseLogger
from lightning_asr_torch.training.steps import create_train_state, make_train_step
from lightning_asr_torch.training.trainer import Trainer
from lightning_asr_torch.utils.jax_params import from_jax, opt_state_from_jax, opt_state_to_jax
from test_torch_pipeline import LABELS, tone_corpus

SCHEDULE = dict(first_cycle_steps=100, cycle_mult=2, max_lr=1e-2, min_lr=1e-4, warmup_steps=3,
                gamma=0.5)
BUCKETS = (2.0,)
SWITCH = "LASR_LSTM_FUSED_BIDIR"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_corpus")
    return tone_corpus(root, 16, 0, name="train"), tone_corpus(root, 8, 1, name="dev")


class Capture(BaseLogger, JaxBaseLogger):
    """Keeps every logged row (both packages' logger interface)."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((int(step), {k: float(v) for k, v in metrics.items()}))

    def train_losses(self):
        return [m["train_loss"] for _, m in self.rows if "train_loss" in m]


def _datamodule(corpus, **kw):
    train, dev = corpus
    return AsrDataModule(train_manifest=str(train), dev_manifest=str(dev), test_manifest=str(dev),
                         labels=LABELS, train_bs=8, dev_bs=8, bucket_seconds=BUCKETS, seed=1, **kw)


def _model(seed=0, **kw):
    model = build_model(len(LABELS) + 1, mask=True, **kw)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model


def _trainer(corpus, run_dir, total_epochs=1, plateau=False, dm_kw=None, **kw):
    model = _model(fuse_directions=True)
    if plateau:
        opt = novograd_with_runtime_lr(1e-2, betas=(0.8, 0.5), weight_decay=1e-3)
        kw.update(plateau=ReduceLROnPlateau(1e-2, patience=0, factor=0.5, cooldown=0))
    else:
        kw.update(lr_schedule=cosine_annealing_warmup_restarts(**SCHEDULE))
        opt = novograd(kw["lr_schedule"], betas=(0.8, 0.5), weight_decay=1e-3)
    return Trainer(model, opt, _datamodule(corpus, **(dm_kw or {})), total_epochs=total_epochs,
                   run_dir=run_dir, log_every_n_steps=1, train_wer_every_n_steps=1,
                   loggers=Capture(), hparams={"labels": LABELS, "mask": True}, seed=4, **kw)


def _equal_trees(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return type(a) is type(b) and all(_equal_trees(x, y) for x, y in zip(a, b))
    return a == b


def test_fit_logs_the_steps_of_make_train_step(corpus, tmp_path):
    """One epoch of two steps (augmentation and dither on): the logged
    losses equal ``make_train_step`` run by hand on the same batches with
    the same per-step generator seeds, bit for bit; the epoch stats count
    the audio."""
    trainer = _trainer(corpus, tmp_path / "run")
    state0 = trainer.init_state()
    state = trainer.fit(initial_state=state0)
    logged = trainer.loggers.train_losses()
    assert len(logged) == 2 and int(state.step) == 2 and trainer.global_step == 2

    step = make_train_step(trainer.model, trainer.optimizer, len(LABELS), MelFrontendConfig())
    by_hand = state0
    for i, batch in enumerate(trainer.dm.train_dataloader(0)):
        by_hand, metrics = step(by_hand, {k: torch.from_numpy(getattr(batch, k)) for k in (
            "waves", "wave_lens", "prev_samples", "targets", "target_lens")},
            torch.Generator().manual_seed(4 * 1_000_003 + i))
        assert float(metrics["loss"]) == logged[i]
    assert _equal_trees(by_hand.params, state.params)
    stats = trainer.epoch_stats[0]
    assert stats["batches"] == 2 and stats["first_step"] == 1 and stats["losses"] == logged
    assert stats["audio_sec"] > 16.0 and stats["audio_sec_per_sec"] > 0
    val = [m for _, m in trainer.loggers.rows if "val_loss" in m][0]
    assert np.isfinite(val["val_loss"]) and np.isfinite(val["val_wer"])
    assert trainer.profiler.counts["train_step"] == 2
    summary = trainer.profiler.summary()
    assert "train_step/backward" in summary and "train_data_wait" in summary


def test_checkpoints_keep_top_k_and_last(corpus, tmp_path):
    trainer = _trainer(corpus, tmp_path / "run", total_epochs=5, checkpoint_top_k=3,
                       limit_train_batches=1)
    trainer.fit()
    ckpts = tmp_path / "run" / "checkpoints"
    index = json.loads((ckpts / "index.json").read_text())
    assert index["last"] == "last" and len(index["saved"]) == 3
    scores = [e["score"] for e in index["saved"]]
    assert scores == sorted(scores)
    dirs = {p.name for p in ckpts.iterdir() if p.is_dir()}
    assert dirs == {"last"} | {e["name"] for e in index["saved"]}
    for e in index["saved"]:
        assert e["name"] == f"asr-epoch{e['epoch']:02d}-val_wer{e['score']:.2f}"
        assert {p.name for p in (ckpts / e["name"]).iterdir()} == {
            "state.pt", "train_state.pt", "metadata.json"}
    meta = json.loads((ckpts / "last" / "metadata.json").read_text())
    assert meta["epoch"] == 4 and meta["hparams"]["labels"] == LABELS
    assert meta["hparams"]["compute_dtype"] == "float32" and "val_wer" in meta["metrics"]


def _start_from_jax(trainer, jax_weights):
    """The trainer's initial state from a JAX train state: its weights, and
    the fused NovoGrad state of one JAX update (through
    ``opt_state_from_jax``) inside the port's runtime-lr wrapper."""
    params, stats = jax_weights
    trainer.model.load_state_dict(from_jax(params, stats), strict=True)
    state = trainer.init_state()
    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    _, jstate = opt.update(grads, opt.init(params), params)
    inner = opt_state_from_jax(jax.device_get(jstate), params, stats, state.params)
    assert int(inner.count) == 1
    return dataclasses.replace(state, opt_state=state.opt_state._replace(inner_state=inner))


def test_resume_continues_bit_for_bit(corpus, tmp_path, jax_weights):
    """Stopping after epoch 1 and resuming from ``last`` reproduces the run
    that never stopped: step, parameters, statistics, the runtime-lr
    NovoGrad state and the plateau controller, bit for bit.  Both runs
    start from JAX's weights and optimizer state.  The plateau watches
    ``val_wer``, which stays 1.0 here, so it halves the lr at epoch 1's
    validation, the last before the resume (ROADMAP.md §C8)."""
    kw = dict(plateau=True, limit_train_batches=1, plateau_monitor="val_wer")
    mono = _trainer(corpus, tmp_path / "mono", total_epochs=3, **kw)
    mono_state = mono.fit(initial_state=_start_from_jax(mono, jax_weights))
    first = _trainer(corpus, tmp_path / "chunk", total_epochs=2, **kw)
    first.fit(initial_state=_start_from_jax(first, jax_weights))
    assert first.plateau.lr == 5e-3                 # dropped at the last validation
    resumed = _trainer(corpus, tmp_path / "chunk", total_epochs=3, **kw)
    state = resumed.fit(resume="last")
    assert resumed.epoch_stats[0]["first_step"] == 3 and int(state.step) == 3
    for field in ("step", "params", "batch_stats", "opt_state", "nan_count"):
        assert _equal_trees(getattr(state, field), getattr(mono_state, field)), field
    assert resumed.plateau.state_dict() == mono.plateau.state_dict()
    assert float(state.opt_state.hyperparams["learning_rate"]) == np.float32(mono.plateau.lr)


def test_restore_migrates_and_rebuilds_p_flat(corpus, tmp_path):
    """Restore into the per-tensor NovoGrad variant (exact), and a saved
    ``p_flat`` of the wrong shape (fault C2) is rebuilt from the params."""
    trainer = _trainer(corpus, tmp_path / "run", limit_train_batches=1)
    state = trainer.fit()
    last = tmp_path / "run" / "checkpoints" / "last"
    per_tensor = create_train_state(trainer.model, novograd(1e-2, fused=False))
    migrated, _ = trainer.checkpoints.restore(per_tensor, "last")
    assert isinstance(migrated.opt_state, NovogradState)
    layout = FlatLayout(state.params)
    assert torch.equal(layout.flatten(migrated.opt_state.exp_avg), state.opt_state.exp_avg)

    raw = torch.load(last / TRAIN_STATE_FILE, weights_only=True)
    raw["opt_state"]["p_flat"] = raw["opt_state"]["p_flat"][:-1]
    torch.save(raw, last / TRAIN_STATE_FILE)
    restored, _ = trainer.checkpoints.restore(trainer.init_state(), "last")
    assert restored.opt_state.p_flat.shape == state.opt_state.p_flat.shape
    assert torch.equal(restored.opt_state.p_flat, layout.flatten(state.params))
    assert torch.equal(restored.opt_state.exp_avg, state.opt_state.exp_avg)


def test_device_cache_replays_the_cached_batches(corpus, tmp_path):
    """After epoch 0 no loader is built: the cached (uncropped) batches are
    replayed, and the crop runs in the step."""
    trainer = _trainer(corpus, tmp_path / "run", total_epochs=2, device_cache=True,
                       check_val_every_n_epoch=2)
    assert trainer.dm.crop is False
    calls = []
    build = trainer.dm.train_dataloader
    trainer.dm.train_dataloader = lambda epoch=0: calls.append(epoch) or build(epoch)
    trainer.fit()
    assert calls == [0] and len(trainer._epoch_cache) == 2
    assert [s["batches"] for s in trainer.epoch_stats] == [2, 2]
    cached = {id(dev["waves"]) for _, dev in trainer._epoch_cache}
    assert len(cached) == 2
    lens = [b.wave_lens for b, _ in trainer._epoch_cache]
    # uncropped: the manifest's full lengths
    want = {int(round(e.duration * 16000)) for e in trainer.dm.train_entries}
    assert {int(n) for row in lens for n in row} <= want


def test_cli_trains_and_the_translator_loads_its_checkpoint(corpus, tmp_path, monkeypatch):
    """``python -m lightning_asr_torch.train --device cpu`` through
    ``main()``: one short epoch with overrides and ``LASR_LSTM_FUSED_BIDIR=1``
    (the model takes K7 / K8's path), checkpoints, a test pass; then
    ``AsrTranslator`` loads its ``last``.  Without ``--device`` it asks for
    the card and raises here."""
    train, dev = corpus
    monkeypatch.setenv(SWITCH, "1")
    args = [f"data.train_manifest={train}", f"data.val_manifest={dev}",
            f"data.test_manifest={dev}", "train.total_epoch=1", "train.train_batch_size=8",
            "train.dev_batch_size=8", f"log.run.dir={tmp_path / 'run'}", "data.bucket_seconds=[2.0]",
            "train.log_every_n_steps=1", "train.warmup_steps=1", "train.limit_train_batches=1",
            "model.compute_dtype=f32"]
    out = main(args + ["--device", "cpu"])
    trainer, state = out["trainer"], out["state"]
    assert trainer.model.encoder.context_rnn.fuse_directions and int(state.step) == 1
    assert np.isfinite(out["test"]["test_loss"])
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 1 and np.isfinite(rows[0]["train_loss"]) and "test_wer" in rows[-1]

    last = tmp_path / "run" / "checkpoints" / "last"
    translator = AsrTranslator(last, device="cpu")
    sd = translator.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in state.params.items())
    text = translator.translate(json.loads(train.read_text().splitlines()[0])["audio_filepath"])
    assert isinstance(text, str) and set(text) <= set(LABELS)

    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)
    assert kernel_switches({}) == {"fuse_directions": False, "conv_kernel": None}
    assert kernel_switches({"LASR_SEPCONV_PALLAS": "1", SWITCH: "1"}) == {
        "fuse_directions": True, "conv_kernel": "sepconv"}
    assert kernel_switches({"LASR_DW_WGRAD_PALLAS": "1"})["conv_kernel"] == "dw_wgrad"
    assert kernel_switches({"LASR_SEPCONV_PALLAS": "1", "LASR_DW_WGRAD_PALLAS": "1"}) == {
        "fuse_directions": False, "conv_kernel": "sepconv"}


@pytest.fixture(scope="module")
def jax_weights():
    model = jax_build_model(len(LABELS) + 1, "quartznet12_context", mask=True)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 64)), jnp.ones((1,)), False)
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def test_fused_novograd_state_bridge_round_trip(jax_weights):
    """A JAX fused NovoGrad state (after one update) maps onto the port's
    layout and back bit for bit, and the mapped momentum is the port's."""
    params, stats = jax_weights
    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    _, jstate = opt.update(grads, opt.init(params), params)
    jstate = jax.device_get(jstate)
    model = build_model(len(LABELS) + 1, mask=True)
    model.load_state_dict(from_jax(params, stats), strict=True)
    template = create_train_state(model, novograd(1e-2, fused=True))
    ported = opt_state_from_jax(jstate, params, stats, template.params)
    assert ported.exp_avg.shape == template.opt_state.exp_avg.shape
    back = opt_state_to_jax(ported, template.params, template.batch_stats)
    for k in ("count", "exp_avg", "exp_avg_sq", "max_exp_avg_sq", "p_flat"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstate, k)), err_msg=k)
    # the momentum of a conv weight, read back in the port's (out, in, k) layout
    m = FlatLayout(template.params).unflatten(ported.exp_avg)
    flax_m = from_jax(jax.tree.map(lambda p: np.zeros_like(p), params), stats)
    name = "encoder.first_cnn.depthwise_conv.weight"
    assert m[name].shape == flax_m[name].shape == template.params[name].shape


def test_fit_matches_the_jax_trainer(corpus, tmp_path, jax_weights):
    """The slice against the JAX package: ``Trainer.fit`` of both for one
    epoch (two steps of 8 rows, one bucket) from the same weights, with
    augmentation, dither, crop and dropout off and the stacked BiLSTM on both
    sides (``LASR_LSTM_FUSED_BIDIR=1``; ``fuse_directions=True``): the train
    losses step by step, ``val_loss`` and ``val_wer``, within the float32
    train-step bounds of ``test_torch_train_step.py`` (loss 1e-5 relative)."""
    params, stats = jax_weights
    train, dev = corpus
    frontend = dict(dither=0.0)
    common = dict(total_epochs=1, log_every_n_steps=1, train_wer_every_n_steps=1, seed=0,
                  augment=False, hparams={"labels": LABELS})
    old = os.environ.get(SWITCH)
    os.environ[SWITCH] = "1"
    try:
        jdm = JaxDataModule(train_manifest=str(train), dev_manifest=str(dev), labels=LABELS,
                            train_bs=8, dev_bs=8, bucket_seconds=BUCKETS, seed=1, crop=False)
        jmodel = jax_build_model(len(LABELS) + 1, "quartznet12_context", mask=True)
        jsched = jax_schedule(**SCHEDULE)
        jlog = Capture()
        jtrainer = JaxTrainer(jmodel, jax_novograd(jsched, betas=(0.8, 0.5), weight_decay=1e-3,
                                                   fused=True),
                              jdm, run_dir=tmp_path / "jax", loggers=jlog, lr_schedule=jsched,
                              frontend=JaxMelConfig(**frontend), **common)
        jstate = jtrainer.init_state()
        jstate = jstate.replace(params=params, batch_stats=stats)
        jtrainer.fit(initial_state=jstate)
    finally:
        if old is None:
            os.environ.pop(SWITCH, None)
        else:
            os.environ[SWITCH] = old

    model = build_model(len(LABELS) + 1, mask=True, fuse_directions=True)
    model.load_state_dict(from_jax(params, stats), strict=True)
    sched = cosine_annealing_warmup_restarts(**SCHEDULE)
    trainer = Trainer(model, novograd(sched, betas=(0.8, 0.5), weight_decay=1e-3, fused=True),
                      _datamodule(corpus, crop=False), run_dir=tmp_path / "port",
                      loggers=Capture(), lr_schedule=sched, frontend=MelFrontendConfig(**frontend),
                      **common)
    launches = lstm_recurrence_stacked.launches
    trainer.fit()
    assert lstm_recurrence_stacked.launches == launches            # CPU: the plain version

    ours, theirs = trainer.loggers.train_losses(), jlog.train_losses()
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert abs(a - b) <= 1e-5 * abs(b), (ours, theirs)
    val = {k: v for _, m in trainer.loggers.rows for k, v in m.items() if k.startswith("val_")}
    jval = {k: v for _, m in jlog.rows for k, v in m.items() if k.startswith("val_")}
    assert abs(val["val_loss"] - jval["val_loss"]) <= 1e-5 * abs(jval["val_loss"]), (val, jval)
    # greedy texts of both sides: the same WER unless an argmax near a tie flips
    assert abs(val["val_wer"] - jval["val_wer"]) <= 0.02, (val, jval)
