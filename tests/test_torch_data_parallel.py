"""The port's data parallelism on the CPU (``lightning_asr_torch/parallel/``,
the sharded ``BucketBatcher``, the global ``MaskedBatchNorm``, the
data-parallel train step, ``Trainer`` and ``train.py`` over ranks).

Ranks are worker processes (``torch_dp_worker.py``, which imports only torch
and the port) in a gloo group on 127.0.0.1; each spawn has a timeout.  The
model of the step and trainer tests is ``torch_dp_worker.SmallAsr`` (a few
narrow blocks with the BiLSTM), and its JAX twin below has the same
parameter tree, so ``utils/jax_params.py`` carries the weights across.

Tolerances:
  * global BatchNorm against the one-process module on the whole batch:
    1e-6 (output, running statistics, input and weight gradients; the
    ranks' partial sums are added in another order);
  * one float32 step over 2 ranks against JAX's ``make_train_step`` on the
    global batch: ``RECIPE_TOL`` of ``test_torch_train_step.py`` (the
    "default" frontend tier's bf16 rounding flips), and against the port's
    one-process step: ``FEATURE_TOL`` (the same features; reduction order
    only);
  * with dither and SpecAugment on, the 2-rank losses against the 1-rank
    losses: 1e-5 relative (the draws are the same numbers: the ranks draw
    for the global rows);
  * ``Trainer.fit`` over 2 ranks: the ranks' losses bit for bit, against one
    process at rtol 1e-4 (``tests/test_multihost.py``'s bound).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.data.pipeline import BucketBatcher as JaxBucketBatcher
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.models import layers as jl
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_train_step as jax_make_train_step
from lightning_asr_torch.data.datamodule import AsrDataModule
from lightning_asr_torch.data.manifest import read_manifests
from lightning_asr_torch.data.pipeline import BucketBatcher
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.models.layers import MaskedBatchNorm
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.parallel import distributed
from lightning_asr_torch.parallel.mesh import RowShard, draw, local_rows, row_shard
from lightning_asr_torch.train import main
from lightning_asr_torch.training.checkpoint import load_checkpoint
from lightning_asr_torch.training.steps import create_train_state, make_train_step
from lightning_asr_torch.training.trainer import Trainer
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import with_teeth
from test_torch_pipeline import LABELS, tone_corpus
from test_torch_train_step import (FEATURE_TOL, FRONTEND, RECIPE_TOL, SCHEDULE, compare_step,
                                   jax_batch, jax_capture, make_batch, port_batch)
from torch_dp_worker import SmallAsr, capture

WORKER = Path(__file__).with_name("torch_dp_worker.py")
ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
NUM_CLASSES = len(LABELS) + 1
BLANK = NUM_CLASSES - 1
BN_TOL = 1e-6
AUGMENTED_LOSS_RTOL = 1e-5
FIT_RTOL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, inp: dict, tmp_path: Path, world: int = 2) -> list:
    """Run ``task`` of ``torch_dp_worker.py`` on ``world`` gloo ranks;
    returns each rank's results."""
    src = tmp_path / f"{task}_in.pt"
    torch.save(inp, src)
    outs = [tmp_path / f"{task}_out{r}.pt" for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), task, str(r), str(world), str(port),
                               str(src), str(outs[r])], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


# --- the row layout, the launcher's environment, the backend rule ---

def test_local_rows_layout():
    np.testing.assert_array_equal(local_rows(8, 1, 2), [4, 5, 6, 7])
    np.testing.assert_array_equal(local_rows(8, 0, 2, 2), [0, 1, 4, 5])
    np.testing.assert_array_equal(local_rows(8, 1, 2, 2), [2, 3, 6, 7])
    for world, k in ((1, 1), (2, 1), (2, 2), (4, 2)):
        rows = np.concatenate([local_rows(16, r, world, k) for r in range(world)])
        np.testing.assert_array_equal(np.sort(rows), np.arange(16))
        # rank r's micro-batch i is its share of global micro-batch i
        for r in range(world):
            for i, part in enumerate(np.split(local_rows(16, r, world, k), k)):
                assert set(part) <= set(range(i * 16 // k, (i + 1) * 16 // k))
    with pytest.raises(ValueError):
        local_rows(6, 0, 4)


def test_draws_are_the_global_rows():
    """Inside ``row_shard`` a draw keeps the rank's rows of the global draw,
    on either batch axis; outside it is ``torch.rand``'s."""
    want = torch.rand((3, 8), generator=torch.Generator().manual_seed(1))
    assert torch.equal(draw((3, 8), torch.Generator().manual_seed(1), "cpu", axis=-1), want)
    rows = torch.as_tensor(local_rows(8, 1, 2, 2))
    with row_shard(RowShard(rows, 8, 2)):
        got = draw((3, 4), torch.Generator().manual_seed(1), "cpu", axis=-1)
        normal = draw((4, 5), torch.Generator().manual_seed(2), "cpu", normal=True)
        with pytest.raises(ValueError):
            draw((3, 5), torch.Generator(), "cpu", axis=-1)
    assert torch.equal(got, want[:, rows])
    assert torch.equal(normal, torch.randn((8, 5), generator=torch.Generator().manual_seed(2))[rows])


def test_launcher_env_and_backend_rule():
    assert distributed.launcher_env({}) is None
    full = {"RANK": "1", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
            "MASTER_PORT": "1"}
    assert distributed.launcher_env(full)["LOCAL_WORLD_SIZE"] == "4"
    assert distributed.launcher_env({**full, "LOCAL_WORLD_SIZE": "2"})["LOCAL_WORLD_SIZE"] == "2"
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        distributed.launcher_env({k: v for k, v in full.items() if k != "MASTER_PORT"})
    assert distributed.backend_for("cpu", 2, 0) == "gloo"
    assert distributed.backend_for("cuda", 8, 8) == "nccl"       # a card each
    assert distributed.backend_for("cuda", 1, 1) == "nccl"
    assert distributed.backend_for("cuda", 2, 1) == "gloo"       # ranks share a card
    with pytest.raises(RuntimeError, match="no card"):
        distributed.backend_for("cuda", 1, 0)
    # no group: one rank, and the helpers are the one-process computation
    assert distributed.current() is None and distributed.world() == 1 and distributed.is_primary()
    t = torch.ones(3)
    assert distributed.all_reduce_(t) is t and torch.equal(t, torch.ones(3))
    assert distributed.broadcast_str("x") == "x"


# --- the batcher ---

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_corpus")
    return tone_corpus(root, 16, 0, name="train"), tone_corpus(root, 8, 1, name="dev")


def _batchers(entries, cls, vocab, **kw):
    return cls(entries, vocab, 8, train=True, crop=True, seed=3, bucket_seconds=(2.0,), **kw)


@pytest.mark.parametrize("wire", ["int16", "mulaw8"])
def test_rank_slices_equal_the_global_batches_and_jax(corpus, wire):
    """Two ranks' batches, concatenated, are the one-rank batches and the
    JAX batcher's shards on the same manifest (``tests/test_multihost.py``'s
    check): the same plan, order and shapes."""
    entries = read_manifests([str(corpus[0])], 16.7)
    vocab, jvocab = Vocabulary.from_config(LABELS), JaxVocabulary.from_config(LABELS)
    full = list(_batchers(entries, BucketBatcher, vocab, wire_dtype=wire))
    shards = [list(_batchers(entries, BucketBatcher, vocab, wire_dtype=wire, shard_rank=r,
                             shard_count=2, pad_to=2)) for r in range(2)]
    jshards = [list(_batchers(entries, JaxBucketBatcher, jvocab, wire_dtype=wire, shard_rank=r,
                              shard_count=2, pad_to=2)) for r in range(2)]
    assert len(full) == len(shards[0]) == len(shards[1]) == 2
    for b, s0, s1, j0, j1 in zip(full, *shards, *jshards):
        assert s0.global_size == s1.global_size == 8 and s0.valid_size == s1.valid_size == 4
        for key in ("waves", "wave_lens", "prev_samples", "targets", "target_lens"):
            np.testing.assert_array_equal(np.concatenate([getattr(s0, key), getattr(s1, key)]),
                                          getattr(b, key), err_msg=key)
            for s, j in ((s0, j0), (s1, j1)):
                np.testing.assert_array_equal(getattr(s, key), getattr(j, key), err_msg=key)
        assert s0.paths + s1.paths == b.paths


def test_micro_batch_layout_and_padded_tail(corpus):
    """With 2 micro-batches rank r holds its share of each; a global batch
    that does not fill the ranks gets pad rows (``wave_lens`` 160,
    ``target_lens`` 0) at each rank's end, as the JAX batcher's."""
    entries = read_manifests([str(corpus[0])], 16.7)
    vocab = Vocabulary.from_config(LABELS)
    full = list(_batchers(entries, BucketBatcher, vocab))
    for r in range(2):
        mine = list(_batchers(entries, BucketBatcher, vocab, shard_rank=r, shard_count=2,
                              pad_to=2, micro_batches=2))
        for b, s in zip(full, mine):
            np.testing.assert_array_equal(s.waves, b.waves[local_rows(8, r, 2, 2)])
    tail = read_manifests([str(corpus[1])], 16.7)[:5]          # 5 rows, eval, batch 8
    jvocab = JaxVocabulary.from_config(LABELS)
    for r, valid in ((0, 4), (1, 1)):
        kw = dict(train=False, crop=False, seed=0, bucket_seconds=(2.0,), shard_rank=r,
                  shard_count=2, pad_to=8)
        b = next(iter(BucketBatcher(tail, vocab, 8, **kw)))
        j = next(iter(JaxBucketBatcher(tail, jvocab, 8, **kw)))
        assert b.global_size == 8 and b.valid_size == b.size == valid and b.waves.shape[0] == 4
        assert (b.wave_lens[valid:] == 160).all() and (b.target_lens[valid:] == 0).all()
        for key in ("waves", "wave_lens", "prev_samples", "targets", "target_lens"):
            np.testing.assert_array_equal(getattr(b, key), getattr(j, key), err_msg=key)


# --- global BatchNorm ---

def test_masked_batchnorm_global_statistics(tmp_path):
    """``MaskedBatchNorm`` over 2 gloo ranks (the rank's rows inside
    ``row_shard``) against the one-process module on the whole batch: output,
    running statistics, input gradient and the summed weight and bias
    gradients, within 1e-6; without a shard the module is unchanged."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 5, 7), generator=gen) * 3 + 1
    cot = torch.randn(x.shape, generator=gen)
    bn = MaskedBatchNorm(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0, 0.2, generator=gen)
        bn.running_mean.normal_(0, 0.5, generator=gen)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    bn.train()
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * cot).sum().backward()
    ranks = run_ranks("bn", {"x": x, "cotangent": cot, "state": state}, tmp_path)
    for out in ranks:
        rows = out["rows"]
        for key, want in (("y", y.detach()[rows]), ("x_grad", xg.grad[rows]),
                          ("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad),
                          ("running_mean", bn.running_mean), ("running_var", bn.running_var)):
            err = (out[key] - want).abs().max().item()
            assert err <= BN_TOL * max(1.0, want.abs().max().item()), (key, err)
    assert torch.equal(ranks[0]["running_var"], ranks[1]["running_var"])


# --- the train step ---

class JaxSmallEncoder(fnn.Module):
    """``torch_dp_worker.SmallEncoder`` in flax; it takes the fields the JAX
    models pass an encoder of ``quartznet._ENCODERS`` (no dropout)."""

    in_c: int = 64
    drop_rate: float = 0.0
    mask: bool = True

    @fnn.compact
    def __call__(self, x, percents, train):
        x = jl.SepConv(self.in_c, 32, k=11, stride=2, mask=True, drop_rate=0.0, name="first_cnn")(
            x, percents, train)
        x = jl.QuartNetBlock(repeat=2, in_ch=32, out_ch=32, k=7, mask=True, name="block1")(
            x, percents, train)
        c = jl.BatchLSTM(32, 8, name="context_rnn")(
            x.astype(jnp.float32), jl._lengths_from_percents(x.shape[1], percents))
        x = jnp.concatenate([x, c.astype(x.dtype)], axis=-1)
        return jl.QuartNetBlock(repeat=1, in_ch=48, out_ch=64, k=5, mask=True, name="block2")(
            x, percents, train)


class JaxSmallAsr(fnn.Module):
    """``torch_dp_worker.SmallAsr`` in flax, with the same parameter tree."""

    @fnn.compact
    def __call__(self, x, percents, train=False):
        x = JaxSmallEncoder(name="encoder")(x, percents, train).astype(jnp.float32)
        x = fnn.Conv(NUM_CLASSES, (1,), use_bias=True, kernel_init=jl.torch_uniform_init(64),
                     bias_init=jl.torch_uniform_init(64), name="decoder")(x)
        log_probs = fnn.log_softmax(x, axis=-1)
        return log_probs, jl._lengths_from_percents(log_probs.shape[1], percents)


@pytest.fixture(scope="module")
def small_weights():
    model = JaxSmallAsr()
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 64)), jnp.ones((1,)), False)
    params, stats = with_teeth(v["params"], v["batch_stats"], np.random.default_rng(2))
    return params, stats, from_jax(params, stats)


def _port_one_process(state_dict, batch, accum, augment=None, frontend=FRONTEND, steps=1):
    model = SmallAsr(NUM_CLASSES)
    model.load_state_dict(state_dict)
    opt = capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                           weight_decay=1e-3, fused=True))
    step = make_train_step(model, opt, BLANK, MelFrontendConfig(**frontend), augment=augment,
                           accum_steps=accum)
    state = create_train_state(model, opt)
    losses = []
    for i in range(steps):
        state, metrics = step(state, port_batch(batch), torch.Generator().manual_seed(100 + i))
        losses.append(metrics["loss"])
    return state, metrics, torch.stack(losses)


def _global_metrics(ranks):
    """The ranks' metrics with preds and pred_lens in global row order."""
    order = torch.argsort(torch.cat([r["rows"] for r in ranks]))
    return {"loss": ranks[0]["losses"][-1], "grad_norm": ranks[0]["grad_norms"][-1],
            "preds": torch.cat([r["preds"] for r in ranks])[order],
            "pred_lens": torch.cat([r["pred_lens"] for r in ranks])[order]}


def _step_input(state_dict, batch, accum, augment=None, frontend=FRONTEND, steps=1):
    return {"num_classes": NUM_CLASSES, "state_dict": state_dict, "schedule": SCHEDULE,
            "frontend": frontend, "augment": augment, "accum": accum, "steps": steps,
            "batch": port_batch(batch)}


@pytest.mark.parametrize("accum", [1, 2])
def test_two_rank_step_matches_jax_and_one_process(small_weights, tmp_path, accum):
    """One float32 step (no dither, augmentation or dropout) over 2 ranks of
    2 rows each against JAX's jitted step on the global batch of 4
    (RECIPE_TOL) and against the port's one-process step (FEATURE_TOL); the
    two ranks' losses, parameters and statistics bit for bit.  With
    ``accum`` 2, micro-batch i on each rank is its share of JAX's
    micro-batch i."""
    params, stats, state_dict = small_weights
    batch = make_batch(3, B=4, lens=(15000, 11000, 13500, 9000), tlens=(14, 9, 12, 7))
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                                    fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(JaxSmallAsr(), jopt, BLANK, JaxMelConfig(**FRONTEND),
                                        augment=None, accum_steps=accum))
    jstate, jmetrics = jstep(jstate, jax_batch(batch), jax.random.PRNGKey(0))

    ranks = run_ranks("step", _step_input(state_dict, batch, accum), tmp_path)
    r0, r1 = (r["state"] for r in ranks)
    assert torch.equal(ranks[0]["losses"], ranks[1]["losses"])
    for a, b in ((r0.params, r1.params), (r0.batch_stats, r1.batch_stats)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    metrics = _global_metrics(ranks)
    compare_step(jstate, jmetrics, r0, metrics, RECIPE_TOL[0])

    one, one_metrics, _ = _port_one_process(state_dict, batch, accum)
    _compare_port(one, one_metrics, r0, metrics, FEATURE_TOL[0])


def _compare_port(want, want_metrics, got, got_metrics, tol):
    """``compare_step``'s checks between two port steps."""
    rel = lambda a, b: float((a - b).norm() / max(b.norm(), 1e-30))  # noqa: E731
    loss, want_loss = float(got_metrics["loss"]), float(want_metrics["loss"])
    assert abs(loss - want_loss) <= tol["loss"] * abs(want_loss), (loss, want_loss)
    assert rel(got_metrics["grad_norm"], want_metrics["grad_norm"]) <= tol["grad_norm"]
    grads = {k: rel(got.opt_state[0][k], want.opt_state[0][k]) for k in want.opt_state[0]}
    worst = max(grads, key=grads.get)
    assert grads[worst] <= tol["grad"], (worst, grads[worst])
    assert max((got.params[k] - want.params[k]).abs().max().item() for k in want.params) <= tol["params"]
    assert max(rel(got.batch_stats[k], want.batch_stats[k]) for k in want.batch_stats) <= tol["stats"]
    assert torch.equal(got_metrics["pred_lens"], want_metrics["pred_lens"])
    assert (got_metrics["preds"] == want_metrics["preds"]).float().mean().item() >= tol["preds"]
    assert int(got.step) == int(want.step) and int(got.opt_state[1].count) == int(want.opt_state[1].count)


def test_two_rank_losses_with_dither_and_specaugment(small_weights, tmp_path):
    """Two steps with dither and SpecAugment on: each rank draws for the
    global rows and keeps its own, so the 2-rank losses equal the one-process
    losses on the global batch up to the order of the sums (1e-5)."""
    _, _, state_dict = small_weights
    batch = make_batch(4, B=4, lens=(15000, 11000, 13500, 9000), tlens=(14, 9, 12, 7))
    frontend = {"dither": 1e-5, "precision": "default"}
    ranks = run_ranks("step", _step_input(state_dict, batch, 1, "specaugment", frontend, 2), tmp_path)
    _, _, one = _port_one_process(state_dict, batch, 1, "specaugment", frontend, 2)
    assert torch.equal(ranks[0]["losses"], ranks[1]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"].numpy(), one.numpy(), rtol=AUGMENTED_LOSS_RTOL)
    # the draws matter: without SpecAugment the losses move
    _, _, plain = _port_one_process(state_dict, batch, 1, None, frontend, 2)
    assert not np.allclose(plain.numpy(), one.numpy(), rtol=1e-3)


# --- the trainer and the CLI ---

def _fit_input(corpus, state_dict, run_dir):
    train, dev = corpus
    return {"num_classes": NUM_CLASSES, "state_dict": state_dict, "schedule": SCHEDULE,
            "run_dir": str(run_dir),
            "datamodule": dict(train_manifest=str(train), dev_manifest=str(dev),
                               test_manifest=str(dev), labels=LABELS, train_bs=8, dev_bs=8,
                               bucket_seconds=(2.0,), seed=1)}


def test_trainer_fit_over_two_ranks(corpus, small_weights, tmp_path):
    """``Trainer.fit`` for one epoch (2 steps of 8 rows, augmentation and
    dither on) over 2 ranks: the ranks' losses and parameters bit for bit,
    equal to one process at rtol 1e-4; the val metrics the same on both
    ranks, by JAX's reduction (sums over the ranks' batches, then the
    ratios), equal to one process's val_loss and corpus WER; rank 0 alone
    writes the checkpoint, once, and logs."""
    _, _, state_dict = small_weights
    inp = _fit_input(corpus, state_dict, tmp_path / "dp")
    ranks = run_ranks("fit", inp, tmp_path)
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2 and r0["step"] == 2
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    assert r0["val"] == r1["val"]
    wers = r0["batch_wers"] + r1["batch_wers"]
    assert r0["val"]["val_wer"] == pytest.approx(sum(wers) / len(wers), rel=1e-12)
    assert [len(r["writes"]) for r in ranks] == [1, 0]
    assert r1["logged"] == [] and any("val_loss" in m for _, m in r0["logged"])
    sd, meta = load_checkpoint(tmp_path / "dp" / "checkpoints" / "last")
    assert meta["epoch"] == 0 and all(torch.equal(sd[k], r0["params"][k]) for k in r0["params"])

    model = SmallAsr(NUM_CLASSES)
    model.load_state_dict(state_dict)
    sched = cosine_annealing_warmup_restarts(**SCHEDULE)
    trainer = Trainer(model, novograd(sched, betas=(0.8, 0.5), weight_decay=1e-3, fused=True),
                      AsrDataModule(**inp["datamodule"]), total_epochs=1, run_dir=tmp_path / "one",
                      log_every_n_steps=1, train_wer_every_n_steps=10**6, lr_schedule=sched,
                      hparams={"labels": LABELS}, seed=4)
    state = trainer.fit()
    np.testing.assert_allclose(r0["losses"], trainer.epoch_stats[0]["losses"], rtol=FIT_RTOL)
    val = trainer.validate(state)
    np.testing.assert_allclose(r0["val"]["val_loss"], val["val_loss"], rtol=FIT_RTOL)
    np.testing.assert_allclose(r0["val"]["val_wer_corpus"], val["val_wer_corpus"], atol=1e-6)


def _cli_args(corpus, run_dir):
    train, dev = corpus
    return [f"data.train_manifest={train}", f"data.val_manifest={dev}",
            f"data.test_manifest={dev}", "train.total_epoch=1", "train.train_batch_size=8",
            "train.dev_batch_size=8", f"log.run.dir={run_dir}", "data.bucket_seconds=[2.0]",
            "train.log_every_n_steps=1", "train.warmup_steps=1", "train.limit_train_batches=1",
            "model.compute_dtype=f32", "train.dist_timeout_s=120"]


def test_cli_starts_two_gloo_ranks(corpus, tmp_path, monkeypatch):
    """``python -m lightning_asr_torch.train --device cpu train.n_devices=2``
    through ``main()``: this process is rank 0 and starts rank 1; one step of
    the full-width model over 2 ranks of 4 rows, a validation and a test
    pass; rank 0 returns, alone wrote the metrics and ``last``, and the
    group is gone after."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = tmp_path / "run"
    out = main(_cli_args(corpus, run) + ["train.n_devices=2", "--device", "cpu"])
    assert distributed.current() is None and not torch.distributed.is_initialized()
    assert int(out["state"].step) == 1 and out["trainer"].data_parallel
    assert np.isfinite(out["test"]["test_loss"])
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert sum("train_loss" in r for r in rows) == 1 and "test_wer" in rows[-1]
    sd, _ = load_checkpoint(run / "checkpoints" / "last")
    assert all(torch.equal(sd[k], v) for k, v in out["state"].params.items())


def test_cli_refuses_tp_and_nodes_without_a_launcher(corpus, tmp_path):
    """``train.tp`` that does not divide ``train.n_devices`` raises, naming
    both, before any rank starts; ``train.num_nodes`` > 1 needs a launcher."""
    args = _cli_args(corpus, tmp_path / "run") + ["--device", "cpu"]
    with pytest.raises(ValueError, match=r"n_devices=2 .*train\.tp=3"):
        main(args + ["train.tp=3", "train.n_devices=2"])
    with pytest.raises(RuntimeError, match="torchrun"):
        main(args + ["train.num_nodes=2"])
    assert distributed.current() is None
