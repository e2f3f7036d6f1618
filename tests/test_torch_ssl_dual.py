"""Parity: the dual-stream SSL path against the JAX package on the CPU:
``DualSSLBucketBatcher``'s batches (features and raw waves) bit for bit,
and the dual train and eval steps (``make_dual_train_step`` /
``make_dual_eval_step`` on ``DualStreamAsrModel``, the mel stream computed
in the step at ``DUAL_MEL_CONFIG``) against JAX's jitted steps, from the
same weights (``from_jax``) and that batch.

Two float32 steps at full width with the augmentation off: no dither, zero
SpecAugment widths, and cutout (which the JAX step always applies) replaced
by the identity on both sides, since ``jax.random`` and ``torch.Generator``
cannot draw the same bits.  The mel stream is computed at the "highest"
tier on both sides (float32 DFT matmuls summed in another order), so each
step is held to ``RECIPE_TOL`` of ``test_torch_train_step.py``; the eval
step from the same initial weights to 1e-4 on the log-probs.  The feature
rows are shorter than their bucket (C5 of ROADMAP.md).
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightning_asr_tpu.training.steps as jax_steps
import lightning_asr_torch.training.steps as port_steps
from lightning_asr_tpu.data.manifest import read_manifests as jax_read_manifests
from lightning_asr_tpu.data.vocab import Vocabulary as JaxVocabulary
from lightning_asr_tpu.models.dual_stream import DUAL_MEL_CONFIG as JAX_DUAL_MEL
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.ssl_codec.dual_datamodule import DualSSLBucketBatcher as JaxDualBatcher
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_torch.data.audio import write_wav
from lightning_asr_torch.data.manifest import read_manifests
from lightning_asr_torch.data.vocab import Vocabulary
from lightning_asr_torch.models.dual_stream import DUAL_MEL_CONFIG
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.ssl_codec.dual_datamodule import DualSSLBucketBatcher
from lightning_asr_torch.training.steps import create_train_state
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, with_teeth
from test_torch_ssl_models import jax_model, port_model
from test_torch_train_step import RECIPE_TOL, SCHEDULE, compare_step, jax_capture, port_capture

LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]
BLANK = NUM_CLASSES - 1
EVAL_TOL = 1e-4


@pytest.fixture(scope="module")
def dual_corpus(tmp_path_factory):
    """Four utterances of 1.0-1.7 s: WAVs and their feature pickles of
    int(duration · 50) frames, a manifest."""
    root = tmp_path_factory.mktemp("dual")
    rng = np.random.default_rng(31)
    feat_dir = root / "feats"
    feat_dir.mkdir()
    rows = []
    for i, dur in enumerate((1.7, 1.2, 1.5, 1.0)):
        path = root / f"utt{i}.wav"
        write_wav(path, (rng.standard_normal(int(dur * 16000)) * 0.1).astype(np.float32), 16000)
        with open(feat_dir / f"utt{i}.pkl", "wb") as f:
            pickle.dump(rng.standard_normal((1, int(dur * 50), 512)).astype(np.float32), f)
        rows.append({"audio_filepath": str(path), "duration": dur,
                     "text": "".join(rng.choice(list("abcde "), size=int(6 * dur))).strip() or "a"})
    manifest = root / "m.json"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return manifest, feat_dir


def _batches(manifest, feat_dir):
    kw = dict(batch_size=2, ssl_folder=str(feat_dir), train=True, bucket_seconds=(2.0,), seed=3)
    jax_b = JaxDualBatcher(jax_read_manifests(manifest, 16.7), JaxVocabulary(LABELS), **kw)
    port_b = DualSSLBucketBatcher(read_manifests(manifest, 16.7), Vocabulary(LABELS), **kw)
    out = []
    for epoch in (0, 1):
        jax_b.set_epoch(epoch)
        port_b.set_epoch(epoch)
        out.append((list(jax_b), list(port_b)))
    return out


def test_dual_batches_equal_jax(dual_corpus):
    for want_all, got_all in _batches(*dual_corpus):
        assert len(got_all) == len(want_all) == 2
        for want, got in zip(want_all, got_all):
            for field in ("waves", "wave_lens", "prev_samples", "targets", "target_lens"):
                a, b = getattr(got, field), getattr(want, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), field
            assert got.paths == want.paths and got.texts == want.texts
            assert got.extra.keys() == want.extra.keys() == {"raw_waves", "raw_wave_lens"}
            for k in want.extra:
                assert got.extra[k].dtype == want.extra[k].dtype
                assert np.array_equal(got.extra[k], want.extra[k]), k
            assert got.waves.shape == (2, 100, 512) and got.extra["raw_waves"].shape == (2, 32000)


def test_dual_steps_match_jax_fp32(dual_corpus, monkeypatch):
    monkeypatch.setattr(jax_steps, "cutout", lambda feats, *a, **k: feats)
    monkeypatch.setattr(port_steps, "cutout", lambda feats, *a, **k: feats)
    host = _batches(*dual_corpus)[0][0][0]
    arrays = {"waves": host.waves, "wave_lens": host.wave_lens, "targets": host.targets,
              "target_lens": host.target_lens, **host.extra}
    assert (host.wave_lens < 100).all()
    rng = np.random.default_rng(32)
    jmodel = jax_model("dual")
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 100, 512)), jnp.zeros((1, 100, 64)), jnp.ones((1,)),
                            False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5),
                                    weight_decay=1e-3, fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmel = dataclasses.replace(JAX_DUAL_MEL, dither=0.0)

    model = port_model("dual")
    model.load_state_dict(from_jax(params, stats), strict=True)
    popt = port_capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                                 weight_decay=1e-3, fused=True))
    pstate = create_train_state(model, popt)
    pbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    pmel = dataclasses.replace(DUAL_MEL_CONFIG, dither=0.0)
    assert DUAL_MEL_CONFIG.precision == "highest" and dataclasses.asdict(pmel) == \
        dataclasses.asdict(jmel)

    want = jax.jit(jax_steps.make_dual_eval_step(jmodel, BLANK, jmel))(jstate, jbatch)
    got = port_steps.make_dual_eval_step(model, BLANK, pmel)(pstate, pbatch)
    np.testing.assert_array_equal(got["pred_lens"].numpy(), np.asarray(want["pred_lens"]))
    np.testing.assert_allclose(got["log_probs"].numpy(), np.asarray(want["log_probs"]),
                               rtol=EVAL_TOL, atol=EVAL_TOL)
    np.testing.assert_allclose(got["losses"].numpy(), np.asarray(want["losses"]), rtol=EVAL_TOL)

    jstep = jax.jit(jax_steps.make_dual_train_step(jmodel, jopt, BLANK, jmel, freq_mask=0,
                                                   time_mask=0))
    pstep = port_steps.make_dual_train_step(model, popt, BLANK, pmel, freq_mask=0, time_mask=0)
    gen = torch.Generator().manual_seed(0)
    for tol in RECIPE_TOL:
        jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        pstate, pmetrics = pstep(pstate, pbatch, gen)
        compare_step(jstate, jmetrics, pstate, pmetrics, tol)
    assert bool((pstate.opt_state[1].exp_avg_sq > 0).all())
