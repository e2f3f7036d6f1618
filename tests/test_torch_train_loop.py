"""The port's training step around the gradient (``training/steps.py``): the
NaN guard, gradient accumulation over micro-batches, and the eval step, at
full width on the CPU; accumulation and eval against the JAX package's
``make_train_step(accum_steps=2)`` and ``make_eval_step`` on the same
weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.ops.frontend import log_mel_spectrogram, normalize_features
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_eval_step as jax_make_eval_step
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.training.steps import (create_train_state, make_eval_step,
                                                make_train_step)
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_train_step import (BLANK, FRONTEND, NUM_CLASSES, SCHEDULE,
                                   compare_step, jax_batch, make_batch, port_batch, setups,
                                   weights)  # noqa: F401  (weights is a fixture)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [t for v in tree for t in _tensors(v)]


def test_nan_sample_skips_the_whole_update(weights):
    params, stats = weights
    model = build_model(NUM_CLASSES, mask=True)
    model.load_state_dict(from_jax(params, stats), strict=True)
    opt = novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                   weight_decay=1e-3, fused=True)
    step = make_train_step(model, opt, BLANK, MelFrontendConfig(**FRONTEND), augment=None)
    state = create_train_state(model, opt)
    good = port_batch(make_batch(0))
    bad = dict(good, waves=good["waves"].to(torch.float32) / 32768.0)   # the float32 wire
    bad["waves"][1, 100] = float("nan")
    before = [t.clone() for t in _tensors((state.params, state.batch_stats, state.opt_state))]

    new, metrics = step(state, bad)
    assert not bool(metrics["finite"]) and not np.isfinite(float(metrics["loss"]))
    assert int(new.nan_count) == 1 and int(new.step) == 1
    assert int(new.opt_state.count) == 0                 # the optimizer did not step
    after = _tensors((new.params, new.batch_stats, new.opt_state))
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    # the old state is untouched, and the next good batch trains as usual
    for a, b in zip(_tensors((state.params, state.batch_stats, state.opt_state)), before):
        assert torch.equal(a, b)
    new, metrics = step(new, good)
    assert bool(metrics["finite"]) and int(new.nan_count) == 1 and int(new.step) == 2
    assert int(new.opt_state.count) == 1
    assert not torch.equal(new.params["decoder.bias"], state.params["decoder.bias"])


# float32 from the same features.  On this 4-row batch the seeded train-mode
# network is ill-conditioned: a 1e-6 relative change of the features moves
# the port's own gradients by up to 1.4% on a tensor (measured on the port
# alone), so float32 sums in another order move them by as much (1.6% seen
# against JAX).  The forward quantities stay at rounding level: loss,
# BatchNorm statistics carried through both micro-batches, predictions.
ACCUM_TOL = dict(loss=1e-5, grad_norm=1e-3, grad=5e-2, params=1e-4, stats=1e-5, preds=0.98)


def test_accum_steps_2_matches_jax(weights):
    """Two micro-batches of 2 rows from one batch of 4 (BN statistics carry
    from the first to the second), from the same features on both sides."""
    batch = make_batch(2, B=4, lens=(15000, 11000, 13000, 9000), tlens=(14, 9, 12, 6))
    feats, lens = log_mel_spectrogram(jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lens"]),
                                      JaxMelConfig(**FRONTEND))
    fbatch = {**batch, "waves": np.array(normalize_features(feats, lens)),
              "wave_lens": np.array(lens)}
    jstate, jstep, pstate, pstep, _ = setups(weights, "float32", accum_steps=2,
                                             from_features=True)
    jstate, jmetrics = jstep(jstate, jax_batch(fbatch), jax.random.PRNGKey(0))
    pstate, pmetrics = pstep(pstate, port_batch(fbatch))
    compare_step(jstate, jmetrics, pstate, pmetrics, ACCUM_TOL)
    assert pmetrics["preds"].shape == (4, 51)


def test_eval_step_matches_jax(weights):
    params, stats = weights
    batch = make_batch(3)
    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=None, nan_count=jnp.zeros((), jnp.int32))
    want = jax.jit(jax_make_eval_step(jmodel, BLANK, JaxMelConfig(**FRONTEND)))(
        jstate, jax_batch(batch))
    model = build_model(NUM_CLASSES, mask=True)
    model.load_state_dict(from_jax(params, stats), strict=True)
    opt = novograd(1e-2)
    got = make_eval_step(model, BLANK, MelFrontendConfig(**FRONTEND))(
        create_train_state(model, opt), port_batch(batch))
    np.testing.assert_array_equal(got["pred_lens"].numpy(), np.asarray(want["pred_lens"]))
    # eval mode: running statistics, so no batch coupling; the "default"
    # frontend tier's bf16 flips (4e-4 in the features) and float32 sums in
    # another order through 16 blocks
    np.testing.assert_allclose(got["losses"].numpy(), np.asarray(want["losses"]), rtol=1e-4)
    lp, want_lp = got["log_probs"].numpy(), np.asarray(want["log_probs"])
    assert np.abs(lp - want_lp).max() < 2e-3, np.abs(lp - want_lp).max()
    assert np.mean(got["preds"].numpy() == np.asarray(want["preds"])) > 0.98
