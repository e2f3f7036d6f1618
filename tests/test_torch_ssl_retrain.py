"""Parity: the SSL retrain mode's steps (``make_raw_ssl_train_step`` and
``make_raw_ssl_eval_step`` on ``SSLRetrainAsrModel``, the wav2vec2 feature
encoder trained with the model) against the JAX package's jitted steps,
from the same weights (``from_jax``) and the same int16 waves, on the CPU.

Two float32 steps of the "layer" model at full width (7 x 512 feature
encoder, QuartNet12-context), cutout and dropout off (``jax.random`` and
``torch.Generator`` cannot draw the same bits), fused NovoGrad behind a
gradient capture.  No frontend runs: both sides differ only by the order of
float32 sums, so each step is held to ``FEATURE_TOL`` of
``test_torch_train_step.py``, or, where JAX's own step moves further when
its waves move by 1e-7 relative, to CHAOS_GAP_RATIO times that move (the
rule of ``chip_smoke.py``'s float32 steps).  On this batch JAX's second
step moves its gradients by 4.6% (grad norm 1.2%) under that change, where
the port's moves by 7e-5, and the port lands within 1e-5 of JAX's moved
step (ROADMAP.md C17).  The eval step from the same initial weights is held
to the models' 1e-5.  The rows are shorter than the padding (C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_raw_ssl_eval_step as jax_raw_eval
from lightning_asr_tpu.training.steps import make_raw_ssl_train_step as jax_raw_train
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.training.steps import (create_train_state, make_raw_ssl_eval_step,
                                                make_raw_ssl_train_step)
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, with_teeth
from test_torch_ssl_models import TOL, jax_model, port_model, with_norm_teeth
from test_torch_train_step import (FEATURE_TOL, SCHEDULE, compare_step, jax_capture, leaves,
                                   port_capture, rel_err)

BLANK = NUM_CLASSES - 1
KIND = "retrain_layer"
CHAOS_GAP_RATIO = 2.0


def _jax_move(jstep, jstate, jbatch):
    """JAX's own move per step, its waves moved by 1e-7 relative: (loss,
    grad norm, worst per-tensor gradient) relative, parameters absolute."""
    waves = np.asarray(jbatch["waves"], np.float32)
    noise = np.random.default_rng(5).standard_normal(waves.shape).astype(np.float32)
    moved = {**jbatch, "waves": jnp.asarray(waves * (1 + 1e-7 * noise))}
    a, b, out = jstate, jstate, []
    for _ in range(2):
        a, ma = jstep(a, jbatch, jax.random.PRNGKey(0))
        b, mb = jstep(b, moved, jax.random.PRNGKey(0))
        rel = lambda k: abs(float(ma[k]) - float(mb[k])) / abs(float(ma[k]))  # noqa: E731
        out.append(dict(loss=rel("loss"), grad_norm=rel("grad_norm"),
                        grad=max(rel_err(leaves(b.opt_state[0]), leaves(a.opt_state[0])).values()),
                        params=max(np.abs(x - y).max() for x, y in
                                   zip(leaves(a.params).values(), leaves(b.params).values()))))
    return out


def _batch():
    rng = np.random.default_rng(21)
    S, lens, tlens = 8000, (7600, 6000), (9, 6)
    waves = np.zeros((2, S), np.int16)
    for b, n in enumerate(lens):
        waves[b, :n] = (rng.standard_normal(n) * 3000).astype(np.int16)
    targets = np.zeros((2, 32), np.int32)
    for b, n in enumerate(tlens):
        targets[b, :n] = rng.integers(0, BLANK, n)
    return dict(waves=waves, wave_lens=np.array(lens, np.int32), targets=targets,
                target_lens=np.array(tlens, np.int32))


def test_raw_ssl_steps_match_jax_fp32():
    batch = _batch()
    rng = np.random.default_rng(22)
    jmodel = jax_model(KIND)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "augment": jax.random.PRNGKey(2)}
    variables = jmodel.init(rngs, jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lens"]),
                            False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    params = with_norm_teeth(params, rng)
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5),
                                    weight_decay=1e-3, fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = port_model(KIND)
    model.load_state_dict(from_jax(params, stats), strict=True)
    popt = port_capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                                 weight_decay=1e-3, fused=True))
    pstate = create_train_state(model, popt)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    want = jax.jit(jax_raw_eval(jmodel, BLANK))(jstate, jbatch)
    got = make_raw_ssl_eval_step(model, BLANK)(pstate, pbatch)
    np.testing.assert_array_equal(got["pred_lens"].numpy(), np.asarray(want["pred_lens"]))
    np.testing.assert_allclose(got["log_probs"].numpy(), np.asarray(want["log_probs"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["losses"].numpy(), np.asarray(want["losses"]), rtol=TOL)
    assert np.array_equal(got["preds"].numpy(), np.asarray(want["preds"]))

    jstep = jax.jit(jax_raw_train(jmodel, jopt, BLANK))
    pstep = make_raw_ssl_train_step(model, popt, BLANK)
    moves = _jax_move(jstep, jstate, jbatch)
    for tol, move in zip(FEATURE_TOL, moves):
        tol = {**tol, **{k: max(tol[k], CHAOS_GAP_RATIO * v) for k, v in move.items()}}
        jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        pstate, pmetrics = pstep(pstate, pbatch)
        grads = compare_step(jstate, jmetrics, pstate, pmetrics, tol)
        assert any(k.startswith("['wav2vec']['ln") for k in grads)
    assert bool((pstate.opt_state[1].exp_avg_sq > 0).all())
