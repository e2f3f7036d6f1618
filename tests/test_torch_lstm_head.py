"""Parity: the LSTM head at its hidden size H = 128 (``build_model(...,
lstm_head=True)``): the plain versions of K2 / K3 and K7 / K8 at H = 128
against the JAX package's Pallas kernels in interpret mode, and the head
model against JAX's ``AsrModel(lstm_head=True)`` in eval and train mode and
through one train step, on the same numpy inputs and weights (carried
across with ``from_jax``), on the CPU.

At H = 128 the TPU kernels' lane padding (H rounded up to 128) is none, so
their W_hh is the port's transposed and their gate layout the port's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.ops.lstm import LSTMWeights as JW
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_train_step as jax_make_train_step
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.ops.lstm import LSTMWeights, lstm, stack_directions, stacked_valid
from lightning_asr_torch.ops.lstm_kernels import (lstm_backward, lstm_backward_plain,
                                                  lstm_backward_stacked, lstm_recurrence,
                                                  lstm_recurrence_plain, lstm_recurrence_stacked,
                                                  lstm_recurrence_stacked_plain,
                                                  lstm_backward_stacked_plain)
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.training.steps import create_train_state, make_train_step
from lightning_asr_torch.utils.jax_params import (from_jax, opt_state_from_jax, opt_state_to_jax,
                                                  to_jax)
from test_torch_encoders import STEP_TOL, _assert_close
from test_torch_model import NUM_CLASSES, class_std, with_teeth
from test_torch_train_step import (FRONTEND, SCHEDULE, as_jax_trees, jax_capture, leaves,
                                   port_capture, rel_err)

jlp = importlib.import_module("lightning_asr_tpu.ops.lstm_pallas")
H = 128
# the kernel cases: the TPU kernels' 32- and 16-step time blocks divide T
T_K, LENGTHS = 32, (32, 19, 1)
IN = 32


def _case(seed):
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    s = 1.0 / np.sqrt(H)
    xproj = rng.standard_normal((B, T_K, 2, 4 * H)).astype(np.float32)
    w_hh = rng.uniform(-s, s, (2, 4 * H, H)).astype(np.float32)
    grad_h = rng.standard_normal((B, T_K, 2 * H)).astype(np.float32)
    return xproj, np.array(LENGTHS, np.int32), w_hh, grad_h


def _walk(a: np.ndarray, d: int) -> np.ndarray:
    """(T, B, ...) into direction d's walk order (its own inverse)."""
    return a[::-1] if d == 1 else a


def test_plain_k2_k3_match_the_tpu_kernels_at_h128():
    """K2 against ``_run_fwd`` and K3 against ``_core_bwd`` (each direction
    one TPU call, the reverse one on the time-flipped batch): h, d_xproj and
    dW_hh within 1e-5 (float32; the gate dots and the dW_hh sums in another
    order)."""
    xproj, lens, w_hh, grad_h = _case(0)
    t = np.arange(T_K)[:, None]
    pt = [torch.from_numpy(a) for a in (xproj, lens, w_hh)]
    h, c = lstm_recurrence_plain(*pt, with_cell=True)
    d_x, dw = lstm_backward_plain(*pt, h, c, torch.from_numpy(grad_h))
    for d in range(2):
        xp = jnp.asarray(_walk(xproj[:, :, d].transpose(1, 0, 2), d).copy())
        valid = (_walk(t, d) < lens[None, :]).astype(np.float32)[:, :, None]
        whh = jnp.asarray(w_hh[d].T.copy())                     # (H, 4H) = the TPU's (Hp, 4Hp)
        h_all, hprev, cprev = jlp._run_fwd(xp, jnp.asarray(valid), whh)
        got_h = h[:, :, d * H:(d + 1) * H].numpy()
        np.testing.assert_allclose(got_h, _walk(np.asarray(h_all), d).transpose(1, 0, 2),
                                   rtol=0, atol=1e-5)
        g = jnp.asarray(_walk(grad_h[:, :, d * H:(d + 1) * H].transpose(1, 0, 2), d).copy())
        dxp, _, dwhh = jlp._core_bwd((xp, jnp.asarray(valid), whh, hprev, cprev), g)
        want_dx = _walk(np.asarray(dxp), d).transpose(1, 0, 2)
        np.testing.assert_allclose(d_x[:, :, d].numpy(), want_dx, rtol=0, atol=1e-5)
        np.testing.assert_allclose(dw[d].numpy(), np.asarray(dwhh).T, rtol=0, atol=1e-5)
    for b, n in enumerate(LENGTHS):
        assert np.all(h[b, n:].numpy() == 0) and np.all(d_x[b, n:].numpy() == 0)


def test_plain_k7_k8_match_the_tpu_kernels_at_h128():
    """K7 against ``_run_fwd_bidir`` and K8 against ``_core_bidir_bwd`` on the
    stacked rows as ``ops/lstm.py`` builds them: h, h_prev, c_prev, d_xproj
    and both dW_hh within 1e-5."""
    xproj, lens, w_hh, grad_h = _case(1)
    B = len(LENGTHS)
    xp = stack_directions(torch.from_numpy(xproj)).contiguous()
    valid = stacked_valid(T_K, torch.from_numpy(lens))
    gs = stack_directions(torch.from_numpy(grad_h).reshape(B, T_K, 2, H)).contiguous()
    w_f, w_b = (torch.from_numpy(w_hh[d].copy()) for d in range(2))
    got = lstm_recurrence_stacked_plain(xp, valid, w_f, w_b)
    jf, jb = jnp.asarray(w_hh[0].T.copy()), jnp.asarray(w_hh[1].T.copy())
    jx, jv = jnp.asarray(xp.numpy()), jnp.asarray(valid.numpy()[:, :, None])
    want = jlp._run_fwd_bidir(jx, jv, jf, jb)
    for name, g, w in zip(("h", "h_prev", "c_prev"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    d_x, dw_f, dw_b = lstm_backward_stacked_plain(xp, valid, w_f, w_b, got[1], got[2], gs)
    dx, _, jdwf, jdwb = jlp._core_bidir_bwd((jx, jv, jf, jb, want[1], want[2]),
                                            jnp.asarray(gs.numpy()))
    np.testing.assert_allclose(d_x.numpy(), np.asarray(dx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw_f.numpy(), np.asarray(jdwf).T, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw_b.numpy(), np.asarray(jdwb).T, rtol=0, atol=1e-5)
    assert np.all(d_x.numpy()[valid.numpy() == 0] == 0)


@pytest.mark.parametrize("fuse", [False, True])
def test_head_bilstm_and_gradients_match_jax(fuse):
    """The head's BiLSTM (input 32, hidden 128, T = 20, ragged rows) through
    ``lstm`` against ``lstm_pallas``: output, the gradient of x and of every
    weight."""
    rng = np.random.default_rng(2)
    lens = np.array([20, 13, 1], np.int32)
    B, T = len(lens), 20
    s = 1.0 / np.sqrt(H)
    w = [[rng.uniform(-s, s, shape).astype(np.float32)
          for shape in ((4 * H, IN), (4 * H, H), (4 * H,), (4 * H,))] for _ in range(2)]
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    probe = rng.standard_normal((B, T, 2 * H)).astype(np.float32)

    def jax_loss(x, w):
        out = jlp.lstm_pallas(x, jnp.asarray(lens), JW(*w[0]), JW(*w[1]), fuse_directions=fuse)
        return jnp.sum(out * probe), out

    (_, want), (gx, gw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), [[jnp.asarray(a) for a in d] for d in w])
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [[torch.from_numpy(a).requires_grad_(True) for a in d] for d in w]
    out = lstm(xt, torch.from_numpy(lens), LSTMWeights(*wt[0]), LSTMWeights(*wt[1]),
               fuse_directions=fuse)
    (out * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=2e-5)
    for got, ref in zip([a.grad.numpy() for d in wt for a in d], [np.asarray(a) for d in gw for a in d]):
        # float32; dW_hh, dW_ih and db sum over (row, frame) in another order
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_cpu_tensors_run_the_plain_versions_at_h128():
    """On CPU tensors the wrappers at H = 128 are their plain versions, and
    count no launch."""
    xproj, lens, w_hh, grad_h = (torch.from_numpy(a) for a in _case(3))
    counts = (lstm_recurrence.launches, lstm_backward.launches, lstm_recurrence_stacked.launches,
              lstm_backward_stacked.launches)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    want_h, want_c = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    assert torch.equal(h, want_h) and torch.equal(c, want_c)
    got = lstm_backward(xproj, lens, w_hh, h, c, grad_h)
    for a, b in zip(got, lstm_backward_plain(xproj, lens, w_hh, h, c, grad_h)):
        assert torch.equal(a, b)
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T_K, lens)
    hs = lstm_recurrence_stacked(xp, valid, w_hh[0], w_hh[1])
    for a, b in zip(hs, lstm_recurrence_stacked_plain(xp, valid, w_hh[0], w_hh[1])):
        assert torch.equal(a, b)
    assert counts == (lstm_recurrence.launches, lstm_backward.launches,
                      lstm_recurrence_stacked.launches, lstm_backward_stacked.launches)


# ---------------------------------------------------------------------------
# the head model
# ---------------------------------------------------------------------------

B, T = 2, 40                     # T' = 20 frames after the stride-2 stem
LENS = (37, 25)                  # no row fills the padding (C5)
HEAD_SCALE = 8.0                 # head_fc scaled up: a class std above 0.5


@pytest.fixture(scope="module")
def head_weights():
    """(flax params with teeth, batch_stats, features, percents) of the head
    model."""
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((B, T, 64)).astype(np.float32)
    percents = (np.array(LENS, np.float32) / np.float32(T)).astype(np.float32)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True)
    variables = jax.device_get(jax.jit(lambda f, p: model.init(jax.random.PRNGKey(0), f, p, False))(
        jnp.asarray(feats), jnp.asarray(percents)))
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    params["head_fc"]["kernel"] = params["head_fc"]["kernel"] * np.float32(HEAD_SCALE)
    return params, stats, feats, percents


def _port(params, stats, **kw):
    model = build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True, **kw)
    model.load_state_dict(from_jax(params, stats), strict=True)
    return model


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_model_eval_matches_jax(head_weights, dtype, fuse):
    """Eval mode at full width: log-probs within the block tolerances of
    ``test_torch_encoders.py`` (1e-5 in float32, 4e-2 in bf16), the output
    lengths equal; ``fuse_directions`` runs both BiLSTMs stacked and gives
    the same function."""
    params, stats, feats, percents = head_weights
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True,
                             dtype=jdt)
    want_lp, want_lens = jax.jit(lambda f, p: jmodel.apply(
        {"params": params, "batch_stats": stats}, f, p, False))(jnp.asarray(feats),
                                                               jnp.asarray(percents))
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)   # the comparison has teeth
    port = _port(params, stats, dtype=tdt, fuse_directions=fuse).eval()
    assert port.head_rnn.fuse_directions == fuse == port.encoder.context_rnn.fuse_directions
    with torch.no_grad():
        lp, lens = port(torch.from_numpy(feats), torch.from_numpy(percents))
    assert lp.shape == want_lp.shape == (B, T // 2, NUM_CLASSES) and lp.dtype == torch.float32
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    _assert_close(lp.numpy(), want_lp, dtype)


def test_head_model_train_mode_matches_jax(head_weights):
    """Train mode in float32: log-probs from batch statistics, and the
    updated running statistics of every BatchNorm, ``head_bn`` included.
    The seeded train-mode network is chaotic (a ReLU input within rounding
    of 0 flips, and batch statistics over 40 frames carry it on): the port
    alone, its features moved by 1e-7 relative, moves its log-probs by about
    3e-4 (of values up to 33), more than its gap to JAX (2.6e-4).  So the
    log-probs are held to twice that move, measured here, as the card's
    encoder steps are (chip_smoke.py CHAOS_GAP_RATIO); the statistics to
    1e-5 relative."""
    params, stats, feats, percents = head_weights
    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True)
    (want_lp, _), new_stats = jax.jit(lambda f, p: jmodel.apply(
        {"params": params, "batch_stats": stats}, f, p, True, mutable=["batch_stats"]))(
        jnp.asarray(feats), jnp.asarray(percents))
    want_lp = np.asarray(want_lp)
    port = _port(params, stats).train()
    jitter = 1 + 1e-7 * np.random.default_rng(5).standard_normal(feats.shape).astype(np.float32)
    with torch.no_grad():
        moved, _ = port(torch.from_numpy(feats * jitter), torch.from_numpy(percents))
        port.load_state_dict(from_jax(params, stats), strict=True)     # the statistics again
        lp, _ = port(torch.from_numpy(feats), torch.from_numpy(percents))
    move = np.abs(moved.numpy() - lp.numpy()).max()
    gap = np.abs(lp.numpy() - want_lp).max()
    assert 0 < move <= 1e-5 * np.abs(want_lp).max() * 100, move    # chaos, not a fault
    assert gap <= 2 * move, (gap, move)
    _, got_stats = to_jax(port.state_dict())
    assert "head_bn" in got_stats
    want_s, got_s = leaves(jax.device_get(new_stats["batch_stats"])), leaves(got_stats)
    assert want_s.keys() == got_s.keys()
    assert max(rel_err(got_s, want_s).values()) <= 1e-5


def test_head_model_train_step_matches_jax(head_weights):
    """One float32 train step (``make_train_step`` from the same features,
    batch statistics, fused NovoGrad behind a gradient capture) against
    JAX's jitted step, under the encoders' bounds (``STEP_TOL``): loss,
    gradient norm, each tensor's gradient (the head's included), the
    updated parameters and statistics, the predictions."""
    params, stats, feats, _ = head_weights
    rng = np.random.default_rng(3)
    targets = np.zeros((B, 16), np.int32)
    for b, n in enumerate((8, 6)):
        targets[b, :n] = rng.integers(0, NUM_CLASSES - 1, n)
    batch = dict(waves=feats, wave_lens=np.array(LENS, np.int32), targets=targets,
                 target_lens=np.array([8, 6], np.int32))

    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True)
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                                    fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, NUM_CLASSES - 1, JaxMelConfig(**FRONTEND),
                                        augment=None, from_features=True))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    model = _port(params, stats)
    popt = port_capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                                 weight_decay=1e-3, fused=True))
    pstep = make_train_step(model, popt, NUM_CLASSES - 1, MelFrontendConfig(**FRONTEND),
                            augment=None, from_features=True)
    pstate, pm = pstep(create_train_state(model, popt),
                       {k: torch.from_numpy(v) for k, v in batch.items()})

    tol = STEP_TOL
    loss, want_loss = float(pm["loss"]), float(jm["loss"])
    assert np.isfinite(loss) and abs(loss - want_loss) <= tol["loss"] * abs(want_loss), (loss, want_loss)
    gn, want_gn = float(pm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - want_gn) <= tol["grad_norm"] * want_gn, (gn, want_gn)
    got_g = leaves(as_jax_trees(pstate, pstate.opt_state[0]))
    want_g = leaves(jstate.opt_state[0])
    assert got_g.keys() == want_g.keys()
    assert any("head_rnn" in k for k in got_g) and any("head_fc" in k for k in got_g)
    errs = rel_err(got_g, want_g)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], (worst, errs[worst])
    pp, ps = to_jax({**pstate.params, **pstate.batch_stats})
    p_err = max(np.abs(a - b).max() for a, b in zip(leaves(pp).values(), leaves(jstate.params).values()))
    assert p_err <= tol["params"], p_err
    assert max(rel_err(leaves(ps), leaves(jstate.batch_stats)).values()) <= tol["stats"]
    np.testing.assert_array_equal(pm["pred_lens"].numpy(), np.asarray(jm["pred_lens"]))
    assert np.mean(pm["preds"].numpy() == np.asarray(jm["preds"])) >= tol["preds"]


def test_head_bridges_round_trip():
    """The head model's flax tree -> the port's state_dict -> the flax tree,
    and a fused NovoGrad state after one update -> the port's layout ->
    JAX's, bit for bit, with ``head_rnn``, ``head_bn`` (its batch
    statistics too) and ``head_fc`` (its kernel as (out, in))."""
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True)
    variables = jax.device_get(jax.jit(lambda f, p: model.init(jax.random.PRNGKey(0), f, p, False))(
        jnp.zeros((1, 40, 64)), jnp.ones((1,))))
    rng = np.random.default_rng(0)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    sd = from_jax(params, stats)
    head = {k for k in sd if k.startswith("head_")}
    assert head == {*(f"head_rnn.{n}_{t}" for n in ("w_ih", "w_hh", "b_ih", "b_hh") for t in "fb"),
                    "head_bn.weight", "head_bn.bias", "head_bn.running_mean", "head_bn.running_var",
                    "head_fc.weight", "head_fc.bias"}
    assert tuple(sd["head_fc.weight"].shape) == (NUM_CLASSES, 256)
    np.testing.assert_array_equal(sd["head_fc.weight"].numpy(), params["head_fc"]["kernel"].T)
    np.testing.assert_array_equal(sd["head_bn.running_var"].numpy(), stats["head_bn"]["var"])
    port = build_model(NUM_CLASSES, "quartznet12_context", mask=True, lstm_head=True)
    port.load_state_dict(sd, strict=True)
    assert not hasattr(port, "decoder")
    back_p, back_s = to_jax(sd)
    for want, got in ((params, back_p), (stats, back_s)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)

    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    jstate = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    template = create_train_state(port, novograd(1e-2, fused=True))
    ported = opt_state_from_jax(jstate, params, stats, template.params)
    back = opt_state_to_jax(ported, template.params, template.batch_stats)
    for k in ("count", "exp_avg", "exp_avg_sq", "max_exp_avg_sq", "p_flat"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstate, k)), err_msg=k)
