"""Parity: the port's batch-stacked BiLSTM (``lightning_asr_torch/ops/
lstm_kernels.py``: the plain versions of K7 and K8 on the CPU; ``ops/lstm.py``
with ``fuse_directions=True``) against the JAX package's
``_run_fwd_bidir`` / ``_core_bidir_bwd`` Pallas kernels in interpret mode and
``lstm_pallas(..., fuse_directions=True)``, and the full-width model and one
train step built with ``fuse_directions=True`` against JAX's with
``LASR_LSTM_FUSED_BIDIR=1``, on the same numpy inputs.

JAX reads its switch while it traces, so a test sets it before it builds or
calls a jitted JAX function and restores it in a ``finally``: the tests of a
file share one process, and a leaked switch would reroute later JAX models.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops.lstm import LSTMWeights as JW
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.lstm import LSTMWeights, lstm
from lightning_asr_torch.ops.lstm_kernels import (lstm_backward_stacked,
                                                  lstm_backward_stacked_plain,
                                                  lstm_recurrence_stacked,
                                                  lstm_recurrence_stacked_plain)
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, class_std, with_teeth
from test_torch_train_step import FEATURE_TOL, compare_step, make_batch, setups

jlp = importlib.import_module("lightning_asr_tpu.ops.lstm_pallas")
H, HP = 40, 128
SWITCH = "LASR_LSTM_FUSED_BIDIR"


class fused_switch:
    """JAX's switch on inside the block, restored after it."""

    def __enter__(self):
        self.old = os.environ.get(SWITCH)
        os.environ[SWITCH] = "1"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(SWITCH, None)
        else:
            os.environ[SWITCH] = self.old


def _stacked_case(seed, T, lengths):
    """Stacked rows as ``lstm_pallas`` builds them: forward rows valid at
    t < len, reverse rows (the flipped batch) at T-1-t < len."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    s = 1.0 / np.sqrt(H)
    xproj = rng.standard_normal((T, 2 * B, 4 * H)).astype(np.float32)
    w_f, w_b = (rng.uniform(-s, s, (4 * H, H)).astype(np.float32) for _ in range(2))
    lens = np.array(lengths)
    t = np.arange(T)[:, None]
    valid = np.concatenate([t < lens[None], (T - 1 - t) < lens[None]], axis=1).astype(np.float32)
    grad_h = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    return xproj, valid, w_f, w_b, grad_h


def _pad_gates(a: np.ndarray) -> np.ndarray:
    """(..., 4H) -> (..., 4Hp): gate k in lanes [k·Hp, k·Hp + H)."""
    out = np.zeros(a.shape[:-1] + (4 * HP,), np.float32)
    for k in range(4):
        out[..., k * HP: k * HP + H] = a[..., k * H:(k + 1) * H]
    return out


def _pad_whh(w: np.ndarray) -> np.ndarray:
    """torch (4H, H) -> the TPU kernels' (Hp, 4Hp), W_hh transposed."""
    return _pad_gates(np.pad(w.T, ((0, HP - H), (0, 0))))


def _unpad_whh(g: np.ndarray) -> np.ndarray:
    return np.concatenate([g[:H, k * HP: k * HP + H].T for k in range(4)], axis=0)


@pytest.mark.parametrize("T,lengths", [(48, [48, 25, 1]), (32, [30, 32, 9, 0])])
def test_plain_k7_k8_match_the_tpu_kernels(T, lengths):
    """K7 against ``_run_fwd_bidir`` and K8 against ``_core_bidir_bwd``, both
    in interpret mode, with the TPU's lane padding and 16-step blocks
    stripped (T is a multiple of 16 here)."""
    xproj, valid, w_f, w_b, grad_h = _stacked_case(T, T, lengths)
    jx, jv = jnp.asarray(_pad_gates(xproj)), jnp.asarray(valid[:, :, None])
    jf, jb = jnp.asarray(_pad_whh(w_f)), jnp.asarray(_pad_whh(w_b))
    want = [np.asarray(a)[..., :H] for a in jlp._run_fwd_bidir(jx, jv, jf, jb)]
    args = [torch.from_numpy(a) for a in (xproj, valid, w_f, w_b)]
    got = [a.numpy() for a in lstm_recurrence_stacked_plain(*args)]
    for name, g, w in zip(("h", "h_prev", "c_prev"), got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)

    hp_pad, cp_pad = (np.pad(a, ((0, 0), (0, 0), (0, HP - H))) for a in got[1:])
    g_pad = np.pad(grad_h, ((0, 0), (0, 0), (0, HP - H)))
    dx, _, dwf, dwb = jlp._core_bidir_bwd((jx, jv, jf, jb, jnp.asarray(hp_pad), jnp.asarray(cp_pad)),
                                          jnp.asarray(g_pad))
    want_dx = np.concatenate([np.asarray(dx)[..., k * HP: k * HP + H] for k in range(4)], axis=-1)
    gdx, gwf, gwb = (a.numpy() for a in lstm_backward_stacked_plain(
        *args, torch.from_numpy(got[1]), torch.from_numpy(got[2]), torch.from_numpy(grad_h)))
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    # float32; the gate recompute and the dot / dW sums in another order
    assert rel(gdx, want_dx) <= 1e-4, rel(gdx, want_dx)
    for g, w in ((gwf, _unpad_whh(np.asarray(dwf))), (gwb, _unpad_whh(np.asarray(dwb)))):
        assert rel(g, w) <= 1e-4, rel(g, w)
    assert np.all(gdx[valid == 0] == 0)


def test_wrappers_check_and_count():
    xproj, valid, w_f, w_b, grad_h = (torch.from_numpy(a) for a in _stacked_case(0, 5, [5, 2]))
    launches = (lstm_recurrence_stacked.launches, lstm_backward_stacked.launches)
    h, hp, cp = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    assert h.shape == hp.shape == cp.shape == (5, 4, H)
    dx, dwf, dwb = lstm_backward_stacked(xproj, valid, w_f, w_b, hp, cp, grad_h)
    assert dx.shape == xproj.shape and dwf.shape == dwb.shape == (4 * H, H)
    for bad in ((xproj[:, :3], valid[:, :3], w_f, w_b),          # an odd row count
                (xproj, valid[:4], w_f, w_b),                    # valid of another length
                (xproj, valid, w_f[:, :8], w_b),                 # W_hh of another width
                (xproj.double(), valid, w_f, w_b)):              # a type the kernels do not take
        with pytest.raises(ValueError):
            lstm_recurrence_stacked(*bad)
    with pytest.raises(ValueError):
        lstm_backward_stacked(xproj, valid, w_f, w_b, hp, cp, grad_h[:4])
    assert (lstm_recurrence_stacked.launches, lstm_backward_stacked.launches) == launches


def _weights(rng, IN):
    s = 1.0 / np.sqrt(H)
    return [rng.uniform(-s, s, shape).astype(np.float32)
            for shape in ((4 * H, IN), (4 * H, H), (4 * H,), (4 * H,))]


@pytest.mark.parametrize("T,lengths", [(40, [40, 25, 1]), (37, [30, 37, 9])])
def test_fused_lstm_and_gradients_match_jax(T, lengths):
    """``lstm(..., fuse_directions=True)`` against ``lstm_pallas(...,
    fuse_directions=True)``: output and the gradients of x and every weight,
    ragged lengths including 1 and T; and against the port's own K2/K3 path
    (the same function, the same float32 ops: equal)."""
    rng = np.random.default_rng(T)
    B, IN = len(lengths), 16
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    w = [_weights(rng, IN), _weights(rng, IN)]
    lens = np.array(lengths, np.int32)
    probe = rng.standard_normal((B, T, 2 * H)).astype(np.float32)

    def jax_loss(x, w):
        out = jlp.lstm_pallas(x, jnp.asarray(lens), JW(*w[0]), JW(*w[1]), fuse_directions=True)
        return jnp.sum(out * probe), out

    (_, want), (gx, gw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), [[jnp.asarray(a) for a in d] for d in w])
    ports = []
    for fuse in (True, False):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = [[torch.from_numpy(a).requires_grad_(True) for a in d] for d in w]
        out = lstm(xt, torch.from_numpy(lens), LSTMWeights(*wt[0]), LSTMWeights(*wt[1]),
                   fuse_directions=fuse)
        (out * torch.from_numpy(probe)).sum().backward()
        ports.append([out.detach().numpy(), xt.grad.numpy()] + [a.grad.numpy() for d in wt for a in d])
    np.testing.assert_allclose(ports[0][0], np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ports[0][1], np.asarray(gx), rtol=0, atol=2e-5)
    for got, ref in zip(ports[0][2:], [np.asarray(a) for d in gw for a in d]):
        # float32; dW_hh, dW_ih and db sum over (row, frame) in another order
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    for a, b in zip(*ports):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def full_width():
    """Full-width weights with teeth and features of two rows (64 frames,
    one row shorter)."""
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 64, 64)).astype(np.float32)
    percents = np.array([1.0, 0.6], np.float32)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(percents), False)
    params, stats = with_teeth(v["params"], v["batch_stats"], rng)
    return feats, percents, params, stats


def test_full_width_model_matches_jax_fused(full_width):
    feats, percents, params, stats = full_width
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    with fused_switch():
        want_lp, want_lens = jax.jit(lambda f, p: model.apply(
            {"params": params, "batch_stats": stats}, f, p, False))(jnp.asarray(feats),
                                                                   jnp.asarray(percents))
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)
    port = build_model(NUM_CLASSES, mask=True, fuse_directions=True)
    assert port.encoder.context_rnn.fuse_directions
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        lp, lens = port(torch.from_numpy(feats), torch.from_numpy(percents))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    # 16 blocks of float32 sums in another order, as the default path
    assert np.abs(lp.numpy() - want_lp).max() < 1e-4, np.abs(lp.numpy() - want_lp).max()


def test_train_step_from_features_matches_jax_fused(full_width):
    """One float32 train step from shared features, rows shorter than the
    padding (ROADMAP.md §C5): the port with ``fuse_directions=True`` (K7,
    K8's plain versions) against JAX's step with its switch on (the Pallas
    kernels in interpret mode), to the bound of the default path."""
    from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
    from lightning_asr_tpu.ops.frontend import log_mel_spectrogram, normalize_features

    batch = make_batch(0)
    feats, lens = log_mel_spectrogram(jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lens"]),
                                      JaxMelConfig(dither=0.0, precision="default"))
    fbatch = {**batch, "waves": np.array(normalize_features(feats, lens)), "wave_lens": np.array(lens)}
    with fused_switch():
        jstate, jstep, pstate, pstep, model = setups(full_width[2:], "float32", from_features=True,
                                                     fuse_directions=True)
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in fbatch.items()},
                                 jax.random.PRNGKey(0))
    assert model.encoder.context_rnn.fuse_directions
    launches = lstm_recurrence_stacked.launches
    pstate, pmetrics = pstep(pstate, {k: torch.from_numpy(v) for k, v in fbatch.items()})
    assert lstm_recurrence_stacked.launches == launches          # CPU runs never count
    compare_step(jstate, jmetrics, pstate, pmetrics, FEATURE_TOL[0])
