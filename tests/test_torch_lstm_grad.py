"""Parity: gradients of the port's bidirectional LSTM (``ops/lstm.py``, the
autograd Function over kernel K2 with its cell-state output and K3's plain
version) against ``jax.grad`` through the JAX package's ``lstm_pallas``
(interpret mode) and its scan ``ops.lstm.lstm``, on the same numpy inputs,
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.ops.lstm import LSTMWeights as JW
from lightning_asr_tpu.ops.lstm import lstm as jax_lstm
from lightning_asr_tpu.ops.lstm_pallas import lstm_pallas
from lightning_asr_torch.ops.lstm import LSTMWeights, lstm
from lightning_asr_torch.ops.lstm_kernels import (lstm_backward, lstm_recurrence,
                                                  lstm_recurrence_plain)

NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _case(seed, B, T, IN, H, lengths):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    w = [[rng.uniform(-s, s, shape).astype(np.float32)
          for shape in ((4 * H, IN), (4 * H, H), (4 * H,), (4 * H,))] for _ in range(2)]
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    # the upstream gradient is nonzero at pad frames too: it must not leak
    upstream = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    return x, np.array(lengths, np.int32), w, upstream


def _port_grads(x, lens, w, upstream):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [[torch.from_numpy(a).requires_grad_(True) for a in d] for d in w]
    out = lstm(xt, torch.from_numpy(lens), LSTMWeights(*wt[0]), LSTMWeights(*wt[1]))
    (out * torch.from_numpy(upstream)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), [[a.grad.numpy() for a in d] for d in wt]


def _jax_grads(fn, x, lens, w, upstream):
    def f(x, w):
        return jnp.sum(fn(x, jnp.asarray(lens), JW(*w[0]), JW(*w[1])) * upstream)

    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), [[jnp.asarray(a) for a in d] for d in w])
    return np.asarray(gx), [[np.asarray(a) for a in d] for d in gw]


@pytest.mark.parametrize("T,lengths", [(21, [21, 9, 1]), (16, [3, 16, 12, 1])])
def test_bilstm_gradients_match_jax(T, lengths):
    x, lens, w, upstream = _case(T, len(lengths), T, 12, 8, lengths)
    out, gx, gw = _port_grads(x, lens, w, upstream)
    for fn in (lstm_pallas, jax_lstm):
        want_gx, want_gw = _jax_grads(fn, x, lens, w, upstream)
        # float32 throughout; the dots and the batch/time sums of dW_hh,
        # dW_ih and db run in another order
        np.testing.assert_allclose(gx, want_gx, rtol=0, atol=2e-5)
        for d in range(2):
            for name, got, want in zip(NAMES, gw[d], want_gw[d]):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5,
                                           err_msg=f"{fn.__name__} direction {d} {name}")
    for b, n in enumerate(lens):
        assert np.all(gx[b, n:] == 0.0)            # pad frames get no gradient
        assert np.all(np.abs(gx[b, :n]).sum(-1) > 0)


def test_k3_plain_d_xproj_zero_at_pad_frames_and_dw_summed():
    rng = np.random.default_rng(5)
    B, T, D, H = 3, 9, 2, 4
    xproj = torch.from_numpy(rng.standard_normal((B, T, D, 4 * H)).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-0.5, 0.5, (D, 4 * H, H)).astype(np.float32))
    lens = torch.tensor([9, 4, 1], dtype=torch.int32)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    grad_h = torch.from_numpy(rng.standard_normal((B, T, D * H)).astype(np.float32))
    launches = lstm_backward.launches
    d_xproj, dw = lstm_backward(xproj, lens, w_hh, h, c, grad_h)
    assert lstm_backward.launches == launches              # CPU runs never count
    assert d_xproj.shape == (B, T, D, 4 * H) and dw.shape == (D, 4 * H, H)
    for b, n in enumerate(lens.tolist()):
        assert bool((d_xproj[b, n:] == 0).all())
    # against autograd through the plain forward loop
    xp = xproj.clone().requires_grad_(True)
    wh = w_hh.clone().requires_grad_(True)
    (lstm_recurrence_plain(xp, lens, wh) * grad_h).sum().backward()
    np.testing.assert_allclose(d_xproj.numpy(), xp.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), wh.grad.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        lstm_backward(xproj, lens, w_hh, h, c[:, :, :1], grad_h)


def test_k2_cell_output_leaves_h_unchanged():
    rng = np.random.default_rng(6)
    B, T, D, H = 3, 11, 2, 4
    xproj = torch.from_numpy(rng.standard_normal((B, T, D, 4 * H)).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-0.5, 0.5, (D, 4 * H, H)).astype(np.float32))
    lens = torch.tensor([11, 6, 0], dtype=torch.int32)
    h_only = lstm_recurrence(xproj, lens, w_hh)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    assert torch.equal(h, h_only)                           # bit for bit
    assert c.shape == (B, T, D, H)
    for b, n in enumerate(lens.tolist()):
        assert bool((c[b, n:] == 0).all()) and bool((h[b, n:] == 0).all())
    # h = o·tanh(c) frame by frame
    o = torch.sigmoid(xproj[0, 0, 0, 3 * H:])               # first forward step: h_prev = 0
    np.testing.assert_allclose(h[0, 0, :H].numpy(), (o * torch.tanh(c[0, 0, 0])).numpy(),
                               rtol=0, atol=1e-6)
