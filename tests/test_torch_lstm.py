"""Parity: the port's bidirectional LSTM (``lightning_asr_torch/ops/lstm.py``
with kernel K2's plain version) against the JAX package's scan LSTM and its
Pallas kernel (interpret mode), on the same numpy inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.ops.lstm import LSTMWeights as JW
from lightning_asr_tpu.ops.lstm import lstm as jax_lstm
from lightning_asr_tpu.ops.lstm_pallas import lstm_pallas
from lightning_asr_torch.ops.lstm import LSTMWeights, lstm
from lightning_asr_torch.ops.lstm_kernels import lstm_recurrence


def _weights(rng, IN, H):
    s = 1.0 / np.sqrt(H)
    return [rng.uniform(-s, s, shape).astype(np.float32)
            for shape in ((4 * H, IN), (4 * H, H), (4 * H,), (4 * H,))]


def _case(seed, B, T, IN, H, lengths):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    return x, np.array(lengths, np.int32), _weights(rng, IN, H), _weights(rng, IN, H)


def _port(x, lens, fw, bw):
    return lstm(torch.from_numpy(x), torch.from_numpy(lens),
                LSTMWeights(*map(torch.from_numpy, fw)),
                None if bw is None else LSTMWeights(*map(torch.from_numpy, bw))).numpy()


@pytest.mark.parametrize("T,lengths", [(21, [21, 9, 1]), (16, [3, 16, 12])])
def test_bilstm_matches_jax_scan_and_pallas(T, lengths):
    x, lens, fw, bw = _case(0, 3, T, 12, 8, lengths)
    got = _port(x, lens, fw, bw)
    jx, jl = jnp.asarray(x), jnp.asarray(lens)
    jfw, jbw = JW(*map(jnp.asarray, fw)), JW(*map(jnp.asarray, bw))
    want_scan = np.asarray(jax_lstm(jx, jl, jfw, jbw))
    want_pallas = np.asarray(lstm_pallas(jx, jl, jfw, jbw))
    assert got.shape == (3, T, 16)
    # float32 throughout; only the order of the 12- and 8-term dot sums differs
    np.testing.assert_allclose(got, want_scan, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-5)
    for b, n in enumerate(lens):
        assert np.all(got[b, n:] == 0.0)          # exact zeros at pad frames
        assert np.all(np.abs(got[b, :n]).sum(-1) > 0)


def test_unidirectional_matches_jax():
    x, lens, fw, _ = _case(1, 2, 10, 6, 4, [10, 4])
    got = _port(x, lens, fw, None)
    want = np.asarray(jax_lstm(jnp.asarray(x), jnp.asarray(lens), JW(*map(jnp.asarray, fw))))
    assert got.shape == (2, 10, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reverse_direction_starts_at_true_last_frame():
    """A row padded with garbage frames gives the same outputs on its valid
    frames as the same row unpadded (packed-sequence semantics)."""
    x, lens, fw, bw = _case(2, 1, 7, 5, 4, [7])
    padded = np.concatenate([x, np.full((1, 5, 5), 9.0, np.float32)], axis=1)
    short = _port(x, lens, fw, bw)
    long = _port(padded, lens, fw, bw)
    # the input projection is one matmul over 7 vs 12 frames: fp32 ulps
    np.testing.assert_allclose(long[:, :7], short, rtol=0, atol=1e-6)
    assert np.all(long[:, 7:] == 0.0)


def test_k2_wrapper_checks():
    xproj = torch.zeros(2, 5, 2, 16)
    w_hh = torch.zeros(2, 16, 4)
    lens = torch.tensor([5, 2], dtype=torch.int32)
    assert lstm_recurrence(xproj, lens, w_hh).shape == (2, 5, 8)
    launches = lstm_recurrence.launches
    with pytest.raises(ValueError):
        lstm_recurrence(xproj, lens.long(), w_hh)
    with pytest.raises(ValueError):
        lstm_recurrence(xproj, lens, w_hh[:1])
    with pytest.raises(ValueError):
        lstm_recurrence(xproj.double(), lens, w_hh)
    with pytest.raises(ValueError):
        lstm_recurrence(xproj.transpose(0, 1), lens, w_hh)
    assert lstm_recurrence.launches == launches   # CPU runs never count
