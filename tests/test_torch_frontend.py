"""Parity: the port's log-mel frontend (``lightning_asr_torch/ops/frontend.py``
and kernel K1's plain version) against the JAX package's, on the same numpy
inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.ops import frontend as jf
from lightning_asr_torch.ops import frontend as tf
from lightning_asr_torch.ops.frontend_kernels import mel_from_extended

# one bf16 rounding flip of one power term moves a mel value by at most
# 10·log10(1 + 2^-8) = 0.017 dB; the narrowest mel filters span two FFT bins
_BF16_FLIP_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, S = 4, 16000
    waves = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    # full row, ragged rows, and one just above the n_fft//2 + pad = 288
    # sample support limit of the reflect extension
    lens = np.array([16000, 9001, 4000, 289], np.int32)
    return waves, lens


def _both(waves, lens, precision):
    jcfg = jf.MelFrontendConfig(dither=0.0, precision=precision)
    tcfg = tf.MelFrontendConfig(dither=0.0, precision=precision)
    jm, jl = jf.log_mel_spectrogram(jnp.asarray(waves), jnp.asarray(lens), jcfg)
    jn = jf.normalize_features(jm, jl)
    tm, tl = tf.log_mel_spectrogram(torch.from_numpy(waves), torch.from_numpy(lens), tcfg)
    tn = tf.normalize_features(tm, tl)
    return (np.asarray(jm), np.asarray(jl), np.asarray(jn)), (tm.numpy(), tl.numpy(), tn.numpy())


def test_config_and_filters_match():
    cfg_j = jf.MelFrontendConfig(precision="default")
    cfg_t = tf.MelFrontendConfig.from_dict({**cfg_j.__dict__, "unknown_future_key": 1})
    assert cfg_t.precision == "default" and cfg_t.n_freqs == cfg_j.n_freqs
    np.testing.assert_array_equal(tf.dft_filters(cfg_t), jf.dft_filters(cfg_j))
    np.testing.assert_array_equal(tf.mel_filterbank(cfg_t), jf.mel_filterbank(cfg_j))
    for n in (289, 16000, 256000):
        assert tf.mel_num_frames(n, cfg_t) == int(jf.mel_num_frames(n, cfg_j))
    with pytest.raises(ValueError):
        tf.MelFrontendConfig(precision="fast")


def test_extend_and_preemphasis_are_exact():
    waves, lens = _inputs(1)
    cfg = jf.MelFrontendConfig()
    prev = np.array([0.5, -0.25, 0.0, 1.0], np.float32)
    want = jf._extend_signal(jf._preemphasis(jnp.asarray(waves), jnp.asarray(prev), cfg.preemph),
                             jnp.asarray(lens), cfg)
    got = tf._extend_signal(tf._preemphasis(torch.from_numpy(waves), torch.from_numpy(prev),
                                            cfg.preemph), torch.from_numpy(lens), tf.MelFrontendConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wire", ["int16", "uint8"])
def test_expand_wire(wire):
    rng = np.random.default_rng(2)
    info = np.iinfo(wire)
    codes = rng.integers(info.min, info.max, size=(2, 300), endpoint=True).astype(wire)
    want = np.asarray(jf.expand_wire(jnp.asarray(codes)))
    got = tf.expand_wire(torch.from_numpy(codes)).numpy()
    # closed-form mu-law uses exp/log: float32 ulp-level differences
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_highest_tier_matches_jax():
    waves, lens = _inputs()
    (jm, jl, jn), (tm, tl, tn) = _both(waves, lens, "highest")
    assert tm.shape == jm.shape and tm.dtype == np.float32
    np.testing.assert_array_equal(tl, jl)
    # float32 DFT sums in another order.  Preemphasis attenuates the lowest
    # bins by ~30 dB, so there the sums cancel and keep fewer digits: a few
    # values reach ~2e-3 dB, the rest agree to 1e-3 dB
    err = np.abs(tm - jm)
    assert err.max() < 5e-3, err.max()
    assert np.mean(err > 1e-3) < 1e-3, np.mean(err > 1e-3)
    assert err.mean() < 1e-5, err.mean()
    # normalized: the dB error over a per-utterance std of ~10 dB or more
    np.testing.assert_allclose(tn, jn, atol=5e-4)


def test_default_tier_plain_k1_matches_jax_pallas_interpret():
    """JAX's default tier runs ``mel_from_extended`` (the Pallas kernel) in
    interpret mode here; the port's runs K1's plain version on the CPU
    tensor."""
    waves, lens = _inputs()
    (jm, jl, jn), (tm, tl, tn) = _both(waves, lens, "default")
    assert tm.shape == jm.shape
    np.testing.assert_array_equal(tl, jl)
    err = np.abs(tm - jm)
    # Both sides take bf16 products with fp32 sums, in different orders
    # (MKL vs XLA).  Where the DFT cancels (the low bins that preemphasis
    # attenuates) the sums differ by more than an fp32 ulp, which can flip
    # the bf16 rounding of a power term: at most _BF16_FLIP_DB per value.
    # Everywhere else the two agree to the JAX kernel test's 5e-3 dB.
    assert err.max() < _BF16_FLIP_DB, err.max()
    assert np.mean(err > 5e-3) < 1e-3, np.mean(err > 5e-3)
    assert err.mean() < 1e-4, err.mean()
    np.testing.assert_allclose(tn, jn, atol=5e-3)


def test_k1_wrapper_checks_and_cpu_route():
    cfg = tf.MelFrontendConfig(precision="default")
    q = torch.zeros(2, 5000)
    out = mel_from_extended(q, cfg, 10)
    assert out.shape == (2, 10, cfg.n_mels)
    assert torch.all(out == 10 * np.log10(cfg.amin)).item()
    launches = mel_from_extended.launches
    with pytest.raises(ValueError):
        mel_from_extended(q.double(), cfg, 10)
    with pytest.raises(ValueError):
        mel_from_extended(q.t(), cfg, 10)
    with pytest.raises(ValueError):
        mel_from_extended(q, cfg, 0)
    assert mel_from_extended.launches == launches  # CPU runs never count
