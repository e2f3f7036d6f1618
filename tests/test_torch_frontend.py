"""Parity: the port's log-mel frontend (``lightning_asr_torch/ops/frontend.py``
and kernel K1's plain version) against the JAX package's, on the same numpy
inputs, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.ops import frontend as jf
from lightning_asr_tpu.ops import frontend_pallas as jf_pallas
from lightning_asr_torch.ops import frontend as tf
from lightning_asr_torch.ops.frontend_kernels import extend_preemph, mel_from_extended

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


def _preemph_once(waves, prev, coeff):
    """``y - c·prev`` rounded once, as a fused multiply-add gives it: the
    product of two float32 values is exact in float64, and the difference
    rounded there then to float32 lands on the same float32 value for
    these inputs."""
    w = waves.astype(np.float64)
    before = np.concatenate([np.zeros_like(w[:, :1]), w[:, :-1]], axis=1)
    if prev is not None:
        before[:, 0] = prev
    return (w - np.float64(np.float32(coeff)) * before).astype(np.float32)


@pytest.mark.parametrize("pad,with_prev", [(32, False), (32, True), (0, True)])
def test_k6_plain_matches_jax_extend_preemph(pad, with_prev):
    """K6's plain version (a CPU tensor) against JAX's ``extend_preemph`` in
    interpret mode and the XLA composition it fuses, with and without
    ``prev_samples``, zero tail included.

    The TPU kernel, the composition, the port's plain version and its CUDA
    kernel all round ``y - c·prev`` twice (product, then difference).  In
    the jitted interpret run XLA on the CPU contracts most of these into one
    fused multiply-add, which rounds once (tests/test_frontend_pallas.py
    allows for it), so each of that run's samples must equal the port's bit
    for bit or the once-rounded value."""
    waves, lens = _inputs(3)
    B, S = waves.shape
    prev = np.random.default_rng(4).standard_normal(B).astype(np.float32) if with_prev else None
    jcfg, tcfg = jf.MelFrontendConfig(pad=pad), tf.MelFrontendConfig(pad=pad)
    out_len = S + 2 * pad + tcfg.n_fft
    out_total = out_len + 128 + 160                     # >= JAX's out_len + 128
    jprev = None if prev is None else jnp.asarray(prev)
    got = extend_preemph(torch.from_numpy(waves), torch.from_numpy(lens),
                         None if prev is None else torch.from_numpy(prev), tcfg, out_total).numpy()
    assert got.shape == (B, out_total)
    np.testing.assert_array_equal(got[:, out_len:], 0.0)
    composition = jf._extend_signal(jf._preemphasis(jnp.asarray(waves), jprev, jcfg.preemph),
                                    jnp.asarray(lens), jcfg)
    np.testing.assert_array_equal(got[:, :out_len], np.asarray(composition))

    kernel = np.asarray(jf_pallas.extend_preemph(jnp.asarray(waves), jnp.asarray(lens), jprev, jcfg,
                                                 out_total=out_total, interpret=True))
    once = tf._extend_signal(torch.from_numpy(_preemph_once(waves, prev, jcfg.preemph)),
                             torch.from_numpy(lens), tcfg).numpy()
    once = np.concatenate([once, np.zeros((B, out_total - out_len), np.float32)], axis=1)
    assert np.all((kernel == got) | (kernel == once))


def test_k6_wrapper_checks_and_cpu_route():
    cfg = tf.MelFrontendConfig()
    waves, lens = torch.zeros((2, 1000)), torch.tensor([1000, 400], dtype=torch.int32)
    out_len = 1000 + 2 * cfg.pad + cfg.n_fft
    launches = extend_preemph.launches
    assert extend_preemph(waves, lens, None, cfg, out_len + 7).shape == (2, out_len + 7)
    for args in ((waves.double(), lens, None), (waves.t().contiguous().t(), lens, None),
                 (waves, lens[:1], None), (waves, lens, torch.zeros(3))):
        with pytest.raises(ValueError):
            extend_preemph(*args, cfg, out_len)
    with pytest.raises(ValueError):                     # shorter than the extension
        extend_preemph(waves, lens, None, cfg, out_len - 1)
    assert extend_preemph.launches == launches          # CPU runs never count
