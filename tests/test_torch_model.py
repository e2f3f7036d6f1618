"""Parity: the port's QuartNet12Context model (``lightning_asr_torch/models``)
and the flax <-> torch weight bridge against the JAX package's flax model,
on the same numpy inputs and weights, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.models import layers as jl
from lightning_asr_torch.models import layers as tl
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.utils.jax_params import from_jax, to_jax

NUM_CLASSES = 29


def with_teeth(params, batch_stats, rng, decoder_scale=10.0):
    """Copies of flax trees with non-trivial BatchNorm statistics and affine
    terms and a scaled-up decoder.  A freshly initialised model gives nearly
    uniform log-probs (class std ~0.02), which any port would match."""
    def walk(p, s):
        p = {k: walk(v, s.get(k, {})) if isinstance(v, dict) else np.array(v) for k, v in p.items()}
        if "mean" in s:
            n = p["scale"].shape[0]
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0.0, 0.2, n).astype(np.float32)
        return p

    def stats(s):
        out = {k: stats(v) for k, v in s.items() if isinstance(v, dict)}
        if "mean" in s:
            n = np.shape(s["mean"])[0]
            out["mean"] = rng.normal(0.0, 0.5, n).astype(np.float32)
            out["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        return out

    params = walk(jax.device_get(params), jax.device_get(batch_stats))
    if "decoder" in params:
        params["decoder"]["kernel"] = params["decoder"]["kernel"] * np.float32(decoder_scale)
    return params, stats(jax.device_get(batch_stats))


def class_std(log_probs):
    """Mean over frames of the std over classes."""
    return float(np.mean(np.std(log_probs, axis=-1)))


def test_lengths_from_percents_exact():
    """``int(float32(T) · (len / T))`` truncated in float32, as in JAX."""
    for T in (7, 51, 100, 101, 801, 1601):
        lens = np.arange(0, T + 1, dtype=np.int32)
        percents = lens.astype(np.float32) / np.float32(T)
        for T2 in (T, -(-T // 2)):
            want = np.asarray(jl._lengths_from_percents(T2, jnp.asarray(percents)))
            got = tl._lengths_from_percents(T2, torch.from_numpy(percents)).numpy()
            np.testing.assert_array_equal(got, want)


def test_weight_bridge_round_trips_bit_for_bit():
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    x = jnp.zeros((1, 40, 64), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, jnp.ones((1,), jnp.float32), False)
    params, stats = jax.device_get((variables["params"], variables["batch_stats"]))
    sd = from_jax(params, stats)
    port = build_model(NUM_CLASSES, mask=True)
    port.load_state_dict(sd, strict=True)          # every key, every shape
    back_p, back_s = to_jax(sd)
    for want, got in ((params, back_p), (stats, back_s)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,stride", [("sepconv", 1), ("sepconv", 2), ("block", 1)])
def test_blocks_match_flax(kind, stride, dtype):
    rng = np.random.default_rng(stride)
    B, T, C = 2, 40, 16
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    if kind == "sepconv":
        jmod = jl.SepConv(C, 24, k=33, stride=stride, mask=True, dtype=jdt)
        tmod = tl.SepConv(C, 24, k=33, stride=stride, mask=True, dtype=tdt)
    else:
        jmod = jl.QuartNetBlock(repeat=2, in_ch=C, out_ch=24, k=33, mask=True, dtype=jdt)
        tmod = tl.QuartNetBlock(repeat=2, in_ch=C, out_ch=24, k=33, mask=True, dtype=tdt)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    percents = np.array([1.0, 27 / 40], np.float32)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(percents), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    want = np.asarray(jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                 jnp.asarray(percents), False), np.float32)
    tmod.load_state_dict(from_jax(params, stats), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(percents))
    got = got.float().transpose(1, 2).numpy()
    assert got.shape == want.shape == (B, -(-T // stride), 24)
    if dtype == "float32":
        # float32 convs summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 activations: XLA and oneDNN round the conv sums and the BN
        # arithmetic at different points; a few bf16 ulps (2^-8 relative)
        np.testing.assert_allclose(got, want, rtol=4e-2, atol=4e-2)
    lens = (np.float32(got.shape[1]) * percents).astype(np.int32)
    if kind == "sepconv":                    # masked before BN: pad frames = BN(0)
        assert not np.allclose(got[1, lens[1]:], 0.0)


@pytest.fixture(scope="module")
def full_width():
    """Full-width quartznet12_context weights with teeth, features of about
    1 s of audio (101 frames) at B=2, and their percents."""
    rng = np.random.default_rng(7)
    B, T = 2, 101
    feats = rng.standard_normal((B, T, 64)).astype(np.float32)
    percents = (np.array([101, 64], np.float32) / np.float32(T)).astype(np.float32)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(percents), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    return feats, percents, params, stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_model_matches_jax(full_width, dtype):
    feats, percents, params, stats = full_width
    jdt = None if dtype == "float32" else jnp.bfloat16
    jmodel = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, dtype=jdt)
    want_lp, want_lens = jax.jit(lambda f, p: jmodel.apply(
        {"params": params, "batch_stats": stats}, f, p, False))(jnp.asarray(feats), jnp.asarray(percents))
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)   # the comparison has teeth

    port = build_model(NUM_CLASSES, mask=True, dtype=None if dtype == "float32" else torch.bfloat16)
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        lp, out_lens = port(torch.from_numpy(feats), torch.from_numpy(percents))
    lp = lp.numpy()
    assert lp.shape == want_lp.shape == (2, 51, NUM_CLASSES) and lp.dtype == np.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    err = np.abs(lp - want_lp)
    if dtype == "float32":
        # 16 blocks of float32 convs summed in another order (~1e-5 seen)
        assert err.max() < 1e-4, err.max()
    else:
        # bf16 convs: both sides round each conv and BN output to bf16
        # (2^-8 relative), at different points, through 16 blocks (max 0.035,
        # mean 0.005 seen on a class std of 2.7)
        assert err.max() < 0.1, err.max()
        assert err.mean() < 0.01, err.mean()
        assert np.mean(lp.argmax(-1) == want_lp.argmax(-1)) > 0.95
