"""Parity: the port's helper modules against the JAX package's, on the CPU:
the LR-policy zoo (``optim/schedules.py``), the masking helpers
(``ops/masking.py``), Swish and Mish (``models/activations.py``),
``sub_sequence_crop`` and ``sample_aug`` (``ops/augment.py``),
``mulaw_decode_host`` (``data/pipeline.py``), ``config_from_dict`` and
``config_hash`` (``utils/config.py``), and the parameter counts and FLOP
estimates of ``models/analysis.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.data.pipeline import mulaw_decode_host as jax_mulaw_decode_host
from lightning_asr_tpu.models import activations as jact
from lightning_asr_tpu.models import analysis as jan
from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops import augment as jaug
from lightning_asr_tpu.ops import masking as jmask
from lightning_asr_tpu.optim import schedules as jsched
from lightning_asr_tpu.utils import config as jconfig
from lightning_asr_torch.data.pipeline import mulaw_decode_host, mulaw_encode
from lightning_asr_torch.models import activations, analysis
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops import augment, masking
from lightning_asr_torch.optim import LR_POLICIES, get_lr_policy
from lightning_asr_torch.utils.config import config_from_dict, config_hash, load_config
from lightning_asr_torch.utils.jax_params import from_jax

NUM_CLASSES = 29
# (policy, arguments): every policy of the zoo, with warmup, a hold where it
# has one, and total_steps inside the 200 steps compared, so that the
# constant past it is compared too
POLICIES = [
    ("WarmupPolicy", dict(initial_lr=0.1, warmup_steps=20, total_steps=150)),
    ("WarmupPolicy", dict(initial_lr=0.1, total_steps=150, warmup_ratio=0.2)),
    ("WarmupHoldPolicy", dict(initial_lr=0.1, warmup_steps=20, hold_steps=30, total_steps=150,
                              min_lr=1e-3)),
    ("SquareAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20, min_lr=1e-4)),
    ("SquareRootAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20, min_lr=1e-4)),
    ("CosineAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20, min_lr=1e-4)),
    ("WarmupAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20)),
    ("InverseSquareRootAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20)),
    ("PolynomialDecayAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20,
                                      min_lr=1e-4, power=2.0)),
    ("PolynomialHoldDecayAnnealing", dict(initial_lr=0.1, total_steps=150, warmup_steps=20,
                                          hold_steps=30, min_lr=1e-4, power=0.5)),
    ("CosineAnnealingWarmupRestarts", dict(first_cycle_steps=60, cycle_mult=2.0, max_lr=0.1,
                                           min_lr=1e-4, warmup_steps=10, gamma=0.5)),
]


@pytest.mark.parametrize("name,kwargs", POLICIES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(POLICIES)])
def test_lr_policy_matches_jax(name, kwargs):
    """Each policy over steps 0-199, by step and over a tensor of steps,
    within 1e-6 relative (float32 both sides; the cosine and power
    functions of two libraries)."""
    assert set(LR_POLICIES) == set(jsched.LR_POLICIES)
    ours, theirs = get_lr_policy(name, **kwargs), jsched.get_lr_policy(name, **kwargs)
    steps = np.arange(200)
    want = np.array([float(theirs(jnp.asarray(s, jnp.int32))) for s in steps], np.float32)
    got = np.array([float(ours(torch.tensor(s, dtype=torch.int32))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name != "CosineAnnealingWarmupRestarts":         # that one takes one step at a time
        np.testing.assert_allclose(ours(torch.from_numpy(steps)).numpy(), want, rtol=1e-6, atol=0)


def test_unknown_lr_policy_and_bad_cosine_raise():
    with pytest.raises(ValueError, match="not a supported lr policy"):
        get_lr_policy("StepLR", initial_lr=0.1)
    with pytest.raises(ValueError, match="initial lr below"):
        get_lr_policy("CosineAnnealing", initial_lr=1e-5, total_steps=10, min_lr=1e-3)


def test_masking_helpers_match_jax():
    """Percentages from lengths, the reference's float32 recovery, the
    length mask and the padding mask, equal to JAX's within 1e-6."""
    rng = np.random.default_rng(0)
    for T in (7, 51, 801, 1601):
        lens = rng.integers(0, T + 1, 16).astype(np.int32)
        lens[:2] = (0, T)
        pct = masking.percents_from_lengths(torch.from_numpy(lens), T)
        want = jmask.percents_from_lengths(jnp.asarray(lens), T)
        np.testing.assert_allclose(pct.numpy(), np.asarray(want), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(masking.lengths_from_percents(pct, T).numpy(),
                                      np.asarray(jmask.lengths_from_percents(want, T)))
        np.testing.assert_array_equal(masking.length_mask(torch.from_numpy(lens), T).numpy(),
                                      np.asarray(jmask.length_mask(jnp.asarray(lens), T)))
    x = rng.standard_normal((3, 9, 4, 2)).astype(np.float32)
    lens = np.array([9, 4, 0], np.int32)
    np.testing.assert_allclose(masking.mask_padding(torch.from_numpy(x), torch.from_numpy(lens)).numpy(),
                               np.asarray(jmask.mask_padding(jnp.asarray(x), jnp.asarray(lens))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["relu", "swish", "mish"])
def test_activations_match_jax(name):
    x = np.concatenate([np.linspace(-30, 30, 601), [0.0, -1e-8, 1e-8]]).astype(np.float32)
    got = activations.get_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        activations.get_activation("gelu")


def test_sub_sequence_crop_bit_for_bit():
    """The same ``np.random.Generator`` draws give the same windows."""
    ours, theirs = np.random.default_rng(9), np.random.default_rng(9)
    for length in [1, 2, 160, 16000, 267_200] * 20:
        assert augment.sub_sequence_crop(length, ours) == jaug.sub_sequence_crop(length, theirs)
    assert augment.sub_sequence_crop(1000, np.random.default_rng(1), weight=0.5) == \
        jaug.sub_sequence_crop(1000, np.random.default_rng(1), weight=0.5)


@pytest.mark.parametrize("prob", [0.4, 0.9])
def test_sample_aug_exact_with_jax_draws(prob):
    """Given JAX's two uniforms (p's and the cells'), the port's mask is
    JAX's exactly; without uniforms it draws from a generator."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 50, 64)).astype(np.float32)
    key = jax.random.PRNGKey(int(prob * 10))
    want = np.asarray(jaug.sample_aug(jnp.asarray(feats), key, prob=prob))
    k_p, k_m = jax.random.split(key)
    u_p = np.array(jax.random.uniform(k_p, ()))
    u = np.array(jax.random.uniform(k_m, feats.shape))
    got = augment.sample_aug(torch.from_numpy(feats), prob=prob,
                             uniforms=(torch.from_numpy(u_p), torch.from_numpy(u))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < np.mean(got == 0) < 1
    drawn = augment.sample_aug(torch.from_numpy(feats), torch.Generator().manual_seed(0), prob=prob)
    assert drawn.shape == feats.shape and 0 < float((drawn == 0).float().mean()) < 1
    with pytest.raises(ValueError):
        augment.sample_aug(torch.from_numpy(feats))


def test_mulaw_decode_host_exact():
    """Every code 0-255, and the codes of an int16 wave, decode to JAX's
    float32 bits."""
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(mulaw_decode_host(codes), jax_mulaw_decode_host(codes))
    wave = (np.random.default_rng(0).standard_normal(4000) * 3000).astype(np.int16)
    c = mulaw_encode(wave)
    got = mulaw_decode_host(c)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_mulaw_decode_host(c))


def test_config_hash_equals_jax():
    """``config_from_dict`` and ``config_hash`` of the repository's configs
    (unresolved: their run directory interpolates the clock) and of a
    hand-made dict give JAX's 12 hex digits."""
    for cfg_path in ("conf/conf.yaml", "conf/ssl-conf.yaml"):
        ours = load_config(cfg_path, resolve=False)
        theirs = jconfig.load_config(cfg_path, resolve=False)
        assert ours.to_dict() == theirs.to_dict()
        assert config_hash(ours) == jconfig.config_hash(theirs)
    d = {"b": {"y": [1, 2.5, None], "x": "s"}, "a": True, "c": {"path": __import__("pathlib").Path("p")}}
    ours, theirs = config_from_dict(d), jconfig.config_from_dict(d)
    assert ours.b.x == "s" and ours.to_dict() == theirs.to_dict()
    h = config_hash(ours)
    assert h == jconfig.config_hash(theirs) and len(h) == 12 and int(h, 16) >= 0
    assert config_hash(config_from_dict({**d, "a": False})) != h


MODELS = [("quartznet12_context", {}), ("quartznet12_context_se", {}), ("quartznet15x5", {}),
          ("quartznet10x5", {}), ("quartznet12_context", {"lstm_head": True})]
# FlopCounterMode counts the products of matmuls and convolutions; XLA's
# cost analysis also counts elementwise work and the SE layers' products
# (the port's Dense is an elementwise product and sum).  On (1, 256, 64)
# the two counts differed by 0.09% (SE) to 2.05% (the LSTM head model).
FLOPS_RTOL = 0.03


@pytest.mark.parametrize("encoder,kwargs", MODELS, ids=[e + ("-head" if k else "") for e, k in MODELS])
def test_params_and_flops_match_jax(encoder, kwargs):
    """``count_params`` and ``param_breakdown`` (depth 1 and 2) equal JAX's
    for the four encoders and the head model; ``flops_estimate`` within
    ``FLOPS_RTOL`` of JAX's."""
    shape = (1, 256, 64)
    jmodel = jax_build_model(NUM_CLASSES, encoder, mask=True, **kwargs)
    variables = jax.jit(lambda x, p: jmodel.init(jax.random.PRNGKey(0), x, p, False))(
        jnp.zeros(shape), jnp.ones((1,)))
    params = jax.device_get(variables["params"])
    port = build_model(NUM_CLASSES, encoder, mask=True, **kwargs)
    port.load_state_dict(from_jax(params, jax.device_get(variables["batch_stats"])), strict=True)
    assert analysis.count_params(port) == jan.count_params(params)
    for depth in (1, 2):
        assert analysis.param_breakdown(port, depth) == jan.param_breakdown(params, depth)
    want = jan.flops_estimate(jmodel, shape)
    got = analysis.flops_estimate(port, shape)
    assert got is not None and want is not None
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    assert "params:" in analysis.summarize(port, shape) and port.training
