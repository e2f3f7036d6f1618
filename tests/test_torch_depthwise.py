"""Parity: the port's depthwise convolution with kernel K11 as its weight
gradient (``lightning_asr_torch/ops/depthwise_kernels.py``, its plain version
on the CPU) and the model built with ``conv_kernel="dw_wgrad"`` against the
JAX package's ``depthwise_conv1d`` (its Pallas weight-gradient kernel in
interpret mode) and its model with ``LASR_DW_WGRAD_PALLAS`` on, on the same
numpy inputs and weights.

Every test that turns JAX's switch on turns it off in a ``finally``, and a
jitted JAX step is built only after the switch is set (see
test_torch_sepconv.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.models import layers as jl
from lightning_asr_tpu.ops.depthwise_pallas import (_wgrad_pallas, depthwise_conv1d,
                                                    set_depthwise_wgrad_pallas)
from lightning_asr_torch.models import layers as tl
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.depthwise_kernels import (depthwise_conv, depthwise_wgrad,
                                                       depthwise_wgrad_plain)
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, with_teeth
from test_torch_sepconv import bf16_ulp
from test_torch_train_step import FEATURE_TOL, compare_step, make_batch, setups

SHAPES = [(2, 40, 8, 5), (1, 48, 16, 33), (3, 300, 24, 7)]    # the last spans two 256-frame chunks


def _case(B, T, C, k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    wd = (rng.standard_normal((k, C)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((B, T, C)).astype(np.float32)
    return x, wd, dy


def _nct(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).transpose(1, 2).contiguous()


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


# bf16: the TPU kernel rounds each product to bf16 (2^-9 relative at most)
# before its float32 sums; XLA on the CPU keeps the product in float32 (its
# default excess precision).  Over sums of random-sign terms that leaves the
# totals ~2^-9 apart relative to the largest (1.6e-3 seen).
WGRAD_BF16_REL = 4e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C,k", SHAPES)
def test_wgrad_plain_matches_jax_kernel(B, T, C, k, dtype):
    """K11's plain version against ``_wgrad_pallas(..., interpret=True)``."""
    x, _, dy = _case(B, T, C, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(_wgrad_pallas(jnp.asarray(x, jdt), jnp.asarray(dy, jdt), k, True))
    got = depthwise_wgrad(_nct(x, tdt), _nct(dy, tdt), k)
    assert got.shape == (C, 1, k) and got.dtype == torch.float32
    # float32: sums in another order (5.7e-7 seen)
    assert _rel(got[:, 0, :].t().numpy(), want) < (1e-5 if dtype == "float32" else WGRAD_BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C,k", SHAPES[:2])
def test_conv_and_gradients_match_jax_depthwise_conv1d(B, T, C, k, dtype):
    """Forward, input gradient (both F.conv1d against XLA's conv) and weight
    gradient (K11's plain version, cast to the weight's type) against JAX's
    custom VJP."""
    x, wd, dy = _case(B, T, C, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a, b: depthwise_conv1d(a, b, True), jnp.asarray(x, jdt),
                     jnp.asarray(wd, jdt))
    wy, wdx, wgw = (np.asarray(a, np.float32) for a in (y, *vjp(jnp.asarray(dy, jdt))))
    xt = _nct(x, tdt).requires_grad_(True)
    wt = torch.from_numpy(wd.T.copy()).to(tdt)[:, None, :].requires_grad_(True)
    yt = depthwise_conv(xt, wt)
    yt.backward(_nct(dy, tdt))
    assert wt.grad.dtype == tdt
    gy, gdx = (a.float().transpose(1, 2).numpy() for a in (yt.detach(), xt.grad))
    ggw = wt.grad[:, 0, :].float().t().numpy()
    if dtype == "float32":
        for a, b in ((gy, wy), (gdx, wdx), (ggw, wgw)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        # the convs agree exactly here (bf16 output of float32 sums); the
        # weight gradient is the K11 result above rounded to bf16: within
        # the product-rounding gap plus one bf16 ulp of the largest (0.0056
        # of the largest seen)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gdx, wdx)
        assert np.all(np.abs(ggw - wgw) <= WGRAD_BF16_REL * np.abs(wgw).max()
                      + bf16_ulp(np.abs(wgw).max())), _rel(ggw, wgw)


def test_wrapper_checks_and_count():
    x = torch.zeros((2, 8, 20))
    launches = depthwise_wgrad.launches
    assert depthwise_wgrad(x, x, 5).shape == (8, 1, 5)
    for args in ((x.half(), x.half(), 5),                  # a type the kernel does not take
                 (x, x, 4),                                # even k
                 (x, x.bfloat16(), 5),                     # dy of another type
                 (x.transpose(1, 2).contiguous().transpose(1, 2), x, 5)):   # not contiguous
        with pytest.raises(ValueError):
            depthwise_wgrad(*args)
    with pytest.raises(ValueError):
        depthwise_conv(x, torch.zeros((8, 1, 4)))
    assert depthwise_wgrad.launches == launches           # CPU runs never count


def test_bf16_layer_gradients_match_jax():
    """A train-mode bf16 SepConv with the switch on: the depthwise weight
    gradient reaches the float32 parameter rounded to bf16, as JAX casts the
    weight before its custom VJP; the stride-2 layer is not routed."""
    rng = np.random.default_rng(3)
    B, T, C, k = 2, 48, 16, 9
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    pct = np.array([1.0, 0.6], np.float32)
    jmod = jl.SepConv(C, C, k=k, mask=True, drop_rate=0.0, dtype=jnp.bfloat16)
    set_depthwise_wgrad_pallas(True)
    try:
        variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pct), False)
        params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)

        def loss_fn(p):
            y, _ = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(pct),
                              True, mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) ** 2)

        want = jax.grad(loss_fn)(params)
    finally:
        set_depthwise_wgrad_pallas(False)
    tmod = tl.SepConv(C, C, k=k, mask=True, drop_rate=0.0, dtype=torch.bfloat16,
                      conv_kernel="dw_wgrad")
    tmod.load_state_dict(from_jax(params, stats), strict=True)
    tmod.train()
    out = tmod(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(pct))
    (out.float() ** 2).sum().backward()
    g = tmod.depthwise_conv.weight.grad
    assert g.dtype == torch.float32 and torch.equal(g, g.bfloat16().float())
    gw = g[:, 0, :].t().numpy()
    wgw = np.asarray(want["depthwise_conv"]["kernel"])[:, 0, :]
    # bf16 activations and BN arithmetic rounded at other places through
    # the layer, then the bf16 gradients: a few bf16 ulps of the largest
    assert _rel(gw, wgw) < 3e-2, _rel(gw, wgw)
    assert tl.SepConv(C, C, k=k, stride=2, conv_kernel="dw_wgrad").conv_kernel is None


@pytest.fixture(scope="module")
def weights():
    """Full-width weights with teeth, the flax tree made with the switch on."""
    rng = np.random.default_rng(11)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    set_depthwise_wgrad_pallas(True)
    try:
        variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 64), jnp.float32),
                               jnp.ones((1,), jnp.float32), False)
    finally:
        set_depthwise_wgrad_pallas(False)
    return with_teeth(variables["params"], variables["batch_stats"], rng)


def test_train_step_from_features_matches_jax_dw_wgrad(weights):
    """One float32 train step from shared features with
    ``conv_kernel="dw_wgrad"`` (the model loads the switch-on tree
    strictly) against JAX's step with its switch on, to the bound of the
    F.conv1d path (test_torch_train_step.py)."""
    from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
    from lightning_asr_tpu.ops.frontend import log_mel_spectrogram, normalize_features

    model = build_model(NUM_CLASSES, mask=True, conv_kernel="dw_wgrad")
    assert sum(m.conv_kernel == "dw_wgrad" for m in model.modules()
               if isinstance(m, tl.SepConv)) == 14
    batch = make_batch(0)
    feats, lens = log_mel_spectrogram(jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lens"]),
                                      JaxMelConfig(dither=0.0, precision="default"))
    fbatch = {**batch, "waves": np.array(normalize_features(feats, lens)), "wave_lens": np.array(lens)}
    set_depthwise_wgrad_pallas(True)
    try:
        jstate, jstep, pstate, pstep, _ = setups(weights, "float32", from_features=True,
                                                 conv_kernel="dw_wgrad")
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in fbatch.items()},
                                 jax.random.PRNGKey(0))
    finally:
        set_depthwise_wgrad_pallas(False)
    pstate, pmetrics = pstep(pstate, {k: torch.from_numpy(v) for k, v in fbatch.items()})
    compare_step(jstate, jmetrics, pstate, pmetrics, FEATURE_TOL[0])
