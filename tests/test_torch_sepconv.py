"""Parity: the port's fused separable convolution (``lightning_asr_torch/ops/
sepconv_kernels.py``: the plain versions of K9 and K10 on the CPU) and the
model built with ``conv_kernel="sepconv"`` against the JAX package's
``sepconv`` Pallas kernel in interpret mode and its model with
``LASR_SEPCONV_PALLAS`` on, on the same numpy inputs and weights.

Every test that turns JAX's switch on turns it off in a ``finally``: the
tests of a file share one process, and a leaked switch would reroute later
JAX models.  A jitted JAX step is built only after the switch is set, since
the switch is not part of the jit cache key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.ops.sepconv_pallas import sepconv as jax_sepconv
from lightning_asr_tpu.ops.sepconv_pallas import set_sepconv_pallas
from lightning_asr_torch.models import layers as tl
from lightning_asr_torch.models.quartznet import build_model
from lightning_asr_torch.ops.sepconv_kernels import (sepconv, sepconv_backward,
                                                     sepconv_forward)
from lightning_asr_torch.utils.jax_params import from_jax
from test_torch_model import NUM_CLASSES, class_std, with_teeth
from test_torch_train_step import FEATURE_TOL, compare_step, make_batch, setups


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |a|."""
    e = np.floor(np.log2(np.maximum(np.abs(a.astype(np.float32)), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _case(B, T, Cin, Cout, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Cin)).astype(np.float32)
    wd = (rng.standard_normal((k, Cin)) / np.sqrt(k)).astype(np.float32)
    wp = (rng.standard_normal((Cin, Cout)) / np.sqrt(Cin)).astype(np.float32)
    dy = rng.standard_normal((B, T, Cout)).astype(np.float32)
    return x, wd, wp, dy


def _nct(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).transpose(1, 2).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Cin,Cout,k", [(2, 36, 8, 16, 5), (2, 48, 16, 8, 33)])
def test_forward_and_gradients_match_jax_sepconv(B, T, Cin, Cout, k, dtype):
    """K9 and K10's plain versions against ``sepconv(..., interpret=True)``
    and its custom VJP, forward and all three gradients."""
    x, wd, wp, dy = _case(B, T, Cin, Cout, k, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a, b, c: jax_sepconv(a, b, c, True),
                     jnp.asarray(x, jdt), jnp.asarray(wd), jnp.asarray(wp))
    want = [np.asarray(a, np.float32) for a in (y, *vjp(jnp.asarray(dy, jdt)))]

    xt = _nct(x, tdt).requires_grad_(True)
    wdt = torch.from_numpy(wd.T.copy())[:, None, :].requires_grad_(True)   # (Cin, 1, k)
    wpt = torch.from_numpy(wp.T.copy())[:, :, None].requires_grad_(True)   # (Cout, Cin, 1)
    yt = sepconv(xt, wdt, wpt)
    yt.backward(_nct(dy, tdt))
    assert yt.dtype == xt.grad.dtype == tdt
    assert wdt.grad.dtype == wpt.grad.dtype == torch.float32
    got = [yt.detach().float().transpose(1, 2).numpy(), xt.grad.float().transpose(1, 2).numpy(),
           wdt.grad[:, 0, :].t().numpy(), wpt.grad[:, :, 0].t().numpy()]
    (gy, gdx, gwd, gwp), (wy, wdx, wwd, wwp) = got, want
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa: E731
    if dtype == "float32":
        # float32 sums in another order (the pointwise product, the dz product)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    else:
        # The TPU kernel rounds each tap's bf16 product to bf16; XLA on the
        # CPU keeps it in float32 (its default excess precision), so the
        # float32 depthwise sums differ by a few float32 ulps and their bf16
        # rounding flips now and then: 0.0156 seen on values up to 2.7, one
        # bf16 ulp at the largest outputs.
        assert np.all(np.abs(gy - wy) <= bf16_ulp(np.abs(wy).max())), np.abs(gy - wy).max()
        # dx: float32 products and sums, rounded to bf16 once (<= 1 ulp seen)
        assert np.all(np.abs(gdx - wdx) <= bf16_ulp(wdx)), np.abs(gdx - wdx).max()
        # both weight gradients are float32 sums in another order (1.6e-7 seen)
        assert rel(gwd, wwd) < 1e-5 and rel(gwp, wwp) < 1e-5, (rel(gwd, wwd), rel(gwp, wwp))


def test_wrappers_check_and_count():
    x = torch.zeros((2, 8, 20))
    wd, wp = torch.zeros((8, 1, 5)), torch.zeros((4, 8, 1))
    launches = (sepconv_forward.launches, sepconv_backward.launches)
    assert sepconv_forward(x, wd, wp).shape == (2, 4, 20)
    dx, gwd, gwp = sepconv_backward(x, wd, wp, torch.zeros((2, 4, 20)))
    assert (dx.shape, gwd.shape, gwp.shape) == ((2, 8, 20), (8, 1, 5), (4, 8, 1))
    assert gwd.dtype == gwp.dtype == torch.float32
    for bad in ((x.half(), wd, wp),                        # a type the kernels do not take
                (x, torch.zeros((8, 1, 4)), wp),            # even k
                (x.transpose(1, 2).contiguous().transpose(1, 2), wd, wp),   # not contiguous
                (x, wd, torch.zeros((4, 7, 1)))):          # Cin mismatch
        with pytest.raises(ValueError):
            sepconv_forward(*bad)
    with pytest.raises(ValueError):                        # dy of another type
        sepconv_backward(x, wd, wp, torch.zeros((2, 4, 20), dtype=torch.bfloat16))
    assert (sepconv_forward.launches, sepconv_backward.launches) == launches   # CPU runs never count


def test_routing_follows_the_reference():
    """Stride 1 and odd k only: the stride-2 stem keeps F.conv1d, the 14
    block convs take the kernel, and the parameters do not change."""
    model = build_model(NUM_CLASSES, mask=True, conv_kernel="sepconv")
    seps = [m for m in model.modules() if isinstance(m, tl.SepConv)]
    assert len(seps) == 15 and model.encoder.first_cnn.conv_kernel is None
    assert sum(m.conv_kernel == "sepconv" for m in seps) == 14
    plain = build_model(NUM_CLASSES, mask=True)
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    with pytest.raises(ValueError):
        build_model(NUM_CLASSES, conv_kernel="pallas")


@pytest.fixture(scope="module")
def full_width():
    """Full-width quartznet12_context weights with teeth, initialised with
    JAX's switch on, and features of B=2 rows of 64 frames."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 64, 64)).astype(np.float32)
    percents = np.array([1.0, 0.6], np.float32)
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    set_sepconv_pallas(True)
    try:
        on = model.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(percents), False)
    finally:
        set_sepconv_pallas(False)
    params, stats = with_teeth(on["params"], on["batch_stats"], rng)
    return feats, percents, params, stats


def test_full_width_model_matches_jax_sepconv(full_width):
    """The flax tree made with the switch on maps through ``from_jax``
    strictly, and the model with ``conv_kernel="sepconv"`` matches JAX's
    with the switch on (fp32, eval)."""
    feats, percents, params, stats = full_width
    model = jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True)
    set_sepconv_pallas(True)
    try:
        want_lp, want_lens = jax.jit(lambda f, p: model.apply(
            {"params": params, "batch_stats": stats}, f, p, False))(jnp.asarray(feats),
                                                                   jnp.asarray(percents))
    finally:
        set_sepconv_pallas(False)
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)
    port = build_model(NUM_CLASSES, mask=True, conv_kernel="sepconv")
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        lp, lens = port(torch.from_numpy(feats), torch.from_numpy(percents))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    # 16 blocks of float32 sums in another order, as the F.conv1d path
    # (test_torch_model.py)
    assert np.abs(lp.numpy() - want_lp).max() < 1e-4, np.abs(lp.numpy() - want_lp).max()


def test_train_step_from_features_matches_jax_sepconv(full_width):
    """One float32 train step from shared features: the port with
    ``conv_kernel="sepconv"`` (K9, K10's plain versions) against JAX's step
    with its switch on (the Pallas kernels in interpret mode), to the bound
    of the F.conv1d path (test_torch_train_step.py)."""
    from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
    from lightning_asr_tpu.ops.frontend import log_mel_spectrogram, normalize_features

    batch = make_batch(0)
    feats, lens = log_mel_spectrogram(jnp.asarray(batch["waves"]), jnp.asarray(batch["wave_lens"]),
                                      JaxMelConfig(dither=0.0, precision="default"))
    fbatch = {**batch, "waves": np.array(normalize_features(feats, lens)), "wave_lens": np.array(lens)}
    set_sepconv_pallas(True)
    try:
        jstate, jstep, pstate, pstep, _ = setups(full_width[2:], "float32", from_features=True,
                                                 conv_kernel="sepconv")
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in fbatch.items()},
                                 jax.random.PRNGKey(0))
    finally:
        set_sepconv_pallas(False)
    pstate, pmetrics = pstep(pstate, {k: torch.from_numpy(v) for k, v in fbatch.items()})
    compare_step(jstate, jmetrics, pstate, pmetrics, FEATURE_TOL[0])
