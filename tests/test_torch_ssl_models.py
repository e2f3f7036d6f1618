"""Parity: the port's SSL models (``AsrModel(feature_in=512)``,
``DualStreamAsrModel``, ``SSLRetrainAsrModel`` with both norms), its
wav2vec2 feature encoder and the weight and NovoGrad bridges of their trees
against the JAX package's flax models, on the same numpy inputs and weights
(carried across with ``from_jax``), on the CPU; the feature encoder also
against HuggingFace's ``Wav2Vec2FeatureEncoder`` built from a config (no
download).

Tolerances: the models' float32 log-probs within 1e-5 (rtol and atol, the
block tolerance of ``test_torch_model.py``): float32 sums in another order;
the feature encoder against HuggingFace's within 1e-5 as well (both are
PyTorch's float32 convs and norms); the bridges and the output lengths
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.models.dual_stream import DualStreamAsrModel as JaxDual
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.ssl_codec.retrain import SSLRetrainAsrModel as JaxRetrain
from lightning_asr_tpu.ssl_codec.wav2vec_flax import Wav2Vec2FeatureEncoderFlax
from lightning_asr_tpu.ssl_codec.wav2vec_flax import (
    convert_hf_feature_encoder as jax_convert_hf)
from lightning_asr_torch.models.dual_stream import DualStreamAsrModel
from lightning_asr_torch.models.quartznet import build_model, reset_parameters
from lightning_asr_torch.optim import novograd
from lightning_asr_torch.ssl_codec.retrain import SSLRetrainAsrModel, load_hf_encoder_into_params
from lightning_asr_torch.ssl_codec.wav2vec import (Wav2Vec2FeatureEncoder,
                                                   convert_hf_feature_encoder, output_lengths)
from lightning_asr_torch.training.steps import create_train_state
from lightning_asr_torch.utils.jax_params import (from_jax, opt_state_from_jax, opt_state_to_jax,
                                                  to_jax)
from test_torch_model import NUM_CLASSES, class_std, with_teeth

TOL = 1e-5
KINDS = ("feature_in", "dual", "retrain_layer", "retrain_group")
B = 2
S = 8000                                  # 0.5 s: 24 wav2vec2 frames
WAVE_LENS = (8000, 6000)
T_FEAT, FEAT_LENS = 100, (100, 61)        # the feature models' frames
T_MEL = 98                                # the dual model's mel stream, shorter


def with_norm_teeth(params, rng):
    """LayerNorm / GroupNorm scales and biases away from ones and zeros."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            v = with_norm_teeth(v, rng)
            if k.startswith(("ln", "gn")):
                n = v["scale"].shape[0]
                v = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                     "bias": rng.normal(0.0, 0.2, n).astype(np.float32)}
        out[k] = v
    return out


def jax_model(kind):
    if kind == "feature_in":
        return jax_build_model(NUM_CLASSES, "quartznet12_context", mask=True, feature_in=512)
    if kind == "dual":
        return JaxDual(num_classes=NUM_CLASSES, mask=True)
    norm = kind.split("_")[1]
    return JaxRetrain(num_classes=NUM_CLASSES, mask=True, feat_extract_norm=norm,
                      conv_bias=norm == "layer", augment_cutout=False)


def port_model(kind):
    if kind == "feature_in":
        return build_model(NUM_CLASSES, mask=True, feature_in=512)
    if kind == "dual":
        return DualStreamAsrModel(NUM_CLASSES, mask=True)
    norm = kind.split("_")[1]
    return SSLRetrainAsrModel(NUM_CLASSES, mask=True, feat_extract_norm=norm,
                              conv_bias=norm == "layer", augment_cutout=False)


def inputs(kind, rng):
    """The model's inputs as numpy arrays: features and percents, or waves
    (int16 on the "layer" model, the retrain entry point's wire) and their
    lengths."""
    if kind in ("feature_in", "dual"):
        percents = (np.array(FEAT_LENS, np.float32) / np.float32(T_FEAT)).astype(np.float32)
        w2v = rng.standard_normal((B, T_FEAT, 512)).astype(np.float32)
        if kind == "feature_in":
            return (w2v, percents)
        return (w2v, rng.standard_normal((B, T_MEL, 64)).astype(np.float32), percents)
    waves = np.zeros((B, S), np.float32)
    for b, n in enumerate(WAVE_LENS):
        waves[b, :n] = rng.standard_normal(n) * 0.1
    if kind == "retrain_layer":
        waves = np.round(waves * 30000).astype(np.int16)
    return (waves, np.array(WAVE_LENS, np.int32))


@pytest.fixture(scope="module", params=KINDS)
def ssl_weights(request):
    """(kind, flax params with teeth, batch_stats, numpy inputs)."""
    kind = request.param
    rng = np.random.default_rng(KINDS.index(kind))
    x = inputs(kind, rng)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "augment": jax.random.PRNGKey(2)}
    variables = jax_model(kind).init(rngs, *map(jnp.asarray, x), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    return kind, with_norm_teeth(params, rng), stats, x


def test_models_match_jax_fp32(ssl_weights):
    """Eval-mode log-probs within TOL and the output lengths equal."""
    kind, params, stats, x = ssl_weights
    jmodel = jax_model(kind)
    want_lp, want_lens = jax.jit(lambda *a: jmodel.apply(
        {"params": params, "batch_stats": stats}, *a, False))(*map(jnp.asarray, x))
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)   # the comparison has teeth

    port = port_model(kind)
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.eval()
    with torch.no_grad():
        lp, out_lens = port(*map(torch.from_numpy, x))
    frames = {"feature_in": T_FEAT // 2, "dual": T_MEL // 2}.get(kind, 12)
    assert lp.shape == want_lp.shape == (B, frames, NUM_CLASSES) and lp.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=TOL, atol=TOL)


def test_weight_and_optimizer_bridges_round_trip(ssl_weights):
    """Each SSL tree (the mapping's 2-D kernel and bias, the LayerNorm and
    GroupNorm scales as 1-D ``weight``s, the wav2vec2 conv kernels) -> the
    port's state_dict (every key and shape) -> the flax tree, bit for bit;
    a fused NovoGrad state after one update -> the port's layout -> JAX's,
    bit for bit."""
    kind, params, stats, _ = ssl_weights
    sd = from_jax(params, stats)
    port = port_model(kind)
    port.load_state_dict(sd, strict=True)
    norms = [k for k in sd if k.rsplit(".", 2)[-2].startswith(("ln", "gn"))]
    assert all(sd[k].ndim == 1 for k in norms)
    assert len(norms) == {"retrain_layer": 14, "retrain_group": 2}.get(kind, 0)
    back_p, back_s = to_jax(sd)
    for want, got in ((params, back_p), (stats, back_s)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)

    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
                         params)
    jstate = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    template = create_train_state(port, novograd(1e-2, fused=True))
    back = opt_state_to_jax(opt_state_from_jax(jstate, params, stats, template.params),
                            template.params, template.batch_stats)
    for k in ("count", "exp_avg", "exp_avg_sq", "max_exp_avg_sq", "p_flat"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstate, k)), err_msg=k)


def test_build_model_feature_in_and_init():
    """``build_model(feature_in=512)`` maps 512 -> in_c with a float32
    ``Dense`` with bias; ``reset_parameters`` draws the mapping U(±1/sqrt(512))
    and the wav2vec2 convs flax's lecun-normal (std 1/sqrt(fan_in), cut at
    two deviations) with zero bias, the norms ones and zeros."""
    model = build_model(NUM_CLASSES, "quartznet15x5", in_c=64, feature_in=512, mask=True,
                        dtype=torch.bfloat16)
    assert tuple(model.feature_mapping.weight.shape) == (64, 512)
    assert tuple(model.feature_mapping.bias.shape) == (64,)
    gen = torch.Generator().manual_seed(0)
    retrain = SSLRetrainAsrModel(NUM_CLASSES, feat_extract_norm="layer", conv_bias=True)
    with torch.no_grad():
        retrain.wav2vec.ln3.weight.fill_(2.0)
    reset_parameters(retrain, gen)
    w, bound = retrain.feature_mapping.weight.detach(), 1 / np.sqrt(512)
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound
    k = retrain.wav2vec.conv1.weight.detach()               # fan_in 512 * 3
    std = 1 / np.sqrt(1536) / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * std and 0.8 < float(k.std()) * np.sqrt(1536) < 1.2
    assert float(retrain.wav2vec.conv1.bias.detach().abs().max()) == 0.0
    assert float(retrain.wav2vec.ln3.weight.detach().min()) == 1.0


def test_output_lengths_match_jax_and_hf():
    for n in (400, 3200, 12345, 16000, 267200):
        want = int(Wav2Vec2FeatureEncoderFlax.output_lengths(np.asarray([n]))[0])
        assert output_lengths(n) == want
        assert int(output_lengths(torch.tensor([n]))[0]) == want
    assert output_lengths(267200) == 834


@pytest.mark.parametrize("norm,bias", [("group", False), ("layer", True)])
def test_feature_encoder_matches_hf_and_jax_converter(norm, bias):
    """``convert_hf_feature_encoder`` equals the JAX converter's tree
    through ``from_jax`` bit for bit, the port's encoder with it gives HF's
    features within TOL, and ``load_hf_encoder_into_params`` puts it into a
    model's parameters under either prefix."""
    pytest.importorskip("transformers")
    from transformers import Wav2Vec2Config
    from transformers.models.wav2vec2.modeling_wav2vec2 import Wav2Vec2FeatureEncoder as HF

    torch.manual_seed(0)
    hf = HF(Wav2Vec2Config(feat_extract_norm=norm, conv_bias=bias)).eval()
    converted = convert_hf_feature_encoder(hf.state_dict(), norm=norm)
    want_sd = from_jax(jax_convert_hf(hf.state_dict(), norm=norm), {})
    assert converted.keys() == want_sd.keys()
    assert all(torch.equal(converted[k], want_sd[k]) for k in want_sd)

    enc = Wav2Vec2FeatureEncoder(norm, bias)
    enc.load_state_dict(converted, strict=True)
    waves = torch.from_numpy(np.random.default_rng(1).standard_normal((2, S)).astype(np.float32) * 0.1)
    with torch.no_grad():
        want = hf(waves).transpose(1, 2)
        got = enc(waves)
    assert got.shape == want.shape == (2, output_lengths(S), 512)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)

    model = SSLRetrainAsrModel(NUM_CLASSES, feat_extract_norm=norm, conv_bias=bias)
    params = dict(model.named_parameters())
    prefixed = {f"wav2vec2.feature_extractor.{k}": v for k, v in hf.state_dict().items()}
    new = load_hf_encoder_into_params(params, prefixed, norm=norm)
    assert new.keys() == params.keys()
    assert all(torch.equal(new[f"wav2vec.{k}"], v) for k, v in converted.items())
    assert new["feature_mapping.weight"] is params["feature_mapping.weight"]
    with pytest.raises(ValueError, match="does not match"):
        load_hf_encoder_into_params(params, prefixed, norm="layer" if norm == "group" else "group")
