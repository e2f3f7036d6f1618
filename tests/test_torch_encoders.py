"""Parity: the port's other three encoders (``quartznet12_context_se``,
``quartznet15x5``, ``quartznet10x5``; ``lightning_asr_torch/models``) and
their squeeze-excite layers against the JAX package's flax models, on the
same numpy inputs and weights (carried across with ``from_jax``), on the
CPU.  Whole encoders run at full width on a short time axis (B = 2, 96
frames); the JAX BiLSTM of the SE encoder runs its Pallas kernel in
interpret mode, as the JAX package's own tests run it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_asr_tpu.models import build_model as jax_build_model
from lightning_asr_tpu.models import layers as jl
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_tpu.ops.frontend import MelFrontendConfig as JaxMelConfig
from lightning_asr_tpu.training.steps import AsrTrainState as JaxState
from lightning_asr_tpu.training.steps import make_train_step as jax_make_train_step
from lightning_asr_torch.inference.predict import AsrTranslator
from lightning_asr_torch.models import layers as tl
from lightning_asr_torch.models.quartznet import (MODEL_REGISTRY, PORTED_ENCODERS, build_model,
                                                  reset_parameters)
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.optim import cosine_annealing_warmup_restarts, novograd
from lightning_asr_torch.optim.novograd import FlatLayout
from lightning_asr_torch.train import main as train_main
from lightning_asr_torch.training.steps import create_train_state, make_train_step
from lightning_asr_torch.utils.jax_params import (from_jax, opt_state_from_jax, opt_state_to_jax,
                                                  to_jax)
from test_torch_model import NUM_CLASSES, class_std, with_teeth
from test_torch_pipeline import tone_corpus
from test_torch_train_step import (FRONTEND, RECIPE_TOL, SCHEDULE, as_jax_trees,
                                   jax_capture, leaves, port_capture, rel_err)

ENCODERS = ("quartznet12_context_se", "quartznet15x5", "quartznet10x5")
B, T = 2, 96
LENS = (90, 61)                  # frames; no row fills the padding (C5)


def _dtypes(dtype):
    return (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)


def _assert_close(got, want, dtype):
    """The block tolerances of ``test_torch_model.py``: float32 convs summed
    in another order; bf16 activations rounded at different points (a few
    bf16 ulps, 2^-8 relative)."""
    tol = 1e-5 if dtype == "float32" else 4e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_se_layer_matches_flax(dtype):
    """The squeeze-excite stage alone, at 16 channels (hidden 2): the mean
    over every frame, two bias-free Dense layers, sigmoid, rescale; with a
    bf16 input both sides return float32 (the float32 Dense weights
    promote)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    jdt, tdt = _dtypes(dtype)
    jx = jnp.asarray(x, jdt or jnp.float32)
    jmod = jl.SELayer(16)
    variables = jmod.init(jax.random.PRNGKey(2), jx)
    want = jmod.apply(variables, jx)
    tmod = tl.SELayer(16)
    tmod.load_state_dict(from_jax(jax.device_get(variables["params"]), {}), strict=True)
    assert tuple(tmod.fc1.weight.shape) == (2, 16) and tuple(tmod.fc2.weight.shape) == (16, 2)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(tdt or torch.float32).transpose(1, 2))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _assert_close(got.transpose(1, 2).numpy(), np.asarray(want), dtype)


@pytest.mark.parametrize("shape", [(512, 64), (64, 512)])
def test_dense_row_does_not_depend_on_its_batch(shape):
    """The SE's Dense layers give each row the same bits in a batch of 1,
    2, 8 or 32 (``F.linear`` does not: its GEMM kernel changes with the row
    count), so a stream's one-row windows equal ``translate_long``'s rows
    (ROADMAP C13)."""
    dense = tl.Dense(*shape)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(32, shape[0], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        alone = dense(x[:1])[0]
        for b in (2, 8, 32):
            assert torch.equal(dense(x[:b])[0], alone), b
        np.testing.assert_allclose(dense(x).numpy(), (x @ dense.weight.t()).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,last", [(1, False), (2, False), (1, True)])
def test_sepconv_se_matches_flax(stride, last, dtype):
    """``SepConvSE`` (16 -> 24 channels, k33, mask on) in eval mode, and in
    train mode with BatchNorm batch statistics (output and the updated
    running statistics); float32 out of a bf16 block on both sides."""
    rng = np.random.default_rng(stride + 2 * last)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    percents = np.array([1.0, 27 / 40], np.float32)
    jdt, tdt = _dtypes(dtype)
    # dropout off: jax.random and torch.Generator cannot draw the same bits
    jmod = jl.SepConvSE(16, 24, k=33, stride=stride, last=last, mask=True, drop_rate=0.0, dtype=jdt)
    tmod = tl.SepConvSE(16, 24, k=33, stride=stride, last=last, mask=True, drop_rate=0.0, dtype=tdt)
    jx, jp = jnp.asarray(x), jnp.asarray(percents)
    variables = jmod.init(jax.random.PRNGKey(1), jx, jp, False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    tmod.load_state_dict(from_jax(params, stats), strict=True)
    tx, tp = torch.from_numpy(x).transpose(1, 2), torch.from_numpy(percents)

    want = jmod.apply({"params": params, "batch_stats": stats}, jx, jp, False)
    tmod.eval()
    with torch.no_grad():
        got = tmod(tx, tp)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape[-1] == want.shape[1] == -(-40 // stride)
    _assert_close(got.transpose(1, 2).numpy(), np.asarray(want), dtype)

    want, new_stats = jmod.apply({"params": params, "batch_stats": stats}, jx, jp, True,
                                 mutable=["batch_stats"])
    tmod.train()
    with torch.no_grad():
        got = tmod(tx, tp)
    _assert_close(got.transpose(1, 2).numpy(), np.asarray(want), dtype)
    _, got_stats = to_jax(tmod.state_dict())
    for a, b in zip(jax.tree.leaves(jax.device_get(new_stats["batch_stats"])),
                    jax.tree.leaves(got_stats)):
        _assert_close(b, a, dtype)


def _init(encoder, feats, percents):
    """The flax variables of ``encoder``'s model, initialised under jit."""
    model = jax_build_model(NUM_CLASSES, encoder, mask=True)
    return jax.device_get(jax.jit(lambda f, p: model.init(jax.random.PRNGKey(0), f, p, False))(
        jnp.asarray(feats), jnp.asarray(percents)))


@pytest.fixture(scope="module", params=ENCODERS)
def encoder_weights(request):
    """(encoder, flax params with teeth, batch_stats, features, percents)."""
    encoder = request.param
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((B, T, 64)).astype(np.float32)
    percents = (np.array(LENS, np.float32) / np.float32(T)).astype(np.float32)
    variables = _init(encoder, feats, percents)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    return encoder, params, stats, feats, percents


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(encoder_weights, dtype, mask):
    """Each encoder through ``AsrModel`` in eval mode: log-probs within the
    block tolerances at full width, the output lengths equal.  In bf16 the
    SE encoder's blocks give float32 (checked on both sides at the stem)."""
    encoder, params, stats, feats, percents = encoder_weights
    jdt, tdt = _dtypes(dtype)
    jmodel = jax_build_model(NUM_CLASSES, encoder, mask=mask, dtype=jdt)
    capture = lambda mdl, _: mdl.name == "first_cnn"  # noqa: E731
    (want_lp, want_lens), inter = jax.jit(lambda f, p: jmodel.apply(
        {"params": params, "batch_stats": stats}, f, p, False, capture_intermediates=capture,
        mutable=["intermediates"]))(jnp.asarray(feats), jnp.asarray(percents))
    want_lp = np.asarray(want_lp)
    assert class_std(want_lp) >= 0.5, class_std(want_lp)   # the comparison has teeth

    port = build_model(NUM_CLASSES, encoder, mask=mask, dtype=tdt)
    port.load_state_dict(from_jax(params, stats), strict=True)
    port.eval()
    seen = {}
    port.encoder.first_cnn.register_forward_hook(lambda m, a, out: seen.update(dtype=out.dtype))
    with torch.no_grad():
        lp, out_lens = port(torch.from_numpy(feats), torch.from_numpy(percents))
    assert lp.shape == want_lp.shape == (B, T // 2, NUM_CLASSES) and lp.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(want_lens))
    _assert_close(lp.numpy(), want_lp, dtype)
    stem_dtype = inter["intermediates"]["encoder"]["first_cnn"]["__call__"][0].dtype
    if encoder == "quartznet12_context_se" or dtype == "float32":
        assert seen["dtype"] == torch.float32 and stem_dtype == jnp.float32
    else:
        assert seen["dtype"] == torch.bfloat16 and stem_dtype == jnp.bfloat16


def _zero_grad_biases(encoder):
    """Conv biases followed by a train-mode BatchNorm, which subtracts them
    again: their gradient is zero, up to rounding."""
    return {"quartznet15x5": ("encoder.first_cnn", "encoder.last_conv"),
            "quartznet10x5": ("encoder.last_conv",)}.get(encoder, ())


# float32 from the same features, so both steps differ only by the order
# of float32 sums.  These seeded train-mode networks are chaotic: a ReLU
# input within rounding of 0 flips, and the flip reaches every gradient
# before it.  The port alone, its input features moved by 1e-7 relative
# (random), moved its gradients by a median 1.4% (SE; 2.4% on
# block13.sep_last.se.fc1), 0.6% (15x5) and 2.3% (10x5; 3.4% on one tensor)
# on these inputs, the pattern of its gap to JAX, and its loss by up to
# 7.6e-6 relative (10x5).  So each encoder is held to the recipe's bounds
# (RECIPE_TOL: per-tensor gradient 5e-2, parameters 1e-4 after the update,
# grad norm 1e-3, BN statistics 1e-5), the loss to the card-against-CPU
# step's 1e-4 (``chip_smoke.py`` TRAIN_TOL; 1.7e-5 seen on 10x5).
STEP_TOL = {**RECIPE_TOL[0], "loss": 1e-4}


def test_encoder_train_step_matches_jax(encoder_weights):
    """One float32 train step of each encoder (``make_train_step`` from the
    same features, BatchNorm batch statistics, fused NovoGrad behind a
    gradient capture) against JAX's jitted step: loss, gradient norm, each
    tensor's gradient, the updated parameters and BatchNorm statistics, the
    predictions."""
    encoder, params, stats, feats, _ = encoder_weights
    rng = np.random.default_rng(3)
    targets = np.zeros((B, 16), np.int32)
    for b, n in enumerate((12, 8)):
        targets[b, :n] = rng.integers(0, NUM_CLASSES - 1, n)
    batch = dict(waves=feats, wave_lens=np.array(LENS, np.int32), targets=targets,
                 target_lens=np.array([12, 8], np.int32))

    jmodel = jax_build_model(NUM_CLASSES, encoder, mask=True)
    jopt = jax_capture(jax_novograd(jax_schedule(**SCHEDULE), betas=(0.8, 0.5), weight_decay=1e-3,
                                    fused=True))
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=jopt.init(params), nan_count=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, NUM_CLASSES - 1, JaxMelConfig(**FRONTEND),
                                        augment=None, from_features=True))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    model = build_model(NUM_CLASSES, encoder, mask=True)
    model.load_state_dict(from_jax(params, stats), strict=True)
    popt = port_capture(novograd(cosine_annealing_warmup_restarts(**SCHEDULE), betas=(0.8, 0.5),
                                 weight_decay=1e-3, fused=True))
    pstep = make_train_step(model, popt, NUM_CLASSES - 1, MelFrontendConfig(**FRONTEND),
                            augment=None, from_features=True)
    pstate, pm = pstep(create_train_state(model, popt),
                       {k: torch.from_numpy(v) for k, v in batch.items()})

    tol = STEP_TOL
    loss, want_loss = float(pm["loss"]), float(jm["loss"])
    assert np.isfinite(loss) and abs(loss - want_loss) <= tol["loss"] * abs(want_loss), (loss, want_loss)
    gn, want_gn = float(pm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - want_gn) <= tol["grad_norm"] * want_gn, (gn, want_gn)
    got_g = leaves(as_jax_trees(pstate, pstate.opt_state[0]))
    want_g = leaves(jstate.opt_state[0])
    zero = {"".join(f"['{p}']" for p in (m + ".bias").split(".")): m
            for m in _zero_grad_biases(encoder)}
    for key, module in zero.items():
        kernel = key.replace("['bias']", "['kernel']")
        for g in (got_g, want_g):
            assert np.linalg.norm(g[key]) <= 1e-6 * np.linalg.norm(g[kernel]), (module, g[key])
    errs = rel_err({k: v for k, v in got_g.items() if k not in zero},
                   {k: v for k, v in want_g.items() if k not in zero})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], (worst, errs[worst])
    pp, ps = to_jax({**pstate.params, **pstate.batch_stats})
    assert leaves(pp).keys() == leaves(jstate.params).keys()
    p_err = max(np.abs(a - b).max() for a, b in zip(leaves(pp).values(), leaves(jstate.params).values()))
    assert p_err <= tol["params"], p_err
    s_err = rel_err(leaves(ps), leaves(jstate.batch_stats))
    assert max(s_err.values()) <= tol["stats"], max(s_err.values())
    np.testing.assert_array_equal(pm["pred_lens"].numpy(), np.asarray(jm["pred_lens"]))
    assert np.mean(pm["preds"].numpy() == np.asarray(jm["preds"])) >= tol["preds"]
    assert int(pstate.nan_count) == int(jstate.nan_count) == 0


@pytest.mark.parametrize("encoder", MODEL_REGISTRY)
def test_weight_and_optimizer_bridges_round_trip(encoder):
    """Every encoder's flax tree -> the port's state_dict (every key and
    shape, the SE's 2-D Dense kernels as (out, in)) -> the flax tree, and a
    fused NovoGrad state after one update -> the port's layout -> JAX's,
    all bit for bit; the master copy of a fresh state, ported, is the
    ported parameters."""
    variables = _init(encoder, np.zeros((1, 40, 64), np.float32), np.ones((1,), np.float32))
    params, stats = variables["params"], variables["batch_stats"]
    sd = from_jax(params, stats)
    port = build_model(NUM_CLASSES, encoder, mask=True)
    port.load_state_dict(sd, strict=True)
    back_p, back_s = to_jax(sd)
    for want, got in ((params, back_p), (stats, back_s)):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    dense = [k for k in sd if ".se.fc" in k]
    assert len(dense) == (2 * 15 if encoder == "quartznet12_context_se" else 0)
    for k in dense:
        path = k.rsplit(".", 1)[0].split(".")
        node = params
        for part in path:
            node = node[part]
        np.testing.assert_array_equal(sd[k].numpy(), node["kernel"].T)

    opt = jax_novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=True)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    jstate = jax.device_get(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[1])(grads, params))
    template = create_train_state(port, novograd(1e-2, fused=True))
    ported = opt_state_from_jax(jstate, params, stats, template.params)
    back = opt_state_to_jax(ported, template.params, template.batch_stats)
    for k in ("count", "exp_avg", "exp_avg_sq", "max_exp_avg_sq", "p_flat"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstate, k)), err_msg=k)
    # before any update the master copy is the parameters: the ported copy
    # must be the ported parameters, 2-D kernels in the port's (out, in)
    fresh = opt_state_from_jax(jax.device_get(opt.init(params)), params, stats, template.params)
    masters = FlatLayout(template.params).unflatten(fresh.p_flat)
    for k in template.params:
        assert torch.equal(masters[k], sd[k]), k


def test_registry_and_refusals():
    """All four encoders are ported and built; ``feature_in`` (the SSL
    path) builds a mapping 512 -> in_c before the encoder; ``lstm_head``
    builds the BiLSTM head (hidden 128; its parity is in
    ``test_torch_lstm_head.py``) in place of the decoder; an unknown name
    raises ``ValueError``."""
    assert PORTED_ENCODERS == MODEL_REGISTRY == (
        "quartznet12_context", "quartznet12_context_se", "quartznet15x5", "quartznet10x5")
    for encoder in MODEL_REGISTRY:
        assert type(build_model(NUM_CLASSES, encoder).encoder).__name__ in (
            "QuartNet12Context", "QuartNet15x5", "QuartNet105")
    ssl = build_model(NUM_CLASSES, "quartznet15x5", feature_in=512).eval()
    assert tuple(ssl.feature_mapping.weight.shape) == (64, 512)
    with torch.no_grad():
        assert ssl.feature_mapping(torch.ones(2, 7, 512)).shape == (2, 7, 64)
        assert ssl(torch.ones(2, 8, 512), torch.ones(2))[0].shape == (2, 4, NUM_CLASSES)
    head = build_model(NUM_CLASSES, "quartznet12_context", lstm_head=True).eval()
    assert not hasattr(head, "decoder") and head.head_rnn.hidden == 128
    assert tuple(head.head_fc.weight.shape) == (NUM_CLASSES, 256)
    with torch.no_grad():
        lp, lens = head(torch.ones(2, 8, 64), torch.ones(2))
    assert lp.shape == (2, 4, NUM_CLASSES) and lens.tolist() == [4, 4]
    with pytest.raises(ValueError, match="unknown encoder"):
        build_model(NUM_CLASSES, "quartznet5x5")


def test_kernel_routes_and_init():
    """``conv_kernel`` reaches every stride-1 SepConv of the repeat-5
    stacks (the blocks and ``last_cnn``; 26 and 51 a forward) and no SE
    conv, whose JAX counterpart always runs ``nn.Conv``; ``fuse_directions``
    reaches the SE encoder's BiLSTM.  ``reset_parameters`` draws the Dense
    weights in U(±1/sqrt(in)) and the conv biases in U(±1/sqrt(fan_in))."""
    for encoder, n in (("quartznet15x5", 26), ("quartznet10x5", 51)):
        model = build_model(NUM_CLASSES, encoder, conv_kernel="sepconv")
        routed = [m for m in model.modules() if isinstance(m, tl.SepConv) and m.conv_kernel]
        assert len(routed) == n
        assert all(m.conv_kernel == "sepconv" for m in routed)
    assert build_model(NUM_CLASSES, "quartznet10x5", conv_kernel="sepconv").encoder.first_cnn.conv_kernel is None
    se = build_model(NUM_CLASSES, "quartznet12_context_se", conv_kernel="sepconv", fuse_directions=True)
    seps = [m for m in se.modules() if isinstance(m, tl.SepConv)]
    assert len(seps) == 15 and all(isinstance(m, tl.SepConvSE) and m.conv_kernel is None for m in seps)
    assert se.encoder.context_rnn.fuse_directions

    gen = torch.Generator().manual_seed(0)
    reset_parameters(se, gen)
    fc1, fc2 = se.encoder.block6.sep_last.se.fc1.weight, se.encoder.block6.sep_last.se.fc2.weight
    for w, bound in ((fc1, 1 / np.sqrt(512)), (fc2, 1 / np.sqrt(64))):
        assert 0.9 * bound < w.abs().max().item() <= bound
    q15 = build_model(NUM_CLASSES, "quartznet15x5")
    reset_parameters(q15, gen)
    for b, bound in ((q15.encoder.first_cnn.bias, 1 / np.sqrt(64 * 33)),
                     (q15.encoder.last_conv.bias, 1 / np.sqrt(512))):
        assert 0.9 * bound < b.abs().max().item() <= bound


def test_train_cli_steps_quartznet15x5(tmp_path):
    """``python -m lightning_asr_torch.train --device cpu`` with
    ``model.encoder=quartznet15x5``: one step, a test pass, and
    ``AsrTranslator`` loads the ``last`` checkpoint as a 15x5 model."""
    train, dev = tone_corpus(tmp_path, 8, 0, name="train"), tone_corpus(tmp_path, 8, 1, name="dev")
    out = train_main([f"data.train_manifest={train}", f"data.val_manifest={dev}",
                      f"data.test_manifest={dev}", "train.total_epoch=1",
                      "train.train_batch_size=8", "train.dev_batch_size=8",
                      f"log.run.dir={tmp_path / 'run'}", "data.bucket_seconds=[2.0]",
                      "train.warmup_steps=1", "train.limit_train_batches=1",
                      "model.encoder=quartznet15x5", "model.compute_dtype=f32",
                      "--device", "cpu"])
    assert type(out["trainer"].model.encoder).__name__ == "QuartNet15x5"
    assert int(out["state"].step) == 1 and np.isfinite(out["test"]["test_loss"])
    translator = AsrTranslator(tmp_path / "run" / "checkpoints" / "last", device="cpu")
    assert type(translator.model.encoder).__name__ == "QuartNet15x5"
    sd = translator.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in out["state"].params.items())
