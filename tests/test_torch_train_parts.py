"""Parity of the training step's parts: train-mode BatchNorm inside a narrow
SepConv and QuartNetBlock, NovoGrad (fused and per-tensor), the cosine
warmup-restart schedule, gradient clipping and the SpecAugment / cutout
masks, each of the port (``lightning_asr_torch``) against the JAX package on
the same numpy inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightning_asr_tpu.models import layers as jl
from lightning_asr_tpu.ops import augment as jaug
from lightning_asr_tpu.optim import cosine_annealing_warmup_restarts as jax_schedule
from lightning_asr_tpu.optim import novograd as jax_novograd
from lightning_asr_torch.models import layers as tl
from lightning_asr_torch.ops import augment as taug
from lightning_asr_torch.optim import (apply_updates, clip_by_global_norm, clip_by_value,
                                       cosine_annealing_warmup_restarts, novograd,
                                       with_gradient_clipping)
from lightning_asr_torch.utils.jax_params import from_jax, to_jax
from test_torch_model import with_teeth


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,stride", [("sepconv", 1), ("sepconv", 2), ("block", 1)])
def test_train_mode_blocks_match_flax(kind, stride, dtype):
    """Outputs, new batch_stats and parameter gradients in train mode."""
    rng = np.random.default_rng(10 + stride)
    B, T, C = 2, 40, 16
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    if kind == "sepconv":
        jmod = jl.SepConv(C, 24, k=33, stride=stride, mask=True, drop_rate=0.0, dtype=jdt)
        tmod = tl.SepConv(C, 24, k=33, stride=stride, mask=True, drop_rate=0.0, dtype=tdt)
    else:
        jmod = jl.QuartNetBlock(repeat=2, in_ch=C, out_ch=24, k=33, mask=True, dtype=jdt)
        tmod = tl.QuartNetBlock(repeat=2, in_ch=C, out_ch=24, k=33, mask=True, dtype=tdt)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    percents = np.array([1.0, 27 / 40], np.float32)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(percents), False)
    params, stats = with_teeth(variables["params"], variables["batch_stats"], rng)
    T_out = -(-T // stride)
    upstream = rng.standard_normal((B, T_out, 24)).astype(np.float32)

    def f(p):
        out, mutated = jmod.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                  jnp.asarray(percents), True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * upstream), (out, mutated["batch_stats"])

    (_, (want, want_stats)), want_grads = jax.value_and_grad(f, has_aux=True)(params)
    tmod.load_state_dict(from_jax(params, stats), strict=True)
    tmod.train()
    got = tmod(torch.from_numpy(x).transpose(1, 2), torch.from_numpy(percents))
    (got.float() * torch.from_numpy(upstream).transpose(1, 2)).sum().backward()
    got = got.detach().float().transpose(1, 2).numpy()
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    got_grads, got_stats = to_jax({**grads, **dict(tmod.named_buffers())})
    assert got.shape == (B, T_out, 24)

    if dtype == "float32":
        # float32 convs and batch statistics summed in another order
        out_tol, stat_tol, grad_tol = 1e-5, 1e-6, 1e-4
    else:
        # bf16 convs and BN outputs rounded at different points (2^-8)
        out_tol, stat_tol, grad_tol = 4e-2, 1e-2, 5e-2
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=out_tol, atol=out_tol)
    for a, b in zip(jax.tree.leaves(got_stats), jax.tree.leaves(want_stats)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=stat_tol, atol=stat_tol)
    # the running statistics moved: the train path updated them
    assert not np.allclose(jax.tree.leaves(got_stats)[0], jax.tree.leaves(stats)[0])
    for a, b in zip(jax.tree.leaves(got_grads), jax.tree.leaves(want_grads)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= grad_tol * np.linalg.norm(b), (np.linalg.norm(a - b), np.linalg.norm(b))


def test_dropout_keeps_the_expected_share():
    """Dropout draws from the generator: jax.random cannot give the same
    bits, so the port is checked by its law (keep 1 - rate, scale 1/keep)."""
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = tl.dropout(x, 0.2, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 5e-3
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert tl.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        tl.dropout(x, 0.2, None)


def _tree(rng):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2), "d": (2100,)}
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("opts", [dict(weight_decay=1e-3), dict(weight_decay=1e-3, amsgrad=True),
                                  dict(weight_decay=1e-3, luc=True),
                                  dict(weight_decay=0.0, grad_averaging=True)])
def test_novograd_three_steps_match_jax(fused, opts):
    """Three steps on a small tree (one tensor spans two 2048-chunks), the
    recipe's betas on a warmup schedule: the first step initializes the
    second moment to the squared norm (v == 0) at min_lr, the next blend."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    sched = dict(first_cycle_steps=20, cycle_mult=2, max_lr=1e-2, min_lr=1e-4, warmup_steps=2,
                 gamma=0.5)
    jopt = jax_novograd(jax_schedule(**sched), betas=(0.8, 0.5), fused=fused, **opts)
    topt = novograd(cosine_annealing_warmup_restarts(**sched), betas=(0.8, 0.5), fused=fused,
                    **opts)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step, scale in enumerate((1.0, 3.0, 0.2)):
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(g) for k, g in grads.items()}, ts, tp)
        tp = apply_updates(tp, tu)
        # float32 elementwise math in the same order; only the norms' sums
        # differ in order
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")
        want_v = js.exp_avg_sq if fused else jnp.stack([js.exp_avg_sq[k] for k in sorted(params)])
        got_v = ts.exp_avg_sq if fused else torch.stack([ts.exp_avg_sq[k] for k in sorted(params)])
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5)
        assert int(ts.count) == int(js.count) == step + 1
    if fused:
        np.testing.assert_allclose(ts.p_flat.numpy(), np.asarray(js.p_flat), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.exp_avg.numpy(), np.asarray(js.exp_avg), rtol=1e-5, atol=1e-6)


def test_fused_and_per_tensor_novograd_agree():
    rng = np.random.default_rng(4)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    results = []
    for fused in (True, False):
        opt = novograd(1e-2, betas=(0.8, 0.5), weight_decay=1e-3, fused=fused)
        state, p = opt.init(params), dict(params)
        g_rng = np.random.default_rng(5)
        for _ in range(3):
            grads = {k: torch.from_numpy(g_rng.standard_normal(v.shape).astype(np.float32))
                     for k, v in params.items()}
            u, state = opt.update(grads, state, p)
            p = apply_updates(p, u)
        results.append(p)
    for k in params:   # up to the order of the norms' sums
        np.testing.assert_allclose(results[0][k].numpy(), results[1][k].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cycle_mult", [1.0, 2])
def test_schedule_matches_jax(cycle_mult):
    args = dict(first_cycle_steps=50, cycle_mult=cycle_mult, max_lr=1e-2, min_lr=1e-4,
                warmup_steps=10, gamma=0.5)
    jsched, tsched = jax_schedule(**args), cosine_annealing_warmup_restarts(**args)
    # 0, warmup-1, warmup, the first cycle's end, the next cycle's start and
    # its warmup's end, deep into the third cycle
    steps = [0, 9, 10, 30, 49, 50, 59, 60, 95, 140, 149, 150, 175]
    got = np.array([float(tsched(torch.tensor(s, dtype=torch.int32))) for s in steps])
    want = np.array([float(jsched(jnp.int32(s))) for s in steps])
    # float32 cos in another library; near a cycle's end 1 + cos cancels, so
    # the bound there is absolute, 1e-7 of max_lr (3e-10 seen)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert got[0] == np.float32(1e-4)                      # the first step uses min_lr
    assert abs(got[2] - 1e-2) < 1e-9                        # the peak after warmup


def test_clipping_matches_optax():
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    norm = float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in tree.values())))
    for max_norm in (norm / 3, norm * 3):                  # rescaled, and passed through
        want, _ = optax.clip_by_global_norm(max_norm).update(jt, None)
        got = clip_by_global_norm(tt, max_norm)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    want, _ = optax.clip(0.5).update(jt, None)
    got = clip_by_value(tt, 0.5)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # NaN stays non-finite, so the NaN guard still skips the step
    bad = dict(tt, b=torch.full((5,), float("nan")))
    assert not torch.isfinite(clip_by_global_norm(bad, 1.0)["a"]).any()
    assert torch.isnan(clip_by_value(bad, 1.0)["b"]).all()
    # the wrapper clips before the optimizer
    opt = with_gradient_clipping(novograd(1e-2, fused=False), 0.5, "value")
    state = opt.init(tt)
    u_clip, _ = opt.update(tt, state, tt)
    u_ref, _ = novograd(1e-2, fused=False).update(clip_by_value(tt, 0.5), state, tt)
    for k in tree:
        assert torch.equal(u_clip[k], u_ref[k])
    assert with_gradient_clipping(opt, 0.0) is opt
    with pytest.raises(ValueError):
        with_gradient_clipping(opt, 1.0, "max")


@pytest.mark.parametrize("freq_mask,time_mask", [(27, 0.07), (0.3, 12)])
def test_spec_augment_masks_bit_for_bit(freq_mask, time_mask):
    """The JAX uniforms, in its key order, handed to the port."""
    rng = np.random.default_rng(7)
    B, T, F = 4, 120, 64
    feats = rng.standard_normal((B, T, F)).astype(np.float32) + 5.0
    lens = np.array([120, 77, 31, 1], np.int32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jaug.spec_augment(jnp.asarray(feats), jnp.asarray(lens), key, freq_mask, time_mask))
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in jax.random.split(key, 4)])
    got = taug.spec_augment(torch.from_numpy(feats), torch.from_numpy(lens), None, freq_mask,
                            time_mask, uniforms=torch.from_numpy(uniforms)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.any(got == 0) and np.any(got != 0)
    # drawn from a generator instead: the same law, one band each way
    g = torch.Generator().manual_seed(0)
    out = taug.spec_augment(torch.ones((B, T, F)), torch.from_numpy(lens), g, freq_mask, time_mask)
    assert out.shape == (B, T, F) and set(out.unique().tolist()) <= {0.0, 1.0}


def test_cutout_masks_bit_for_bit():
    rng = np.random.default_rng(8)
    B, T, F = 3, 300, 64
    feats = rng.standard_normal((B, T, F)).astype(np.float32) + 5.0
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaug.cutout(jnp.asarray(feats), key, rect_masks=5, rect_freq=50, rect_time=120))
    uniforms = np.stack([
        np.stack([np.asarray(jax.random.uniform(k, (B,)))
                  for k in jax.random.split(jax.random.fold_in(key, i), 4)])
        for i in range(5)])
    got = taug.cutout(torch.from_numpy(feats), None, rect_masks=5, rect_freq=50, rect_time=120,
                      uniforms=torch.from_numpy(uniforms)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.any(got == 0)
