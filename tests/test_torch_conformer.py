"""Conformer-CTC (``lightning_asr_torch/models/conformer.py``, the port's own
encoder, with no JAX counterpart) against the benchmark's plain float32
reference (``h100_bench/reference/conformer.py``), on the CPU at a small
size: 2 layers, d_model 64, 4 heads, feed-forward 256, conv kernel 7, 40
mels, 64 subsampling channels, rows under 1 s.

The forward in train mode, the loss and every parameter's gradient; the
relative-position attention against its scores written out by position
i - j; eval-mode outputs of a row's valid frames as the batch's padding
grows; one ``make_train_step`` step of the benchmark's recipe against the
reference's NovoGrad step; the published size's parameter count (on the
meta device); the spans and the attention's backend counter; dropout's
draws; and the refusals (tensor parallelism, the JAX weight bridge, the
conv-kernel routes).  The card's check of a replayed step is in
``test_torch_conformer_cuda.py``.
"""

from __future__ import annotations

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import functional_call

from h100_bench.reference import compare
from h100_bench.reference.conformer import (ConformerNet, make_params, param_groups,
                                            param_shapes, positions, run_steps)
from h100_bench.reference.train import ctc_mean
from lightning_asr_torch.models import quartznet
from lightning_asr_torch.models.conformer import (ATTENTION_COUNTER, NAME, ConformerEncoder,
                                                  RelPositionAttention, rel_shift)
from lightning_asr_torch.training.profiler import COUNTERS, SimpleProfiler, tracing

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "h100_bench" / "configs" / "conformer_ctc_large.json").read_text())
TINY = {"d_model": 64, "layers": 2, "heads": 4, "d_ff": 256, "kernel": 7,
        "subsampling_channels": 64}
N_MELS, CLASSES = 40, 17
# float32 on both sides, the same operations in another order and shape
# (SDPA's math kernel against the spelled-out scores, a conv1d or a GEMM
# against a matmul): log-probs and the loss to round-off of a 2-layer
# stack; each tensor's gradient within 1e-4 of the larger of its largest
# entry and the median tensor's
FORWARD_TOL, LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
# eval mode: a row's valid frames with more padding beside them, the GEMMs
# at another row count
PAD_TOL = 1e-5
# one step of the recipe, as h100_bench/tests/test_bench_reference.py
# holds the QuartzNet's: the loss to 1e-5 relative, each tensor's gradient
# norm within 1% of the larger of its own and the median tensor's, a frame
# token flipped only on a near-tie
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_PRED_TOL = 1e-5, 1e-2, 1e-4


@pytest.fixture
def cfg(monkeypatch):
    """The configuration cut to the small size, and ``build_model``'s
    Conformer at that size."""
    monkeypatch.setitem(quartznet._ENCODERS, NAME, (ConformerEncoder, TINY))
    monkeypatch.setattr(ConformerEncoder, "in_c", N_MELS)
    c = copy.deepcopy(CONFIG)
    c["num_classes"] = CLASSES
    c["encoder"].update(feat_in=N_MELS, d_model=64, n_layers=2, n_heads=4, d_ff=256,
                        conv_kernel_size=7, subsampling_conv_channels=64)
    c["frontend"]["n_mels"] = N_MELS
    return c


def _params(cfg, seed):
    """Seeded weights, the position biases and BatchNorm's running
    statistics drawn too (the recipe's are zeros and ones)."""
    g = torch.Generator().manual_seed(seed)
    p = make_params(cfg, g, "cpu")
    for k in p:
        if k.endswith(("pos_bias_u", "pos_bias_v", "running_mean")):
            p[k] = torch.randn(p[k].shape, generator=g) * 0.3
        elif k.endswith("running_var"):
            p[k] = torch.rand(p[k].shape, generator=g) + 0.5
    return p


def _model(cfg, params):
    model = quartznet.build_model(CLASSES, NAME, mask=True)
    model.load_state_dict(params, strict=True)
    return model


def _feats(seed, rows=3, frames=90):
    return torch.randn((rows, frames, N_MELS), generator=torch.Generator().manual_seed(seed))


def test_forward_loss_and_every_gradient_match_the_reference(cfg):
    params = _params(cfg, 1)
    model = _model(cfg, params).train()
    feats, percents = _feats(2), torch.tensor([1.0, 0.6, 0.35])
    targets = torch.tensor([[3, 4, 5, 6], [1, 2, 0, 0], [7, 0, 0, 0]])
    target_lens = torch.tensor([4, 2, 1])
    names = [k for k, _ in model.named_parameters()]
    leaves = {k: params[k].clone().requires_grad_(True) for k in names}
    stats = {k: v.clone() for k, v in params.items() if k not in leaves}
    got, got_lens = functional_call(model, {**leaves, **stats}, (feats, percents))
    got_loss = ctc_mean(got, got_lens, targets, target_lens, CLASSES - 1)
    got_grads = torch.autograd.grad(got_loss, list(leaves.values()))
    ref_leaves = {k: params[k].clone().requires_grad_(True) for k in names}
    want, want_lens = ConformerNet(cfg).forward({**ref_leaves, **stats}, feats, percents)
    want_loss = ctc_mean(want, want_lens, targets, target_lens, CLASSES - 1)
    want_grads = torch.autograd.grad(want_loss, list(ref_leaves.values()))
    assert got_lens.tolist() == want_lens.tolist() == [23, 13, 8]
    for r, n in enumerate(want_lens.tolist()):
        assert (got[r, :n] - want[r, :n]).abs().max() < FORWARD_TOL
    assert abs(float(got_loss.detach()) / float(want_loss.detach()) - 1) < LOSS_RTOL
    assert len(got_grads) == len(names) == len(param_groups(cfg))
    # linear_k's bias adds a constant to a query's scores, which the softmax
    # takes away, and the depthwise conv's a constant a channel, which
    # train-mode BatchNorm takes away: their gradients are round-off, held
    # to the median tensor's
    median = float(torch.stack([w.abs().max() for w in want_grads]).median())
    for name, g, w in zip(names, got_grads, want_grads):
        assert (g - w).abs().max() <= GRAD_RTOL * max(float(w.abs().max()), median), name


def test_rel_shift_reads_position_i_minus_j():
    t = 5
    x = torch.randn(2, 3, t, 2 * t - 1)                   # column r: position t - 1 - r
    y = rel_shift(x)
    for i in range(t):
        for j in range(t):
            assert torch.equal(y[..., i, j], x[..., i, t - 1 - i + j])


def test_attention_against_scores_indexed_by_i_minus_j():
    torch.manual_seed(3)
    d, h, t = 16, 2, 7
    att = RelPositionAttention(d, h, None).eval()
    for p in att.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(2, t, d)
    keep = torch.arange(t)[None, :] < torch.tensor([[t], [4]])
    got = att(x, positions(t, d, "cpu"), keep)
    dk = d // h
    with torch.no_grad():
        q = att.linear_q(x).view(2, t, h, dk)
        k = att.linear_k(x).view(2, t, h, dk)
        v = att.linear_v(x).view(2, t, h, dk)
        table = {r: att.linear_pos(positions(t, d, "cpu")[t - 1 - r]).view(h, dk)
                 for r in range(-(t - 1), t)}                     # P[r], r = i - j
        score = torch.empty(2, h, t, t)
        for i in range(t):
            for j in range(t):
                score[:, :, i, j] = (((q[:, i] + att.pos_bias_u) * k[:, j]).sum(-1)
                                     + ((q[:, i] + att.pos_bias_v) * table[i - j]).sum(-1))
        score = score / math.sqrt(dk)
        score = score.masked_fill(~keep[:, None, None, :], -1e4)
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(score, -1), v)
        out = out * keep[:, :, None, None]
        want = att.linear_out(out.reshape(2, t, d))
    assert (got - want).abs().max() < 1e-5


def test_eval_outputs_of_valid_frames_do_not_depend_on_padding(cfg):
    model = _model(cfg, _params(cfg, 4)).eval()
    feats = _feats(5, rows=2, frames=48)
    lens = [48, 30]                                        # valid mel frames
    outs = []
    for frames in (48, 80, 120):
        x = torch.zeros(2, frames, N_MELS)
        for r, n in enumerate(lens):
            x[r, :n] = feats[r, :n]
        t_out = (((frames - 1) // 2) // 2) + 1
        valid = [12, 8]                                    # subsampled valid frames
        percents = torch.tensor([(n + 0.5) / t_out for n in valid])
        with torch.no_grad():
            lp, out_lens = model(x, percents)
        assert out_lens.tolist() == valid
        outs.append([lp[r, :n] for r, n in enumerate(valid)])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert (a - b).abs().max() < PAD_TOL


def _batch(seed, rows=2, seconds=0.9, L=8):
    rng = np.random.default_rng(seed)
    S = int(seconds * 16000)
    lens = np.array([S, S * 2 // 3][:rows], np.int32)
    waves = np.zeros((rows, S), np.int16)
    for r, n in enumerate(lens):
        waves[r, :n] = np.clip(rng.standard_normal(n) * 3000, -32768, 32767)
    tl = np.array([L, L // 2][:rows], np.int32)
    targets = rng.integers(0, CLASSES - 1, (rows, L)).astype(np.int32)
    targets[np.arange(L)[None, :] >= tl[:, None]] = 0
    return {"waves": torch.from_numpy(waves), "wave_lens": torch.from_numpy(lens),
            "targets": torch.from_numpy(targets), "target_lens": torch.from_numpy(tl),
            "prev_samples": torch.zeros(rows)}


def test_one_train_step_matches_the_reference_novograd_step(cfg):
    from h100_bench import port

    cfg["build_model"]["compute_dtype"] = "f32"
    cfg["frontend"]["precision"] = "highest"
    params = make_params(cfg, torch.Generator().manual_seed(6), "cpu")
    batch = _batch(7)
    step, state = port.train_step(cfg, params, "cpu")
    names = list(state.params)
    state, met = step(state, batch, torch.Generator().manual_seed(11))
    v = state.opt_state.exp_avg_sq
    prog = {"losses": [float(met["loss"])], "preds": met["preds"],
            "grad_norms": dict(zip(names, np.sqrt(v.numpy()).tolist())),
            "change": {k: float((state.params[k] - params[k]).norm()) for k in names}}
    ref = run_steps(cfg, params, [batch], [torch.Generator().manual_seed(11)])
    gaps = compare.train_gaps(prog, ref, param_groups(cfg))
    assert gaps["loss_gap"] < STEP_LOSS_TOL
    assert gaps["grad_gap"] < STEP_GRAD_TOL
    assert gaps["change_gap"] < STEP_GRAD_TOL
    assert gaps["pred_gap_mean"] < STEP_PRED_TOL
    # the biases whose gradient is round-off: linear_k's (the forward
    # test) and the depthwise conv's, a constant a channel that train-mode
    # BatchNorm takes away
    assert {k.split(".", 3)[3] for k in gaps["left_out"]} <= {"self_attn.linear_k.bias",
                                                              "conv.depthwise_conv.bias"}


def test_spans_and_the_attention_counter(cfg):
    from h100_bench import port

    cfg["build_model"]["compute_dtype"] = "f32"
    step, state = port.train_step(cfg, make_params(cfg, torch.Generator().manual_seed(8), "cpu"),
                                  "cpu")
    before = COUNTERS[ATTENTION_COUNTER]["cpu/math"]
    prof = SimpleProfiler()
    with tracing(prof):
        for i in range(2):
            state, _ = step(state, _batch(9), torch.Generator().manual_seed(i))
    assert COUNTERS[ATTENTION_COUNTER]["cpu/math"] - before == 2
    assert set(COUNTERS[ATTENTION_COUNTER]) == {"cpu/math"}
    for name in ("train_step/forward/subsampling", "train_step/forward/conformer"):
        assert prof.counts[name] == 2 and prof.totals[name] > 0


def test_the_published_size_counts_the_configurations_params():
    with torch.device("meta"):
        model = quartznet.build_model(129, NAME, mask=True, dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == CONFIG["params"] == 121_501_313
    enc = model.encoder
    assert (enc.out_ch, len(enc.layers), enc.layers[0].self_attn.h) == (512, 18, 8)
    assert tuple(enc.pre_encode.out.weight.shape) == (512, 512 * 20)
    assert tuple(enc.layers[0].conv.depthwise_conv.weight.shape) == (512, 1, 31)
    assert tuple(model.decoder.weight.shape) == (129, 512, 1)
    assert {k for k, _ in model.named_parameters()} == set(param_groups(CONFIG))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == param_shapes(CONFIG)


def test_dropout_draws_from_the_step_generator(monkeypatch):
    monkeypatch.setitem(quartznet._ENCODERS, NAME, (ConformerEncoder, TINY))
    model = quartznet.build_model(CLASSES, NAME, in_c=N_MELS, mask=True, drop_rate=0.3)
    quartznet.reset_parameters(model, torch.Generator().manual_seed(0))
    feats, percents = _feats(10, rows=2, frames=40), torch.ones(2)
    with torch.no_grad():
        a = model(feats, percents, torch.Generator().manual_seed(1))[0]
        b = model(feats, percents, torch.Generator().manual_seed(1))[0]
        c = model(feats, percents, torch.Generator().manual_seed(2))[0]
        with pytest.raises(ValueError, match="torch.Generator"):
            model(feats, percents)
        e = model.eval()(feats, percents)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, e)


def test_refusals_and_the_registry(monkeypatch):
    from lightning_asr_torch import train
    from lightning_asr_torch.parallel import distributed, tp
    from lightning_asr_torch.utils.jax_params import from_jax, to_jax

    assert quartznet.ENCODERS == quartznet.MODEL_REGISTRY + (NAME,)
    assert NAME not in quartznet.MODEL_REGISTRY
    monkeypatch.setitem(quartznet._ENCODERS, NAME, (ConformerEncoder, TINY))
    model = quartznet.build_model(CLASSES, NAME, in_c=N_MELS, mask=True)
    assert type(model.encoder) is ConformerEncoder and model.encoder.in_c == 80
    monkeypatch.setattr(distributed, "model_size", lambda: 2)
    with pytest.raises(ValueError, match=f"train.tp=2: the {NAME} encoder"):
        tp.model_shard(model)
    with pytest.raises(ValueError, match=NAME):
        to_jax(model.state_dict())
    with pytest.raises(ValueError, match=NAME):
        from_jax({"encoder": {"layers": {"0": {"norm_out": {"scale": np.ones(2)}}}}}, {})
    with pytest.raises(ValueError, match="conv_kernel"):
        quartznet.build_model(CLASSES, NAME, conv_kernel="sepconv")
    fe = train.frontend_config({"n_mels": 80, "win_length": 400})
    assert (fe.n_mels, fe.win_length, fe.precision) == (80, 400, "default")
    assert train.frontend_config({}) == type(fe)(precision="default")
