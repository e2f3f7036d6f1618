"""The plain reference against the port's CPU path at a tiny size (both
in float32): the frontend, the forward in train mode and one train step
of the default recipe; and no module of the benchmark
imports JAX, flax, optax or the JAX package, nor the reference the port."""

from __future__ import annotations

import ast
import copy

import numpy as np
import pytest
import torch

from conftest import ROOT, cell_parts

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lightning_asr_tpu"}
# float32 on both sides, the same operations in another order (the port's
# DFT as chunked matmuls, the reference's rfft): a bin 50 dB under its
# frame's peak loses digits to the sums' cancellation (0.0009 dB seen);
# 0.01 dB is 0.23% of a bin's power
FRONTEND_TOL_DB = 1e-2
# log-probs after 16 float32 conv layers and BatchNorms in another order
FORWARD_TOL = 1e-3
# one float32 train step: the loss to 1e-5 relative; each tensor's gradient
# norm within 1% of the larger of its own and the median tensor's (train-mode
# BatchNorm stacks move the small leaves' gradients most)
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-2
# the frame tokens: a token may flip only on a near-tie, by under 1e-4 nats
STEP_PRED_TOL = 1e-4


def _f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["build_model"]["compute_dtype"] = "f32"
    cfg["frontend"]["precision"] = "highest"
    return cfg


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_and_a_plain_reference():
    for path in (ROOT / "h100_bench").rglob("*.py"):
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if "reference" in path.relative_to(ROOT / "h100_bench").parts:
            assert "lightning_asr_torch" not in names, path


def test_frontend_matches_the_port():
    from h100_bench.reference import frontend as rf
    from lightning_asr_torch.ops.frontend import (MelFrontendConfig, log_mel_spectrogram,
                                                  normalize_features)

    cfg = _f32(cell_parts("qn12ctx.train.libri")[0])
    g = torch.Generator().manual_seed(0)
    waves = (torch.randn((3, 8000), generator=g) * 3000).to(torch.int16)
    lens = torch.tensor([8000, 5001, 1200])
    got, frames = log_mel_spectrogram(waves, lens, MelFrontendConfig(**cfg["frontend"]))
    want, want_frames = rf.log_mel(waves, lens, cfg["frontend"])
    assert torch.equal(frames.long(), want_frames)
    for r, n in enumerate(frames.tolist()):
        assert (got[r, :n] - want[r, :n]).abs().max() < FRONTEND_TOL_DB
    norm = normalize_features(got, frames)
    assert (norm - rf.normalize(got, want_frames)).abs().max() < 1e-5


def test_train_forward_matches_the_port():
    from h100_bench import port
    from h100_bench.reference.model import Net, make_params

    cfg = _f32(cell_parts("qn12ctx.train.libri")[0])
    params = make_params(cfg, torch.Generator().manual_seed(1), "cpu")
    model = port.model_of(cfg, params, "cpu").train()
    feats = torch.randn((2, 120, 64), generator=torch.Generator().manual_seed(2))
    percents = torch.tensor([1.0, 0.7])
    with torch.no_grad():
        got, got_lens = model(feats, percents)
        want, want_lens = Net(cfg).forward(params, feats, percents)
    assert torch.equal(got_lens.long(), want_lens)
    for r, n in enumerate(want_lens.tolist()):
        assert (got[r, :n] - want[r, :n]).abs().max() < FORWARD_TOL


def test_train_step_matches_the_port():
    from h100_bench import generator, port
    from h100_bench.reference import compare
    from h100_bench.reference.model import make_params, param_groups
    from h100_bench.reference.train import run_steps

    cfg, mix = cell_parts("qn12ctx.train.libri")
    cfg = _f32(cfg)
    mix = {**mix, "rows": 2, "buckets": [[1.2, 1.0]], "cycle_batches": 1}
    params = make_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = generator.train_cycle(mix, 5)[0]
    batch = {"waves": torch.from_numpy(b.waves), "wave_lens": torch.from_numpy(b.wave_lens),
             "targets": torch.from_numpy(b.targets), "target_lens": torch.from_numpy(b.target_lens),
             "prev_samples": torch.zeros(2)}
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
    assert gaps["pred_gap_mean"] < STEP_PRED_TOL
