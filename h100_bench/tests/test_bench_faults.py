"""Each fault the training cell can have, planted in the timed path
underneath a run (on the CPU, at a tiny size of the cell's mix, the look
for a card skipped), turns ``correct`` false by the number named, where
the same run without the fault is correct (the program in float32 there,
so that a sound run reads round-off alone); and the control, the float8
reference in the program's place, fails one of the cell's limits."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny, tiny

CELL = "qn12ctx.train.libri"
SEED = 2 ** 31 + 101


def _failed(res: dict) -> set:
    return {c["name"] for c in res["checks"] if c["value"] > c["limit"]}


@pytest.fixture
def broken_step(monkeypatch):
    """Plant ``fault(step) -> step`` in the port's train step."""
    from h100_bench import port

    real = port.train_step

    def plant(fault):
        def train_step(*args, **kwargs):
            step, state = real(*args, **kwargs)
            return fault(step), state
        monkeypatch.setattr(port, "train_step", train_step)
    return plant


def test_train_sound_run_correct(tmp_path):
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is True and not _failed(res)


def test_train_state_unchanged(broken_step, tmp_path):
    broken_step(lambda step: lambda state, batch, gen=None: (state, step(state, batch, gen)[1]))
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is False
    assert {"change_gap.stem", "change_gap.trunk", "change_gap.context"} <= _failed(res)


def test_train_half_the_batch(broken_step, tmp_path):
    def half(step):
        def run(state, batch, gen=None):
            n = batch["waves"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, gen)
        return run
    broken_step(half)
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is False and "loss_gap" in _failed(res)


def _drop_weight_gradient(d_xproj, dw_hh):
    return d_xproj, torch.zeros_like(dw_hh)


def _drop_input_gradient(d_xproj, dw_hh):
    return torch.zeros_like(d_xproj), dw_hh


@pytest.mark.parametrize("fault", [_drop_weight_gradient, _drop_input_gradient])
def test_train_bilstm_backward_broken(fault, monkeypatch, tmp_path):
    """K3, the BiLSTM's backward, loses its weight gradient (dW_hh) or its
    input gradient (d_xproj, which also feeds W_ih, the biases and the
    trunk under the branch)."""
    from lightning_asr_torch.ops import lstm_kernels

    real = lstm_kernels.lstm_backward
    monkeypatch.setattr(lstm_kernels, "lstm_backward", lambda *a: fault(*real(*a)))
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is False and "change_gap.context" in _failed(res)


def test_control_fails_a_limit():
    from h100_bench import controls
    from h100_bench.reference import compare
    from h100_bench.reference.model import no_tf32

    cfg, mix = tiny(CELL)
    no_tf32()
    for reading, numbers in controls.train_control(cfg, mix, SEED, torch.device("cpu")).items():
        judged = compare.judged(numbers, compare.limits_for(CELL))
        assert not all(c["ok"] for c in judged), reading
