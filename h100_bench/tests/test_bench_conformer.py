"""The cell ``conformer_l.train.libri`` on the CPU, at a tiny size of its mix
and the configuration's full widths: its driver end to end through the
harness's CPU entry (a sound run, the program in float32, is correct; a
state left unchanged and half the batch are not), the limits file, the
control and the faults against its limits, the per-layer readers on a
hand-built trace, the counts against hand counts and the port's frame
lengths, and the mix's labels."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import cell_parts, run_tiny, tiny

CELL = "conformer_l.train.libri"
SEED = 2 ** 31 + 303


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


def test_sound_run_correct(tmp_path):
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is True and not _failed(res), res["checks"]
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert {c["name"] for c in res["checks"]} >= {f"{gap}.{g}" for gap in (
        "grad_gap", "change_gap") for g in ("subsampling", "attention", "ffn", "conv", "head")}
    assert set(res["metrics"]) == {"train_audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_faults_turn_correct_false(fault, broken_step, tmp_path):
    if fault == "state_unchanged":
        broken_step(lambda step: lambda state, batch, gen=None: (state,
                                                                 step(state, batch, gen)[1]))
    else:
        def half(step):
            def run(state, batch, gen=None):
                n = batch["waves"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()}, gen)
            return run
        broken_step(half)
    res = run_tiny(CELL, SEED, tmp_path, f32=True)
    assert res["correct"] is False, res["checks"]


def test_limits_load_and_the_control_and_faults_fail_one():
    from h100_bench import controls_conformer
    from h100_bench.reference import compare
    from h100_bench.reference.model import no_tf32

    limits = compare.limits_for(CELL)
    assert {"loss_gap", "pred_gap_mean", "grad_gap_median", "change_gap_median",
            "grad_gap.attention", "change_gap.attention"} <= set(limits)
    cfg, mix = tiny(CELL)
    no_tf32()
    readings = controls_conformer.train_control(cfg, mix, SEED, torch.device("cpu"))
    assert set(readings) == {"fp8", "half_batch", "state_unchanged"}
    for reading, numbers in readings.items():
        judged = compare.judged(numbers, limits)
        assert not all(c["ok"] for c in judged), reading


def test_readers_on_a_hand_built_trace():
    from h100_bench import run

    kernels = {"fmha_cutlassF_bf16_aligned_64x64_rf_sm80": 2.0,
               "fmha_cutlassB_bf16_aligned_64x64_k64_sm80": 4.0,
               "sm90_xmma_gemm_bf16bf16_bf16f32": 10.0,
               "cutlass_80_tensorop_bf16_s16816gemm": 6.0,
               "cudnn::detail::implicit_convolve_sgemm": 8.0,
               "conv_depthwise2d_grad_weight_kernel": 1.0,
               "vectorized_elementwise_kernel": 3.0, "reduce_kernel": 1.0,
               "vectorized_layer_norm_kernel": 0.5, "cunn_SoftMaxForward": 0.5,
               "log_mel_kernel": 0.2, "ctc_alpha_kernel": 0.1, "ctc_beta_kernel": 0.2,
               "extend_kernel": 0.1, "Memcpy HtoD": 0.4}
    from h100_bench.trace import category
    groups = {}
    for k, ms in kernels.items():
        groups[category(k)] = groups.get(category(k), 0.0) + ms
    rec = {"trace": {"kernels": kernels, "groups": groups, "steps": 2, "window_s": 0.05,
                     "flops": 9.89e12, "hand_bound_ms": 0.3}}

    def read(name):
        return run.load_module(run.BENCH / "metrics" / f"{name}.py").read(rec)

    assert read("attention_ms_per_step.conformer") == pytest.approx(3.0)
    assert read("gemm_ms_per_step.conformer") == pytest.approx(8.0)
    assert read("conv_ms_per_step.conformer") == pytest.approx(4.5)
    assert read("elementwise_ms_per_step.conformer") == pytest.approx(2.5)
    assert read("hand_kernels_roofline.conformer") == pytest.approx(50.0)
    assert read("mfu.conformer") == pytest.approx(20.0)


def test_counts_by_hand_and_the_ports_frames():
    from h100_bench import counts_conformer
    from lightning_asr_torch.models.layers import _lengths_from_percents

    cfg = {"encoder": {"feat_in": 8, "d_model": 4, "n_layers": 2, "d_ff": 16,
                       "conv_kernel_size": 3, "subsampling_conv_channels": 2},
           "num_classes": 5}
    sub = 2 * 4 * 2 * 18 + 2 * 2 * 2 * 18 + 2 * 4 * 4      # conv0, conv1 (F'' 2), Linear
    layer = 4 * 2 * 4 * 16 + 4 * 2 * 16 + 2 * 4 * 8 + 2 * 4 * 3 + 2 * 16
    assert counts_conformer.frame_flops(cfg) == sub + 2 * layer + 2 * 4 * 5
    n = np.array([3, 5])
    att = np.sum(4 * n * n * 4 + 2 * n * (2 * n - 1) * 4)
    want = counts_conformer.frame_flops(cfg) * 8 + 2 * (att + 2 * 16 * 9)
    assert counts_conformer.model_flops(cfg, [3, 5], False) == pytest.approx(want)
    fe = {"pad": 32, "hop_length": 160}
    samples, S = [16000, 40000, 3999], 48000
    T, out = counts_conformer.output_frames(samples, S, fe)
    mel = 1 + (np.asarray(samples) + 64) // 160
    percents = torch.from_numpy(mel.astype(np.float32)) / torch.full((), T, dtype=torch.float32)
    t_out = counts_conformer.subsampled(T)
    assert t_out == -(-(-(-T // 2)) // 2)
    assert out.tolist() == _lengths_from_percents(t_out, percents).tolist()


def test_the_mix_labels_bpe_pieces():
    from h100_bench import generator

    cfg, mix = cell_parts(CELL)
    assert mix["num_labels"] == 128 == cfg["num_classes"] - 1 and mix["chars_per_second"] == 5.4
    cyc = generator.train_cycle(mix, 5)
    assert len(cyc) == 40 and sorted({b.bucket for b in cyc}) == [e for e, _ in mix["buckets"]]
    for b in cyc:
        assert (b.targets < 128).all() and b.targets.shape[1] % 32 == 0
        assert (b.target_lens == np.maximum(1, np.round(b.wave_lens / 16000 * 5.4))).all()
