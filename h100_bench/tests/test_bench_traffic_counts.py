"""The traffic generator (deterministic by seed, the same work for every
seed, the mix's shares) and the frozen operation and byte
counts against hand counts at a tiny shape."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import cell_parts

SWEEP = [(2.0, 0.01), (4.0, 0.03), (6.0, 0.05), (8.0, 0.07), (10.0, 0.09), (12.0, 0.12),
         (14.0, 0.18), (16.7, 0.45)]          # bench.py at 504420a


@pytest.fixture(scope="module")
def train_mix():
    return cell_parts("qn12ctx.train.libri")[1]


def test_train_cycle_deterministic_and_same_work(train_mix):
    from h100_bench import generator

    a, b = generator.train_cycle(train_mix, 7), generator.train_cycle(train_mix, 7)
    assert all(np.array_equal(x.waves, y.waves) and np.array_equal(x.targets, y.targets)
               for x, y in zip(a, b))
    c = generator.train_cycle(train_mix, 2 ** 31 + 9)
    assert not all(np.array_equal(x.waves, y.waves) for x, y in zip(a, c))
    lens = lambda cyc: sorted(int(n) for bt in cyc for n in bt.wave_lens)  # noqa: E731
    assert lens(a) == lens(c)                      # every seed: the same durations
    assert sorted(bt.bucket for bt in a) == sorted(bt.bucket for bt in c)


def test_train_shares_match_sweep(train_mix):
    from h100_bench import generator

    assert [tuple(b) for b in train_mix["buckets"]] == SWEEP
    assert train_mix["chars_per_second"] == pytest.approx(224 / 16.7)
    cyc = generator.train_cycle(train_mix, 3)
    total = sum(b.audio_s for b in cyc)
    for edge, share in SWEEP:
        got = sum(b.audio_s for b in cyc if b.bucket == edge) / total
        assert got == pytest.approx(share, abs=0.02), edge
    for b in cyc:
        assert b.waves.shape == (train_mix["rows"], int(b.bucket * 16000))
        assert (b.wave_lens <= b.waves.shape[1]).all()
        assert (b.target_lens >= 1).all() and b.targets.shape[1] % 32 == 0
        assert (b.targets < train_mix["num_labels"]).all()


def test_counts_by_hand():
    from h100_bench import counts

    fe = {"n_fft": 512, "win_length": 320, "hop_length": 160, "n_mels": 64, "pad": 32}
    assert counts.window_nonzero(fe) == 320            # [96, 416)
    B, T = 2, 3
    nbytes = B * ((T - 1) * 160 + 512) * 4 + (2 * 257 * 320 + 257 * 64) * 2 + B * T * 64 * 4
    flops = B * T * (4 * 257 * 320 + 3 * 257 + 2 * 257 * 64)
    assert counts.k1(B, T, fe) == pytest.approx(
        1e3 * max(nbytes / 3.35e12, flops / 989e12))
    assert counts.k6(2, 100, 676) == pytest.approx(1e3 * (2 * 100 * 4 + 8 + 2 * 676 * 4) / 3.35e12)
    # the extension, or the (T + ceil(n_fft / hop)) hops the frames read: T = 101
    assert counts.k6_out_len(16000, fe) == max(16000 + 64 + 512, (101 + 4) * 160)
    # K2: 5 valid steps at H=2, one direction, one row of 4 frames
    G = 8
    want = 1e3 * max((5 * G * 4 + G * 2 * 4 + 4 + 4 * 2 * 4 + 5 * 2 * 4) / 3.35e12,
                     5 * (2 * G * 2 + 2 * G + 5 * 2) / 67e12)
    assert counts.k2(5, 1, 4, 2, 1) == pytest.approx(want)


def test_model_flops_by_hand():
    from h100_bench import counts

    cfg = {"stem": {"in": 4, "out": 8, "k": 3, "stride": 2},
           "blocks": [{"name": "b", "repeat": 2, "in": 8, "out": 6, "k": 5}],
           "context": {"in": 8, "hidden": 2}, "last_cnn": None,
           "last_conv": {"in": 6, "out": 10}, "decoder": {"in": 10, "out": 3}}
    per_frame = (2 * 1 * 3 * 4 + 2 * 4 * 8          # stem: depthwise + pointwise
                 + 2 * 5 * 8 + 2 * 8 * 8             # sep0
                 + 2 * 5 * 8 + 2 * 8 * 6             # sep_last
                 + 2 * 8 * 6                         # residual 1x1
                 + 2 * 6 * 10 + 2 * 10 * 3           # epilog and decoder
                 + 2 * 2 * 4 * 2 * (8 + 2))          # BiLSTM, two directions
    assert counts.flops_per_frame(cfg) == per_frame
    assert counts.model_flops(cfg, [3, 4], True) == 3 * 7 * per_frame


def test_output_frames_match_the_port():
    import torch

    from h100_bench import counts
    from lightning_asr_torch.models.layers import _lengths_from_percents
    from lightning_asr_torch.ops.frontend import MelFrontendConfig, mel_num_frames

    fe = {"pad": 32, "hop_length": 160}
    samples, S = [16000, 40000, 3999], 48000
    T, out = counts.output_frames(samples, S, fe)
    cfg = MelFrontendConfig()
    mel = mel_num_frames(torch.tensor(samples), cfg)
    assert T == int(mel_num_frames(S, cfg))
    percents = mel.to(torch.float32) / torch.full((), T, dtype=torch.float32)
    assert out.tolist() == _lengths_from_percents((T + 1) // 2, percents).tolist()
