"""Edge cases of the port's CUDA kernels against their plain versions, on
the card.  The kernels have no CPU mode, so every test here skips without
a GPU.  On a machine with one (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.ops.frontend_kernels import mel_from_extended, mel_from_extended_plain
from lightning_asr_torch.ops.lstm_kernels import lstm_recurrence, lstm_recurrence_plain

pytestmark = pytest.mark.cuda

# one bf16 rounding flip of one power term, twice (see chip_smoke.py)
K1_TOL_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,T,extra", [(1, 1, 0), (3, 31, 700), (2, 32, -500), (2, 33, 0),
                                       (1, 100, 10_000)])
def test_k1_tiles_and_ragged_signal(dev, B, T, extra):
    """Tile edges (32 frames a block), one frame, and a signal shorter or
    longer than the frames need (samples past its end count as zero)."""
    cfg = MelFrontendConfig(precision="default")
    n = (T - 1) * cfg.hop_length + cfg.n_fft + extra
    g = torch.Generator().manual_seed(T)
    q = (torch.randn((B, n), generator=g) * 0.1).to(dev)
    before = mel_from_extended.launches
    got = mel_from_extended(q, cfg, T)
    assert mel_from_extended.launches == before + 1
    want = mel_from_extended_plain(q, cfg, T)
    assert got.shape == (B, T, cfg.n_mels)
    assert (got - want).abs().max().item() <= K1_TOL_DB


def test_k1_silence_is_amin(dev):
    cfg = MelFrontendConfig(precision="default")
    out = mel_from_extended(torch.zeros((2, 6000), device=dev), cfg, 20)
    assert torch.all(out == np.float32(10 * np.log10(cfg.amin))).item()


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,lengths", [(1, [1, 0]), (37, [37, 0, 1, 20])])
def test_k2_lengths(dev, D, T, lengths):
    H = 40
    g = torch.Generator().manual_seed(T + D)
    B = len(lengths)
    xproj = torch.randn((B, T, D, 4 * H), generator=g).to(dev)
    w_hh = (torch.rand((D, 4 * H, H), generator=g) * 2 - 1).div(H ** 0.5).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = lstm_recurrence.launches
    got = lstm_recurrence(xproj, lens, w_hh)
    assert lstm_recurrence.launches == before + 1
    want = lstm_recurrence_plain(xproj, lens, w_hh)
    # float32; dot sums in another order, the card's expf/tanhf
    assert (got - want).abs().max().item() <= 1e-5
    for b, n in enumerate(lengths):
        assert bool((got[b, n:] == 0).all())


def test_k2_rejects_what_it_cannot_run(dev):
    xproj = torch.zeros((2, 5, 2, 32), device=dev)
    lens = torch.tensor([5, 2], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):        # no kernel instantiated for H=8
        lstm_recurrence(xproj, lens, torch.zeros((2, 32, 8), device=dev))
    with pytest.raises(ValueError):        # lengths on another device
        lstm_recurrence(torch.zeros((2, 5, 2, 160), device=dev), lens.cpu(),
                        torch.zeros((2, 160, 40), device=dev))
