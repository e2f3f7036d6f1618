"""Edge cases of the port's CUDA kernels against their plain versions, on
the card.  The kernels have no CPU mode, so every test here skips without
a GPU.  On a machine with one (JAX need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lightning_asr_torch.ops.ctc_kernels import (BETA_RING, ctc_alpha, ctc_alpha_plain,
                                                 ctc_alpha_smem_bytes, ctc_alpha_smem_on_card,
                                                 ctc_beta, ctc_beta_plain, ctc_beta_ring,
                                                 ctc_beta_smem_bytes, ctc_beta_smem_on_card,
                                                 ctc_loss)
from lightning_asr_torch.ops.depthwise_kernels import depthwise_wgrad, depthwise_wgrad_plain
from lightning_asr_torch.ops.frontend import MelFrontendConfig
from lightning_asr_torch.ops.frontend_kernels import (extend_preemph, extend_preemph_plain,
                                                      mel_from_extended, mel_from_extended_plain)
from lightning_asr_torch.ops.lstm import (LSTMWeights, lstm, stack_directions, stacked_valid,
                                          unstack_directions)
from lightning_asr_torch.ops.lstm_kernels import (backward_copy_width, backward_smem_bytes,
                                                  backward_smem_on_card, forward_clusters_on_card,
                                                  forward_smem_bytes,
                                                  forward_smem_on_card, lstm_backward,
                                                  lstm_backward_plain,
                                                  lstm_backward_stacked, lstm_backward_stacked_plain,
                                                  lstm_recurrence, lstm_recurrence_plain,
                                                  lstm_recurrence_stacked,
                                                  lstm_recurrence_stacked_plain,
                                                  stacked_backward_smem_bytes,
                                                  stacked_backward_smem_on_card,
                                                  stacked_forward_clusters_on_card,
                                                  stacked_forward_smem_bytes,
                                                  stacked_forward_smem_on_card)
from lightning_asr_torch.ops.sepconv_kernels import (bf16_product_mismatches, sepconv_backward,
                                                     sepconv_backward_plain, sepconv_forward,
                                                     sepconv_forward_plain)

pytestmark = pytest.mark.cuda

# one bf16 rounding flip of one power term, twice (see chip_smoke.py)
K1_TOL_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,T,extra", [(1, 1, 0), (3, 31, 700), (2, 32, -500), (2, 33, 0),
                                       (1, 100, 10_000), (3, 63, 700), (2, 64, -500),
                                       (2, 65, 0), (1, 129, 50_000)])
def test_k1_tiles_and_ragged_signal(dev, B, T, extra):
    """Tile edges (64 frames a block), one frame, and a signal shorter or
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


@pytest.mark.parametrize("change", [{"n_mels": 80}, {"win_length": 400},
                                    {"win_length": 400, "hop_length": 320, "pad": 0},
                                    {"n_fft": 500, "win_length": 500},
                                    {"win_length": 512, "n_mels": 40}], ids=str)
def test_k1_configs_beside_the_default(dev, change):
    """Mel counts off 32 (the mel tiles' edge mask), windows longer than the
    20 steps a warp holds in registers (the rest read from shared memory
    each pass), the dual-stream frontend's hop of 320, steps past n_fft."""
    cfg = MelFrontendConfig(precision="default", **change)
    B, T = 2, 70
    n = (T - 1) * cfg.hop_length + cfg.n_fft + 333
    q = (torch.randn((B, n), generator=torch.Generator().manual_seed(cfg.n_mels)) * 0.1).to(dev)
    got = mel_from_extended(q, cfg, T)
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


def _lstm_case(dev, D, T, lengths, seed):
    H = 40
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    xproj = torch.randn((B, T, D, 4 * H), generator=g).to(dev)
    w_hh = (torch.rand((D, 4 * H, H), generator=g) * 2 - 1).div(H ** 0.5).to(dev)
    grad_h = torch.randn((B, T, D * H), generator=g).to(dev)
    return xproj, torch.tensor(lengths, dtype=torch.int32, device=dev), w_hh, grad_h


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,lengths", [(1, [1, 0]), (37, [37, 0, 1, 20])])
def test_k2_cell_output(dev, D, T, lengths):
    xproj, lens, w_hh, _ = _lstm_case(dev, D, T, lengths, T + 10 * D)
    h_only = lstm_recurrence(xproj, lens, w_hh)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    assert torch.equal(h, h_only)                   # the cell output changes no bit of h
    want_h, want_c = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    assert (h - want_h).abs().max().item() <= 1e-5
    assert (c - want_c).abs().max().item() <= 1e-4  # |c| grows past 1; same float32 math
    for b, n in enumerate(lengths):
        assert bool((c[b, n:] == 0).all())


# K2's own cases (D, T, lengths): the training T' on ragged rows; lengths
# around its 8-slot ring beside 0, 1 and T; one row (B=1); one direction;
# T below the ring
K2_CASES = [(2, 836, [836, 790, 702, 655, 519, 418, 417, 330, 241, 100]),
            (2, 40, [0, 1, 6, 7, 8, 9, 15, 16, 17, 40]), (1, 20, [20, 7, 8, 9, 0, 1]),
            (2, 801, [801]), (1, 1, [1]), (2, 5, [5, 0, 2])]


def _k2_check(xproj, lens, w_hh, lengths):
    before = lstm_recurrence.launches
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    h_only = lstm_recurrence(xproj, lens, w_hh)
    assert lstm_recurrence.launches == before + 2                            # one launch a call
    assert torch.equal(h, h_only)                   # the cell output changes no bit of h
    want_h, want_c = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    # float32; dot sums in another order, the card's expf/tanhf; |c| past 1
    assert (h - want_h).abs().max().item() <= 1e-5
    assert (c - want_c).abs().max().item() <= 1e-4
    for b, n in enumerate(lengths):
        assert bool((h[b, n:] == 0).all()) and bool((c[b, n:] == 0).all())
    again = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    assert torch.equal(again[0], h) and torch.equal(again[1], c)              # deterministic
    return h, c


@pytest.mark.parametrize("D,T,lengths", K2_CASES)
def test_k2_against_plain(dev, D, T, lengths):
    xproj, lens, w_hh, _ = _lstm_case(dev, D, T, lengths, T + 30 * D)
    _k2_check(xproj, lens, w_hh, lengths)


def test_k2_inputs_off_16_bytes(dev):
    """xproj that starts one float past a 16-byte boundary: the ring's copies
    move one float each (``backward_copy_width``), with the same bits."""
    D, T, lengths = 2, 45, [45, 11, 3, 0, 8]
    xproj, lens, w_hh, _ = _lstm_case(dev, D, T, lengths, 6)
    off = torch.cat([xproj.new_zeros(1), xproj.flatten()])[1:].view(xproj.shape)
    assert backward_copy_width(off) == 1 and backward_copy_width(xproj) == 4
    got = _k2_check(off, lens, w_hh, lengths)
    want = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2_shared_memory_as_stated(dev):
    assert forward_smem_on_card(40, dev) == forward_smem_bytes(40)


# K3's cases: one frame beside none; the training T' with ragged rows up to
# it; lengths below the ring's 8 slots, at them and off their multiples
K3_CASES = [(1, [1, 0]), (37, [37, 0, 1, 20]), (300, [300, 299, 7]),
            (836, [836, 835, 701, 512, 333, 100, 9, 1]), (20, [9, 7, 3, 2, 8, 16, 17, 0])]


def _k3_check(xproj, lens, w_hh, h, c, grad_h, lengths):
    before = lstm_backward.launches
    d_xproj, dw = lstm_backward(xproj, lens, w_hh, h, c, grad_h)
    assert lstm_backward.launches == before + 1
    want_dx, want_dw = lstm_backward_plain(xproj, lens, w_hh, h, c, grad_h)
    # float32; the dots and the dW sums over (row, frame) in another order
    assert (d_xproj - want_dx).abs().max().item() <= 1e-4
    assert (dw - want_dw).abs().max().item() <= 1e-3 * max(1.0, want_dw.abs().max().item())
    for b, n in enumerate(lengths):
        assert bool((d_xproj[b, n:] == 0).all())
    again = lstm_backward(xproj, lens, w_hh, h, c, grad_h)
    assert torch.equal(again[0], d_xproj) and torch.equal(again[1], dw)     # deterministic


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("T,lengths", K3_CASES)
def test_k3_against_plain(dev, D, T, lengths):
    xproj, lens, w_hh, grad_h = _lstm_case(dev, D, T, lengths, T + 20 * D)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    _k3_check(xproj, lens, w_hh, h, c, grad_h, lengths)


def test_k3_inputs_off_16_bytes(dev):
    """Inputs that start one float past a 16-byte boundary: the ring's
    copies move one float each (``backward_copy_width``)."""
    D, T, lengths = 2, 45, [45, 11, 3]
    xproj, lens, w_hh, grad_h = _lstm_case(dev, D, T, lengths, 5)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    xproj, h, c, grad_h = (torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
                           for a in (xproj, h, c, grad_h))
    assert backward_copy_width(xproj, h, c, grad_h) == 1
    _k3_check(xproj, lens, w_hh, h, c, grad_h, lengths)


def test_k3_shared_memory_as_stated(dev):
    assert backward_smem_on_card(40, dev) == backward_smem_bytes(40)


def _stacked_case(dev, T, lengths, seed, mask="lengths", H=40):
    """Stacked rows as ``ops/lstm.py`` builds them (forward rows valid at
    t < len, reverse rows at T-1-t < len); with ``mask="random"`` a random
    0/1 mask instead, with ``"holes"`` those rows with a hole every 8 steps
    (one ring of K8's walk apart)."""
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    xproj = torch.randn((T, 2 * B, 4 * H), generator=g)
    w_f, w_b = ((torch.rand((4 * H, H), generator=g) * 2 - 1).div(H ** 0.5) for _ in range(2))
    lens = torch.tensor(lengths)
    t = torch.arange(T)[:, None]
    valid = torch.cat([t < lens[None], (T - 1 - t) < lens[None]], dim=1).float()
    if mask == "random":
        valid = (torch.rand((T, 2 * B), generator=g) < 0.7).float()
    elif mask == "holes":
        valid[(torch.arange(T) + torch.arange(2 * B)[:, None]).t() % 8 == 3] = 0.0
    grad_h = torch.randn((T, 2 * B, H), generator=g)
    return [a.to(dev) for a in (xproj, valid, w_f, w_b, grad_h)]


# The training T' on rows like chip_smoke.train_rows' (one full, the rest
# 2-16.7 s); lengths around K8's 8-slot ring; a row with no valid step
# beside full rows; holes one ring apart; a random mask
STACKED_CASES = [(1, [1, 0], "lengths"), (37, [37, 0, 1, 20], "lengths"),
                 (300, [300, 299, 7], "lengths"), (50, [50, 50, 50], "random"),
                 (836, [836, 790, 702, 655, 519, 418, 417, 330, 241, 100], "lengths"),
                 (20, [7, 8, 9, 15, 16, 17, 1, 20], "lengths"), (64, [64, 0, 64], "lengths"),
                 (90, [90, 61, 30, 0], "holes")]


def _k8_check(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h, want_h_prev, want_c_prev):
    before = lstm_backward_stacked.launches
    d_x, dw_f, dw_b = lstm_backward_stacked(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h)
    assert lstm_backward_stacked.launches == before + 1
    assert bool((d_x[valid == 0] == 0).all())
    want_dx, want_f, want_b = lstm_backward_stacked_plain(xproj, valid, w_f, w_b, want_h_prev,
                                                          want_c_prev, grad_h)
    assert (d_x - want_dx).abs().max().item() <= 1e-4
    for got, ref in ((dw_f, want_f), (dw_b, want_b)):
        assert (got - ref).abs().max().item() <= 1e-3 * max(1.0, ref.abs().max().item())
    again = lstm_backward_stacked(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h)
    assert all(torch.equal(a, b) for a, b in zip(again, (d_x, dw_f, dw_b)))   # deterministic


@pytest.mark.parametrize("T,lengths,mask", STACKED_CASES)
def test_k7_k8_against_plain(dev, T, lengths, mask):
    xproj, valid, w_f, w_b, grad_h = _stacked_case(dev, T, lengths, T, mask)
    before = lstm_recurrence_stacked.launches
    h, h_prev, c_prev = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    assert lstm_recurrence_stacked.launches == before + 1
    want = lstm_recurrence_stacked_plain(xproj, valid, w_f, w_b)
    # float32; dot sums in another order, the card's expf/tanhf
    for got, ref, tol in zip((h, h_prev, c_prev), want, (1e-5, 1e-5, 1e-4)):
        assert (got - ref).abs().max().item() <= tol
    assert bool((h[valid == 0] == 0).all())
    _k8_check(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h, want[1], want[2])


def test_k8_inputs_off_16_bytes(dev):
    """h_prev and grad_h that start one float past a 16-byte boundary: the
    walk's copies move one float each (``backward_copy_width``)."""
    xproj, valid, w_f, w_b, grad_h = _stacked_case(dev, 45, [45, 11, 3], 45, "holes")
    _, h_prev, c_prev = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    h_off, g_off = (torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape) for a in (h_prev, grad_h))
    assert backward_copy_width(h_off, g_off) == 1
    _k8_check(xproj, valid, w_f, w_b, h_off, c_prev, g_off, h_prev, c_prev)


def test_k8_shared_memory_as_stated(dev):
    assert stacked_backward_smem_on_card(40, dev) == stacked_backward_smem_bytes(40)


@pytest.mark.parametrize("T,lengths,mask", [(37, [37, 0, 1, 20], "lengths"), (50, [50, 50, 50], "random"),
                                            (90, [90, 61, 30, 0], "holes")])
def test_k8_h128_against_plain(dev, T, lengths, mask):
    """K8 at the LSTM head's H = 128 (the pair walk and the dW pass) on
    ragged rows, a random mask and holes against its plain version, with
    16-byte copies and, on h_prev and grad_h one float off, one-float
    copies."""
    xproj, valid, w_f, w_b, grad_h = _stacked_case(dev, T, lengths, T, mask, H=128)
    _, h_prev, c_prev = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    _k8_check(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h, h_prev, c_prev)
    h_off, g_off = (torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape) for a in (h_prev, grad_h))
    assert backward_copy_width(h_off, g_off) == 1
    _k8_check(xproj, valid, w_f, w_b, h_off, c_prev, g_off, h_prev, c_prev)


# K7's own cases: the training T' on ragged rows; lengths around its 8-slot
# ring and its 16-entry list ring beside 0 and 1; holes one ring apart and
# a random mask (gaps inside the walk)
K7_CASES = [(836, [836, 790, 702, 655, 519, 418, 417, 330, 241, 100], "lengths"),
            (40, [0, 1, 6, 7, 8, 9, 15, 16, 17, 31, 32, 33, 40], "lengths"),
            (90, [90, 61, 30, 0], "holes"), (300, [300, 17, 16], "holes"),
            (50, [50, 50, 50], "random")]


def _k7_check(xproj, valid, w_f, w_b, tol=1e-5):
    before = lstm_recurrence_stacked.launches
    got = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    assert lstm_recurrence_stacked.launches == before + 1
    want = lstm_recurrence_stacked_plain(xproj, valid, w_f, w_b)
    # float32; dot sums in another order, the card's expf/tanhf; |c| past 1
    for a, ref, tol in zip(got, want, (tol, tol, 10 * tol)):
        assert (a - ref).abs().max().item() <= tol
    assert bool((got[0][valid <= 0] == 0).all())
    again = lstm_recurrence_stacked(xproj, valid, w_f, w_b)
    assert all(torch.equal(a, b) for a, b in zip(again, got))              # deterministic
    return got


@pytest.mark.parametrize("T,lengths,mask", K7_CASES)
def test_k7_against_plain(dev, T, lengths, mask):
    xproj, valid, w_f, w_b, _ = _stacked_case(dev, T, lengths, T + 1, mask)
    _k7_check(xproj, valid, w_f, w_b)


def test_k7_inputs_off_16_bytes(dev):
    """xproj that starts one float past a 16-byte boundary: the ring's copies
    move one float each (``backward_copy_width``), with the same bits."""
    xproj, valid, w_f, w_b, _ = _stacked_case(dev, 45, [45, 11, 3, 0], 45, "holes")
    off = torch.cat([xproj.new_zeros(1), xproj.flatten()])[1:].view(xproj.shape)
    assert backward_copy_width(off) == 1 and backward_copy_width(xproj) == 4
    got = _k7_check(off, valid, w_f, w_b)
    assert all(torch.equal(a, b) for a, b in zip(got, lstm_recurrence_stacked(xproj, valid, w_f, w_b)))


@pytest.mark.parametrize("T,lengths", [(836, [836, 790, 702, 655, 519, 418, 417, 330, 241, 100]),
                                       (40, [40, 0, 1, 7, 8, 9, 16, 17, 39])])
def test_k7_h_equals_k2_bit_for_bit(dev, T, lengths):
    """K7 on the stacked rows and K2 on the same projections and lengths
    run the same float32 operations in the same order: h is equal bit for
    bit, and K7's c_prev at each row's next step is K2's cell state."""
    xproj, lens, w_hh, _ = _lstm_case(dev, 2, T, lengths, T + 3)
    h2, c2 = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    h7, _, c_prev = lstm_recurrence_stacked(stack_directions(xproj).contiguous(), stacked_valid(T, lens),
                                            w_hh[0].contiguous(), w_hh[1].contiguous())
    assert torch.equal(unstack_directions(h7).reshape(h2.shape), h2)
    c_next = unstack_directions(torch.cat([c_prev[1:], c_prev[:1]]))        # c after each step
    for b, n in enumerate(lengths):
        assert torch.equal(c_next[b, :max(n - 1, 0), 0], c2[b, :max(n - 1, 0), 0])


def test_k7_shared_memory_as_stated(dev):
    assert stacked_forward_smem_on_card(40, dev) == stacked_forward_smem_bytes(40)


# K7 at the LSTM head's H = 128: the training T' on ragged rows with lengths
# around the ring's 8 slots and the list ring's 16 entries, 0 and 1; holes
# one ring apart and a random mask (gaps inside the walk)
K7_H128_CASES = [(836, [836, 790, 519, 100, 17, 16, 15, 1, 0], "lengths"),
                 (40, [0, 1, 7, 8, 9, 15, 16, 17, 40], "lengths"),
                 (90, [90, 61, 30, 0], "holes"), (50, [50, 50, 50], "random")]


@pytest.mark.parametrize("T,lengths,mask", K7_H128_CASES)
def test_k7_h128_pair_walk_against_plain(dev, T, lengths, mask):
    """K7's pair walk at H = 128 against its plain version (K2's tolerance
    at that width: 128-term dots), twice for the same bits, exact zeros at
    the invalid steps; with xproj one float off 16 bytes (copies of one
    float) the same bits; its shared memory as stated, its pairs resident."""
    xproj, valid, w_f, w_b, _ = _stacked_case(dev, T, lengths, T + 2, mask, H=128)
    got = _k7_check(xproj, valid, w_f, w_b, tol=1e-4)
    off = torch.cat([xproj.new_zeros(1), xproj.flatten()])[1:].view(xproj.shape)
    assert backward_copy_width(off) == 1
    assert all(torch.equal(a, b) for a, b in zip(lstm_recurrence_stacked(off, valid, w_f, w_b), got))
    assert stacked_forward_smem_on_card(128, dev) == stacked_forward_smem_bytes(128) == 9296
    assert stacked_forward_clusters_on_card(dev) > 0


def test_k7_h128_refuses_what_32_bit_offsets_cannot_reach(dev):
    """K7's pair walk indexes (T, 2B, 4H) with 32-bit offsets: 2 ** 31
    projections (8 GiB) raise before any launch."""
    T, B2, H = 2 ** 31 // (64 * 4 * 128), 64, 128
    xproj = torch.empty((T, B2, 4 * H), device=dev)
    w = torch.zeros((4 * H, H), device=dev)
    before = lstm_recurrence_stacked.launches
    with pytest.raises(ValueError, match="32-bit"):
        lstm_recurrence_stacked(xproj, torch.ones((T, B2), device=dev), w, w)
    assert lstm_recurrence_stacked.launches == before


@pytest.mark.parametrize("T,lengths", [(836, [836, 790, 702, 655, 519, 418, 417, 330, 241, 100]),
                                       (40, [40, 0, 1, 7, 8, 9, 15, 16, 17, 39])])
def test_k7_h128_h_equals_k2_bit_for_bit(dev, T, lengths):
    """At H = 128 K7's pair walk on the stacked rows and K2's on the same
    projections and lengths run one loop (``pair_forward_walk``): h is equal
    bit for bit, and K7's c_prev at each row's next step is K2's cell."""
    H, B = 128, len(lengths)
    g = torch.Generator().manual_seed(T + 128)
    xproj = torch.randn((B, T, 2, 4 * H), generator=g).to(dev)
    w_hh = ((torch.rand((2, 4 * H, H), generator=g) * 2 - 1) / np.sqrt(H)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    h2, c2 = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    h7, _, c_prev = lstm_recurrence_stacked(stack_directions(xproj).contiguous(), stacked_valid(T, lens),
                                            w_hh[0].contiguous(), w_hh[1].contiguous())
    assert torch.equal(unstack_directions(h7).reshape(h2.shape), h2)
    c_next = unstack_directions(torch.cat([c_prev[1:], c_prev[:1]]))        # c after each step
    for b, n in enumerate(lengths):
        assert torch.equal(c_next[b, :max(n - 1, 0), 0], c2[b, :max(n - 1, 0), 0])


def test_fused_bilstm_on_the_card_matches_k2_k3(dev):
    """``lstm(..., fuse_directions=True)`` (K7, K8) against the K2 / K3 path:
    output and every gradient."""
    g = torch.Generator().manual_seed(3)
    B, T, C, H = 5, 90, 24, 40
    s = H ** -0.5
    ws = [LSTMWeights(*((torch.rand(sh, generator=g) * 2 - 1) * s for sh in
                        ((4 * H, C), (4 * H, H), (4 * H,), (4 * H,)))) for _ in range(2)]
    x = torch.randn((B, T, C), generator=g)
    lens = torch.tensor([T, 1, 45, 89, 0], dtype=torch.int32)
    probe = torch.randn((B, T, 2 * H), generator=g).to(dev)
    res = []
    for fuse in (False, True):
        xs = x.to(dev).requires_grad_(True)
        wd = [LSTMWeights(*(t.to(dev).requires_grad_(True) for t in w)) for w in ws]
        y = lstm(xs, lens.to(dev), wd[0], wd[1], fuse_directions=fuse)
        grads = torch.autograd.grad((y * probe).sum(), [xs, *wd[0], *wd[1]])
        res.append((y.detach(), grads))
    assert (res[0][0] - res[1][0]).abs().max().item() <= 1e-5
    for a, b in zip(res[0][1], res[1][1]):
        assert (a - b).abs().max().item() <= 1e-3 * max(1.0, b.abs().max().item())


def test_k7_k8_reject_what_they_cannot_run(dev):
    x = torch.zeros((5, 4, 32), device=dev)
    v = torch.ones((5, 4), device=dev)
    with pytest.raises(ValueError):        # no kernel instantiated for H=8
        lstm_recurrence_stacked(x, v, torch.zeros((32, 8), device=dev), torch.zeros((32, 8), device=dev))
    w = torch.zeros((160, 40), device=dev)
    with pytest.raises(ValueError):        # valid on another device
        lstm_recurrence_stacked(torch.zeros((5, 4, 160), device=dev), v.cpu(), w, w)
    with pytest.raises(ValueError):        # an odd row count
        lstm_recurrence_stacked(torch.zeros((5, 3, 160), device=dev), v[:, :3], w, w)


def _ctc_case(dev, B, T, C, L, seed):
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g) * 3, dim=-1).to(dev)
    in_lens = torch.randint(0, T + 1, (B,), generator=g, dtype=torch.int32)
    in_lens[0] = T
    tl = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    tl[-1] = 0                                           # an empty target
    targets = torch.randint(0, C - 1, (B, L), generator=g, dtype=torch.int32)
    if L > 1:
        targets[0, 1] = targets[0, 0]                    # a repeat
    return lp, in_lens.to(dev), targets.to(dev), tl.to(dev)


@pytest.mark.parametrize("B,T,C,L", [(3, 1, 5, 1), (5, 40, 7, 6), (4, 200, 29, 96),
                                     (2, 500, 29, 600)])
def test_k4_k5_against_plain(dev, B, T, C, L):
    """Block sizes from one warp to 1024 threads with 2 states a thread."""
    lp, il, tg, tl = _ctc_case(dev, B, T, C, L, T + L)
    before = (ctc_alpha.launches, ctc_beta.launches)
    alpha, ll = ctc_alpha(lp, il, tg, tl, C - 1)
    want_alpha, want_ll = ctc_alpha_plain(lp, il, tg, tl, C - 1)
    valid = (torch.arange(T, device=dev)[None, :] < il[:, None])[:, :, None]
    # float32 log-space sums with the card's expf/logf: a few ulps a step
    # over up to 500 steps, relative to |alpha| up to ~2000; states at the
    # -1e30 sentinel (unreachable) are compared by that alone
    live = valid & (want_alpha > -1e29)
    tol = 1e-5 * max([1.0] + want_ll[want_ll > -1e29].abs().tolist())
    assert (torch.where(live, alpha - want_alpha, 0.0)).abs().max().item() <= tol
    assert bool(((alpha > -1e29) == (want_alpha > -1e29))[valid.expand_as(alpha)].all())
    assert (torch.where(want_ll > -1e29, ll - want_ll, 0.0)).abs().max().item() <= tol
    assert torch.equal(ll <= -1e29, want_ll <= -1e29)
    gbar = torch.rand((B,), device=dev) + 0.5
    grad = ctc_beta(lp, il, tg, tl, alpha, ll, gbar, C - 1)
    want = ctc_beta_plain(lp, il, tg, tl, want_alpha, want_ll, gbar, C - 1)
    assert (ctc_alpha.launches, ctc_beta.launches) == (before[0] + 1, before[1] + 1)
    assert (grad - want).abs().max().item() <= 1e-4
    assert bool((torch.where(valid, 0.0, grad) == 0).all())  # zero past each row's length


def _k5_rows(dev, T, C, L, lengths, seed):
    """Rows of the given lengths with about 0.3 labels a frame (15 a
    second at the stem's 50 frames), capped at L; the last row's target
    fills L (every warp runs the recursion, the alignment may be
    impossible), the one before it is empty."""
    g = torch.Generator().manual_seed(seed)
    B = len(lengths)
    lp = torch.log_softmax(torch.randn((B, T, C), generator=g) * 3, dim=-1).to(dev)
    in_lens = torch.tensor(lengths, dtype=torch.int32)
    tl = (in_lens.float() * 0.3).round().clamp(max=L).to(torch.int32)
    tl[-1] = L
    if B > 1:
        tl[-2] = 0
    targets = torch.randint(0, C - 1, (B, L), generator=g, dtype=torch.int32)
    return lp, in_lens.to(dev), targets.to(dev), tl.to(dev)


def _ragged(T, B, seed):
    g = torch.Generator().manual_seed(seed)
    return [T] + torch.randint(T // 6, T + 1, (B - 1,), generator=g).tolist()


# K5's cases beside test_k4_k5_against_plain's, (T, C, L, lengths): the
# training shape on ragged rows; lengths around the ring (R - 1, R, R + 1,
# 2R) beside 0, 1 and T; the AISHELL-1 vocabulary (4333 characters and the
# blank) with L = 60; the largest S the wrapper takes (4095: a 6-slot ring,
# four states a thread), the largest with 8 slots (3227) and three states
# a thread (S = 2401)
R8 = BETA_RING
K5_CASES = [(836, 29, 256, _ragged(836, 32, 5)),
            (20, 29, 6, [20, 0, 1, R8 - 1, R8, R8 + 1, 2 * R8, 3, 20]),
            (200, 4334, 60, _ragged(200, 6, 7)),
            (40, 29, 2047, [40, 6, 5, 7, 0, 40]),
            (30, 29, 1613, [30, 6, 7, 8, 9]),
            (30, 29, 1200, [30, 8, 9, 0])]


@pytest.mark.parametrize("T,C,L,lengths", K5_CASES)
def test_k5_against_plain_on_its_own_inputs(dev, T, C, L, lengths):
    """K5 against its plain version given K4's own alpha and ll, within
    chip_smoke.py's K45_TOL_GRAD; exact zeros past each row's length; the
    same bits on a second call."""
    lp, il, tg, tl = _k5_rows(dev, T, C, L, lengths, T + L)
    alpha, ll = ctc_alpha(lp, il, tg, tl, C - 1)
    gbar = torch.rand((len(lengths),), device=dev) + 0.5
    before = ctc_beta.launches
    grad = ctc_beta(lp, il, tg, tl, alpha, ll, gbar, C - 1)
    assert ctc_beta.launches == before + 1
    want = ctc_beta_plain(lp, il, tg, tl, alpha, ll, gbar, C - 1)
    assert grad.shape == (len(lengths), T, 2 * L + 1)
    assert (grad - want).abs().max().item() <= 1e-5
    valid = (torch.arange(T, device=dev)[None, :] < il[:, None])[:, :, None]
    assert bool((torch.where(valid, 0.0, grad) == 0).all())
    assert torch.equal(ctc_beta(lp, il, tg, tl, alpha, ll, gbar, C - 1), grad)


@pytest.mark.parametrize("S", [1, 513, 3227, 3229, 4095])
def test_k5_shared_memory_as_stated(dev, S):
    assert ctc_beta_smem_on_card(S) == ctc_beta_smem_bytes(S)
    assert ctc_beta_ring(S) == (6 if S > 3227 else BETA_RING)


# K4's: K5's cases, and S = 1041 (two states a thread, the walkers' second
# states past the end beside warps out of the walk)
K4_CASES = K5_CASES + [(30, 29, 520, [30, 7, 9, 1, 0])]


@pytest.mark.parametrize("T,C,L,lengths", K4_CASES)
def test_k4_against_plain_on_its_own_inputs(dev, T, C, L, lengths):
    """K4 on K5's cases against its plain version: within chip_smoke.py's
    K45_TOL_REL (relative to the largest |ll|) at the reachable states of
    the valid frames and in ll, the plain version's bits at the sentinel
    states (-1e30 and -2e30, the warps out of the walk among them) and on
    the rows with no alignment; the same bits on a second call; one launch
    a call."""
    lp, il, tg, tl = _k5_rows(dev, T, C, L, lengths, T + L)
    before = ctc_alpha.launches
    alpha, ll = ctc_alpha(lp, il, tg, tl, C - 1)
    assert ctc_alpha.launches == before + 1
    want, want_ll = ctc_alpha_plain(lp, il, tg, tl, C - 1)
    assert alpha.shape == want.shape and ll.shape == want_ll.shape
    valid = (torch.arange(T, device=dev)[None, :] < il[:, None])[:, :, None].expand_as(alpha)
    live = valid & (want > -1e29)
    possible = want_ll > -1e29
    scale = max([1.0] + want_ll[possible].abs().tolist())
    assert torch.where(live, alpha - want, 0.0).abs().max().item() <= 1e-5 * scale
    assert torch.equal(alpha[valid & ~live], want[valid & ~live])
    assert torch.where(possible, ll - want_ll, 0.0).abs().max().item() <= 1e-5 * scale
    assert torch.equal(ll[~possible], want_ll[~possible])
    again, again_ll = ctc_alpha(lp, il, tg, tl, C - 1)
    assert ctc_alpha.launches == before + 2
    assert torch.equal(again[valid], alpha[valid]) and torch.equal(again_ll, ll)


@pytest.mark.parametrize("S", [1, 513, 1229, 3227, 4095])
def test_k4_shared_memory_as_stated(dev, S):
    assert ctc_alpha_smem_on_card(S) == ctc_alpha_smem_bytes(S)


def test_ctc_loss_function_on_the_card(dev):
    lp, il, tg, tl = _ctc_case(dev, 4, 60, 29, 20, 3)
    x = lp.clone().requires_grad_(True)
    loss = ctc_loss(x, il, tg, tl, 28)
    loss.sum().backward()
    xc = lp.cpu().clone().requires_grad_(True)
    want = ctc_loss(xc, il.cpu(), tg.cpu(), tl.cpu(), 28)
    want.sum().backward()
    assert (loss.detach().cpu() - want.detach()).abs().max().item() <= 1e-3
    assert (x.grad.cpu() - xc.grad).abs().max().item() <= 1e-4


@pytest.mark.parametrize("pad", [32, 0])
@pytest.mark.parametrize("with_prev", [False, True])
def test_k6_equals_plain_bit_for_bit(dev, pad, with_prev):
    """One row and several, full and ragged lengths down to the support
    limit, a zero tail longer than the frames need."""
    cfg = MelFrontendConfig(pad=pad)
    g = torch.Generator().manual_seed(pad + with_prev)
    for lens in ([3000], [3000, 2999, 1700, cfg.n_fft // 2 + pad + 1]):
        B, S = len(lens), 3000
        waves = torch.randn((B, S), generator=g).to(dev)
        wl = torch.tensor(lens, dtype=torch.int32, device=dev)
        prev = torch.randn((B,), generator=g).to(dev) if with_prev else None
        out_total = S + 2 * pad + cfg.n_fft + 333
        before = extend_preemph.launches
        got = extend_preemph(waves, wl, prev, cfg, out_total)
        assert extend_preemph.launches == before + 1
        assert torch.equal(got, extend_preemph_plain(waves, wl, prev, cfg, out_total))


def test_k6_rejects_what_it_cannot_run(dev):
    cfg = MelFrontendConfig()
    lens = torch.tensor([900], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        extend_preemph(torch.zeros((1, 900), dtype=torch.float16, device=dev), lens, None, cfg, 2000)
    with pytest.raises(ValueError):
        extend_preemph(torch.zeros((1, 1800), device=dev)[:, ::2], lens, None, cfg, 2000)


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(a.abs().float().clamp_min(2.0 ** -126))) - 7)


def _close_to_plain(got: torch.Tensor, want: torch.Tensor) -> None:
    """At most one rounding to bf16 apart (for bf16 outputs), after float32
    sums in another order (slack: 2^-17 of the largest value)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs())) if got.dtype == torch.bfloat16 else 0.0
    slack = 2.0 ** -17 * w.abs().max()
    assert bool(((g - w).abs() <= ulp + slack).all()), (g - w).abs().max().item()


def _conv_case(dev, B, T, Cin, Cout, k, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, Cin, T), generator=g).to(dtype).to(dev)
    wd = ((torch.rand((Cin, 1, k), generator=g) * 2 - 1) / k ** 0.5).to(dev)
    wp = ((torch.rand((Cout, Cin, 1), generator=g) * 2 - 1) / Cin ** 0.5).to(dev)
    dy = torch.randn((B, Cout, T), generator=g).to(dtype).to(dev)
    return x, wd, wp, dy


CONV_CASES = [(1, 40, 16, 24, 5),        # one row
              (2, 5, 8, 8, 33),          # T < k
              (3, 70, 40, 136, 9),       # T, Cin, Cout off the tiles
              (2, 100, 64, 48, 87),      # the largest k of the model
              (2, 64, 336, 512, 51),     # the context block's widths, T on the bf16 tile
              (2, 129, 24, 129, 15),     # T, Cin (not a multiple of 16), Cout one past a tile
              (1, 191, 336, 256, 63),    # Cin = 336 with T off the tile
              (2, 65, 512, 512, 87),     # the widest layer, T one past the bf16 tile
              (2, 836, 256, 256, 33),    # the training T': rows 8-byte, not 16-byte, aligned
              (2, 128, 48, 72, 17),      # T a multiple of 16: 16-byte loads
              (5, 37, 1024, 1024, 5)]    # five rows in two uneven bf16 wp_grad splits


def test_bf16_products_round_as_the_plain_version(dev):
    """The bf16 K9 and K11 multiply two values at a time with mul.rn.bf16x2;
    every pair of finite bf16 values must give the float32 product rounded
    to bf16, which is what keeps K9's depthwise output and K11's products
    the plain versions'."""
    assert bf16_product_mismatches(dev) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Cin,Cout,k", CONV_CASES)
def test_k9_k10_against_plain(dev, B, T, Cin, Cout, k, dtype):
    x, wd, wp, dy = _conv_case(dev, B, T, Cin, Cout, k, dtype, T + k)
    before = (sepconv_forward.launches, sepconv_backward.launches)
    y = sepconv_forward(x, wd, wp)
    dx, gwd, gwp = sepconv_backward(x, wd, wp, dy)
    assert (sepconv_forward.launches, sepconv_backward.launches) == (before[0] + 1, before[1] + 1)
    want_dx, want_gwd, want_gwp = sepconv_backward_plain(x, wd, wp, dy)
    # the depthwise sums run in the plain version's order, so only the
    # pointwise and dz products' float32 order differs before the rounding
    _close_to_plain(y, sepconv_forward_plain(x, wd, wp))
    _close_to_plain(dx, want_dx)
    for got, want in ((gwd, want_gwd), (gwp, want_gwp)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    again = sepconv_backward(x, wd, wp, dy)       # fixed-order sums: the same bits
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, gwd, gwp)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,k", [(1, 40, 16, 5), (2, 5, 8, 33), (3, 300, 40, 9),
                                     (2, 600, 64, 87),
                                     (2, 836, 336, 51),   # the training T': rows 8-byte aligned
                                     (2, 128, 40, 1),     # T a multiple of 8: 16-byte loads; one tap
                                     (1, 836, 13, 87),    # C off the bf16 block's 8 channels
                                     (3, 257, 40, 87),    # odd T one frame past a chunk
                                     (2, 512, 24, 127)])  # the bf16 kernel's largest k, two chunks
def test_k11_against_plain(dev, B, T, C, k, dtype):
    x, _, _, dy = _conv_case(dev, B, T, C, C, k, dtype, T + 3 * k)
    before = depthwise_wgrad.launches
    got = depthwise_wgrad(x, dy, k)
    assert depthwise_wgrad.launches == before + 1
    want = depthwise_wgrad_plain(x, dy, k)
    # the same products (rounded to bf16 in bf16) summed in another order
    # within each 256-frame chunk (in bf16 by the tensor cores)
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    assert torch.equal(got, depthwise_wgrad(x, dy, k))


def test_conv_kernels_reject_what_they_cannot_run(dev):
    x, wd, wp, dy = _conv_case(dev, 2, 30, 8, 8, 5, torch.float32, 0)
    for args in ((x.half(), wd, wp), (x, wd[:, :, :4].contiguous(), wp),
                 (x.transpose(1, 2).contiguous().transpose(1, 2), wd, wp)):
        with pytest.raises(ValueError):
            sepconv_forward(*args)
    with pytest.raises(ValueError):        # the bf16 forward holds at most 127 taps in registers
        sepconv_forward(x.bfloat16(), torch.zeros((8, 1, 129), device=dev), wp)
    with pytest.raises(ValueError):
        sepconv_backward(x, wd, wp, dy.bfloat16())
    with pytest.raises(ValueError):        # ... and so does the bf16 backward
        sepconv_backward(x.bfloat16(), torch.zeros((8, 1, 129), device=dev), wp, dy.bfloat16())
    with pytest.raises(ValueError):
        depthwise_wgrad(x.half(), dy.half(), 5)
    with pytest.raises(ValueError):
        depthwise_wgrad(x, x, 4)
    with pytest.raises(ValueError):        # the bf16 K11 holds its window loads in registers
        depthwise_wgrad(x.bfloat16(), x.bfloat16(), 129)
    with pytest.raises(ValueError):
        depthwise_wgrad(x[:, :, ::2], x[:, :, ::2], 5)


@pytest.mark.parametrize("hidden", [32, 64, 96, 136])
def test_lstm_kernels_refuse_other_hidden_sizes(dev, hidden):
    """The LSTM kernels are built for H = 40 (the context BiLSTM) and 128
    (the LSTM head) only: a CUDA tensor at another H raises before any
    launch, and no plain version runs in its place."""
    xproj = torch.zeros((2, 8, 2, 4 * hidden), device=dev)
    lens = torch.full((2,), 8, dtype=torch.int32, device=dev)
    w_hh = torch.zeros((2, 4 * hidden, hidden), device=dev)
    counts = (lstm_recurrence.launches, lstm_backward.launches, lstm_recurrence_stacked.launches,
              lstm_backward_stacked.launches)
    with pytest.raises(ValueError, match="hidden sizes"):
        lstm_recurrence(xproj, lens, w_hh)
    with pytest.raises(ValueError, match="hidden sizes"):
        lstm_backward(xproj, lens, w_hh, torch.zeros((2, 8, 2 * hidden), device=dev),
                      torch.zeros((2, 8, 2, hidden), device=dev),
                      torch.zeros((2, 8, 2 * hidden), device=dev))
    xp = torch.zeros((8, 4, 4 * hidden), device=dev)
    valid = torch.ones((8, 4), device=dev)
    w = torch.zeros((4 * hidden, hidden), device=dev)
    with pytest.raises(ValueError, match="hidden sizes"):
        lstm_recurrence_stacked(xp, valid, w, w)
    with pytest.raises(ValueError, match="hidden sizes"):
        lstm_backward_stacked(xp, valid, w, w, *(torch.zeros((8, 4, hidden), device=dev),) * 3)
    assert counts == (lstm_recurrence.launches, lstm_backward.launches,
                      lstm_recurrence_stacked.launches, lstm_backward_stacked.launches)


@pytest.mark.parametrize("T,lengths", [(836, (836, 500, 17, 1, 0)), (40, (40, 9, 8, 7)),
                                       (5, (5, 1))])
def test_lstm_kernels_at_h128_against_plain(dev, T, lengths):
    """K2, K3, K7 and K8 at the LSTM head's H = 128 (their gates pass
    staging W_hh 16 rows at a time; K3's and K8's walks on a pair of CTAs
    and their dW passes) on ragged rows against their plain versions, K7's
    h equal to K2's and K8's gradients equal to K3's bit for bit, and their
    shared memory as stated."""
    H, B = 128, len(lengths)
    g = torch.Generator().manual_seed(T)
    s = 1.0 / np.sqrt(H)
    xproj = torch.randn((B, T, 2, 4 * H), generator=g).to(dev)
    w_hh = ((torch.rand((2, 4 * H, H), generator=g) * 2 - 1) * s).to(dev)
    grad_h = torch.randn((B, T, 2 * H), generator=g).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    want_h, want_c = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    assert (h - want_h).abs().max().item() <= 1e-4 and (c - want_c).abs().max().item() <= 1e-3
    d_x, dw = lstm_backward(xproj, lens, w_hh, h, c, grad_h)
    want_dx, want_dw = lstm_backward_plain(xproj, lens, w_hh, h, c, grad_h)
    assert (d_x - want_dx).abs().max().item() <= 1e-4
    assert (dw - want_dw).abs().max().item() <= 1e-4 * want_dw.abs().max().item()
    xp = stack_directions(xproj).contiguous()
    valid = stacked_valid(T, lens)
    gs = stack_directions(grad_h.reshape(B, T, 2, H)).contiguous()
    h7, hp, cp = lstm_recurrence_stacked(xp, valid, w_hh[0].contiguous(), w_hh[1].contiguous())
    assert torch.equal(unstack_directions(h7).reshape(B, T, 2 * H), h)
    for got, want in zip((h7, hp, cp), lstm_recurrence_stacked_plain(xp, valid, w_hh[0], w_hh[1])):
        assert (got - want).abs().max().item() <= 1e-3
    dx8, dwf, dwb = lstm_backward_stacked(xp, valid, w_hh[0].contiguous(), w_hh[1].contiguous(),
                                          hp, cp, gs)
    wdx, wf, wb = lstm_backward_stacked_plain(xp, valid, w_hh[0], w_hh[1], hp, cp, gs)
    assert (dx8 - wdx).abs().max().item() <= 1e-4
    for got, want in ((dwf, wf), (dwb, wb)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(unstack_directions(dx8), d_x) and torch.equal(dwf, dw[0]) and torch.equal(dwb, dw[1])
    assert forward_smem_on_card(H, dev) == forward_smem_bytes(H)
    assert backward_smem_on_card(H, dev) == backward_smem_bytes(H)
    assert stacked_forward_smem_on_card(H, dev) == stacked_forward_smem_bytes(H)
    assert stacked_backward_smem_on_card(H, dev) == stacked_backward_smem_bytes(H)


@pytest.mark.parametrize("D,offset", [(1, 0), (1, 1), (2, 1)])
def test_k2_h128_pair_walk_one_direction_and_copy_width_one(dev, D, offset):
    """K2's pair walk at H = 128 with one direction, and with xproj one float
    off 16-byte alignment (copies of one float), against the plain forward:
    the same bits as on an aligned copy and as a call without the cell
    output, pad frames exactly 0; the card holds its pairs."""
    H, T, lengths = 128, 40, (40, 9, 8, 7, 1, 0)
    B = len(lengths)
    g = torch.Generator().manual_seed(D + 10 * offset)
    flat = torch.randn(B * T * D * 4 * H + offset, generator=g).to(dev)
    xproj = flat[offset:].view(B, T, D, 4 * H)
    w_hh = ((torch.rand((D, 4 * H, H), generator=g) * 2 - 1) / np.sqrt(H)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    assert backward_copy_width(xproj) == (1 if offset else 4)
    h, c = lstm_recurrence(xproj, lens, w_hh, with_cell=True)
    want_h, want_c = lstm_recurrence_plain(xproj, lens, w_hh, with_cell=True)
    assert (h - want_h).abs().max().item() <= 1e-4 and (c - want_c).abs().max().item() <= 1e-3
    h4, c4 = lstm_recurrence(xproj.clone(), lens, w_hh, with_cell=True)
    assert torch.equal(h4, h) and torch.equal(c4, c)
    assert torch.equal(lstm_recurrence(xproj, lens, w_hh), h)
    for b, n in enumerate(lengths):
        assert bool((h[b, n:] == 0).all()) and bool((c[b, n:] == 0).all())
    assert forward_clusters_on_card(dev) > 0
