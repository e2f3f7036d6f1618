"""The host-side layouts of the tensor-core kernels, on the CPU: K1's tables
(``ops/frontend_kernels.py``) unpack to the plain version's, its window
range skips only zero table rows, a hop its layout cannot take is refused,
the layout read the way ``csrc/mel.cu`` reads it gives the plain log-mel
for the default config and for other mel counts, windows and hops; K9's pointwise packing (``ops/sepconv_kernels.py``)
round-trips, and every separable conv of ``QuartNet12Context`` (the three
layers ``chip_smoke.py`` times among them) fits K9's shared memory; the same
for K10's transposed packing and its bf16 kernels' shared memory; K11's
shared memory (``ops/depthwise_kernels.py``) for every block conv, and the
bf16 K11's addressing (``csrc/depthwise.cu``) replayed in numpy against the
plain weight gradient; K2's, K3's, K7's and K8's shared memory and copy
width (``ops/lstm_kernels.py``), K3's ring (``csrc/lstm_bwd.cu``) and at
H = 128 its layout, its pair walk and dW pass replayed against the plain
backward and its wrapper's argument checks, K8's
step lists, gates pass and ring, K8 at H = 128 (its layout, its pair walk
fed from the step lists, its dW pass and that pass's frame order) and K7's
walk (``csrc/lstm_bidir.cu``) replayed in numpy against the plain BiLSTM
backwards and forward, and K2's
walk (``csrc/lstm.cu``) against the plain forward; K5's ring and shared memory
(``ops/ctc_kernels.py``) for every S it takes, and its walk
(``csrc/ctc.cu``) replayed in numpy against the plain CTC beta; K4's
shared memory for every S, and its walk replayed against the plain CTC
alpha."""

import numpy as np
import pytest
import torch

from lightning_asr_torch.models.quartznet import _BLOCKS, _CONTEXT_BLOCKS
from lightning_asr_torch.ops import ctc_kernels
from lightning_asr_torch.ops.ctc import NEG_INF
from lightning_asr_torch.ops.ctc_kernels import (ALPHA_RING, BETA_RING, ctc_alpha_plain,
                                                 ctc_alpha_smem_bytes, ctc_beta_plain,
                                                 ctc_beta_ring, ctc_beta_smem_bytes, lattice)
from lightning_asr_torch.ops.depthwise_kernels import depthwise_wgrad_plain, wgrad_smem_bytes
from lightning_asr_torch.ops import frontend_kernels as fk
from lightning_asr_torch.ops.frontend import MelFrontendConfig, dft_filters, mel_filterbank
from lightning_asr_torch.ops.kernel_build import SMEM_LIMIT
from lightning_asr_torch.ops.lstm import stack_directions, stacked_valid, unstack_directions
from lightning_asr_torch.ops.lstm_kernels import (BACKWARD_RING, DW_CHUNKS, PAIR_HIDDEN,
                                                  backward_copy_width,
                                                  backward_smem_bytes, forward_smem_bytes,
                                                  lstm_backward, lstm_backward_plain,
                                                  lstm_backward_stacked_plain, lstm_recurrence_plain,
                                                  lstm_recurrence_stacked_plain,
                                                  stacked_backward_smem_bytes,
                                                  stacked_forward_smem_bytes)
from lightning_asr_torch.ops.sepconv_kernels import (bwd_smem_bytes, fwd_smem_bytes, pack_pointwise,
                                                     pack_pointwise_transposed)

CFG = MelFrontendConfig(precision="default")
# configs beside the default: 80 mels (not a multiple of 32), a 25 ms
# window (26 steps: more than the 20 a warp holds in registers), the JAX
# dual-stream model's frontend (hop 320, no pad), a window as wide as its
# 500-sample frame (the steps run past n_fft), and a 512-sample window with
# 40 mels (all 32 steps)
CONFIGS = [{}, {"n_mels": 80}, {"win_length": 400}, {"win_length": 400, "hop_length": 320, "pad": 0},
           {"n_fft": 500, "win_length": 500}, {"win_length": 512, "n_mels": 40}]
# one bf16 rounding flip of one power term, twice (see chip_smoke.py)
K1_TOL_DB = 2 * 10 * np.log10(1 + 2.0 ** -8)
# an H100 SM holds 233,472 B of shared memory and reserves 1 KB a block: the
# bf16 K9 is laid out so that two blocks share an SM at the widest layer
SM_SMEM, BLOCK_RESERVED = 233472, 1024
# static shared memory a block may use without opting in (K3's walk)
STATIC_SMEM_LIMIT = 48 * 1024
CONTEXT_IN = 256 + 2 * 40


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16).float()


@pytest.mark.parametrize("change", CONFIGS[:4], ids=str)
@pytest.mark.parametrize("table", ["dft", "filterbank"])
def test_k1_tables_unpack_to_the_plain_tables(table, change):
    cfg = MelFrontendConfig(precision="default", **change)
    wt, fbt = fk._device_tables(cfg, torch.device("cpu"))
    n_lo, K, FP, NM = fk.kernel_layout(cfg)
    F = cfg.n_freqs
    assert wt.dtype == fbt.dtype == torch.bfloat16
    if table == "dft":
        assert wt.shape == (2 * FP, K + 8)
        groups = wt.float().reshape(FP // 8, 2, 8, K + 8)           # (group, cos/-sin, bin, n)
        assert torch.all(groups[..., K:] == 0)                        # row padding
        cos, sin = (groups[:, i, :, :K].reshape(FP, K) for i in range(2))
        assert torch.all(cos[F:] == 0) and torch.all(sin[F:] == 0)   # bins past F
        full = torch.zeros((2 * F, cfg.n_fft))
        full[:F, n_lo:n_lo + K], full[F:, n_lo:n_lo + K] = cos[:F], sin[:F]
        assert torch.equal(full, _bf16(dft_filters(cfg)))
    else:
        assert fbt.shape == (NM, FP + 8) and NM % 16 == 0 and NM - 16 < cfg.n_mels <= NM
        assert torch.all(fbt[:, F:] == 0) and torch.all(fbt[cfg.n_mels:] == 0)
        assert torch.equal(fbt[:cfg.n_mels, :F].float().t(), _bf16(mel_filterbank(cfg)))


def test_k1_window_range_skips_only_zero_rows():
    n_lo, n_hi = fk.window_range(CFG)
    assert (n_lo, n_hi) == (96, 416)
    filt = dft_filters(CFG)
    assert np.all(filt[:, :n_lo] == 0) and np.all(filt[:, n_hi:] == 0)
    assert np.any(filt[:, n_lo:n_lo + 16] != 0) and np.any(filt[:, n_hi - 16:n_hi] != 0)
    assert fk.kernel_layout(CFG) == (96, 320, 272, 64)
    assert fk.smem_bytes(CFG) <= SMEM_LIMIT
    assert 2 * (fk.smem_bytes(CFG) + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("hop", [100, 168])
def test_k1_layout_refuses_what_the_kernel_cannot_take(hop):
    """A hop off the 16-sample steps: refused before any launch, while the
    plain version still runs the config on the CPU."""
    cfg = MelFrontendConfig(precision="default", hop_length=hop)
    with pytest.raises(ValueError):
        fk.kernel_layout(cfg)
    T = 5
    q = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, (T + 4) * cfg.hop_length)).astype(np.float32))
    out = fk.mel_from_extended(q, cfg, T)
    assert out.shape == (1, T, cfg.n_mels) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("change", CONFIGS, ids=str)
def test_k1_layout_read_as_the_kernel_reads_it_gives_the_plain_log_mel(change):
    """csrc/mel.cu's addressing replayed in numpy over two frame tiles (the
    second ragged): samples in hop-wide chunks from chunk t0 + n_lo // hop,
    A row t at chunk t + n // hop, offset n % hop; pass p's 32 table rows,
    cos then -sin of 8 bins for each column warp; the power of bins 16p +
    8wn + j; the mel product from the transposed filterbank, its padded
    mels dropped.  The block's shared memory fits the card."""
    cfg = MelFrontendConfig(precision="default", **change)
    n_lo, K, FP, NM = fk.kernel_layout(cfg)
    assert fk.smem_bytes(cfg) <= SMEM_LIMIT
    hop, MT = cfg.hop_length, fk._TILE_FRAMES
    wt, fbt = (t.float().numpy().astype(np.float64) for t in fk._device_tables(cfg, torch.device("cpu")))
    T = MT + 6
    q = (np.random.default_rng(1).standard_normal((1, (T + 3) * hop + 77)) * 0.1).astype(np.float32)
    qb = _bf16(q).numpy()[0].astype(np.float64)
    c_lo = n_lo // hop
    n_chunks = MT + (n_lo + K - 1) // hop - c_lo
    got = np.zeros((T, cfg.n_mels))
    for t0 in range(0, T, MT):
        chunks = np.zeros((n_chunks, hop))
        for c in range(n_chunks):
            seg = qb[(t0 + c_lo + c) * hop:(t0 + c_lo + c + 1) * hop]
            chunks[c, :len(seg)] = seg
        A = np.zeros((MT, K))
        for t in range(MT):
            for s in range(K // 16):
                n = n_lo + 16 * s
                A[t, 16 * s:16 * s + 16] = chunks[t + n // hop - c_lo, n % hop:n % hop + 16]
        power = np.zeros((MT, FP))
        for p in range(2 * FP // fk._PASS_COLS):
            tab = wt[fk._PASS_COLS * p:fk._PASS_COLS * (p + 1), :K]
            for wn in range(2):
                re, im = A @ tab[16 * wn:16 * wn + 8].T, A @ tab[16 * wn + 8:16 * wn + 16].T
                power[:, 16 * p + 8 * wn:16 * p + 8 * wn + 8] = re * re + im * im
        mel = (_bf16(power.astype(np.float32)).numpy() @ fbt[:, :FP].T)[:, :cfg.n_mels]
        n = min(MT, T - t0)
        got[t0:t0 + n] = 10 * np.log10(np.maximum(mel, cfg.amin))[:n]
    want = fk.mel_from_extended(torch.from_numpy(q), cfg, T).numpy()[0]
    assert np.abs(got - want).max() <= K1_TOL_DB


@pytest.mark.parametrize("Cout,Cin", [(512, CONTEXT_IN), (24, 40), (136, 8), (256, 256)])
def test_k9_pointwise_packing_round_trips(Cout, Cin):
    wp = torch.from_numpy(np.random.default_rng(Cin).standard_normal((Cout, Cin, 1)).astype(np.float32))
    packed = pack_pointwise(wp)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (-(-Cout // 128) * 128, -(-Cin // 32) * 32)
    assert torch.equal(packed[:Cout, :Cin], wp.reshape(Cout, Cin).to(torch.bfloat16))
    assert packed[Cout:].count_nonzero() == 0 and packed[:, Cin:].count_nonzero() == 0


@pytest.mark.parametrize("Cin,k", sorted({(cin or CONTEXT_IN, k) for _, cin, _, k in
                                          _BLOCKS + _CONTEXT_BLOCKS}))
def test_k9_shared_memory_fits_every_block_conv(Cin, k):
    smem = fwd_smem_bytes(Cin, k)
    assert smem <= SMEM_LIMIT
    assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM          # two blocks an SM


@pytest.mark.parametrize("Cout,Cin", [(512, CONTEXT_IN), (24, 40), (136, 8), (256, 256)])
def test_k10_transposed_pointwise_packing_round_trips(Cout, Cin):
    """The bf16 K10's dz operand: wp' zero-padded to whole 128 x 32 stages."""
    wp = torch.from_numpy(np.random.default_rng(Cout).standard_normal((Cout, Cin, 1)).astype(np.float32))
    packed = pack_pointwise_transposed(wp)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (-(-Cin // 128) * 128, -(-Cout // 32) * 32)
    assert torch.equal(packed[:Cin, :Cout], wp.reshape(Cout, Cin).t().to(torch.bfloat16))
    assert packed[Cin:].count_nonzero() == 0 and packed[:, Cout:].count_nonzero() == 0


@pytest.mark.parametrize("k", sorted({k for *_, k in _BLOCKS + _CONTEXT_BLOCKS}))
def test_k10_shared_memory_fits_every_block_conv(k):
    for smem in bwd_smem_bytes(k):
        assert 0 < smem <= SMEM_LIMIT
        assert 2 * (smem + BLOCK_RESERVED) <= SM_SMEM          # two blocks an SM


@pytest.mark.parametrize("k", sorted({k for *_, k in _BLOCKS + _CONTEXT_BLOCKS}))
def test_k11_shared_memory_fits_every_block_conv(k):
    for dtype in (torch.bfloat16, torch.float32):
        assert 0 < wgrad_smem_bytes(k, dtype) <= SMEM_LIMIT
    # the bf16 layout never limits the blocks an SM below its threads' 8
    assert 8 * (wgrad_smem_bytes(k, torch.bfloat16) + BLOCK_RESERVED) <= SM_SMEM


def _k11_replay(x: np.ndarray, dy: np.ndarray, k: int, V: int) -> np.ndarray:
    """The bf16 K11 of csrc/depthwise.cu on rows (R, T) of bf16 values, its
    addressing replayed: the window of a chunk staged by loads of V values,
    the chunk's array of pairs, lane (g, q)'s A fragment of each tap tile
    and step (rows: taps g, g + 8; columns: frames 2q, 2q + 1 and 2q + 8,
    2q + 9), each product rounded to bf16, every column of D the row's sum."""
    TC, STEPS = 256, 16
    R, T = x.shape
    tiles = -(-k // 16)
    WX, P = TC + 16 * tiles + 16, k // 2
    PA = -(-P // V) * V
    g, q = np.arange(32) >> 2, np.arange(32) & 3
    totals = np.zeros((R, 16 * tiles))
    for t0 in range(0, T, TC):
        xs, ys = np.zeros((R, WX), np.float32), np.zeros((R, TC), np.float32)
        for e in range(0, WX, V):                     # a load is all in or all out
            f = t0 - PA + e
            if 0 <= f < T:
                xs[:, e:e + V] = x[:, f:f + V]
        for e in range(0, TC, V):
            if t0 + e < T:
                ys[:, e:e + V] = dy[:, t0 + e:t0 + e + V]
        pw = np.stack([xs[:, :WX - 8], xs[:, 1:WX - 7]], axis=-1)   # word e: elements e, e + 1
        ns = min(STEPS, (T - t0 + 15) // 16)
        s = np.arange(ns)[:, None]                                  # (steps, lanes)
        y0 = np.stack([ys[:, 16 * s + 2 * q], ys[:, 16 * s + 2 * q + 1]], -1)
        y1 = np.stack([ys[:, 16 * s + 2 * q + 8], ys[:, 16 * s + 2 * q + 9]], -1)
        for tt in range(tiles):
            e0 = 2 * q + 16 * tt + g + (PA - P) + 16 * s
            p0, p1, p2 = pw[:, e0], pw[:, e0 + 8], pw[:, e0 + 16]   # (R, steps, lanes, 2)
            rows_g = (_bf16(p0 * y0) + _bf16(p1 * y1)).double().sum(dim=(1, 3)).numpy()
            rows_g8 = (_bf16(p1 * y0) + _bf16(p2 * y1)).double().sum(dim=(1, 3)).numpy()
            for gg in range(8):
                totals[:, 16 * tt + gg] += rows_g[:, g == gg].sum(-1)
                totals[:, 16 * tt + gg + 8] += rows_g8[:, g == gg].sum(-1)
    return totals[:, :k]


@pytest.mark.parametrize("T,k,V", [(836, 87, 4),    # the training T': 8-byte loads
                                   (5, 33, 1),      # T < P, odd T: 2-byte loads
                                   (128, 1, 8),     # one tap, 16-byte loads
                                   (257, 87, 1),    # one frame past a chunk
                                   (600, 127, 8),   # the largest k, a partial third chunk
                                   (66, 51, 2)])
def test_k11_addressing_replayed_gives_the_plain_gradient(T, k, V):
    rng = np.random.default_rng(T + k)
    x, dy = (_bf16(rng.standard_normal((3, T)).astype(np.float32)).numpy() for _ in range(2))
    got = _k11_replay(x, dy, k, V)                      # rows as channels of one batch row
    want = depthwise_wgrad_plain(torch.from_numpy(x[None]).bfloat16(),
                                 torch.from_numpy(dy[None]).bfloat16(), k)[:, 0].double().numpy()
    # the same bf16 products, summed in float64 here and in float32 there
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_k3_shared_memory_and_copy_width():
    assert backward_smem_bytes(40) == 4 * (BACKWARD_RING * 8 * 40 + 2 * 160) <= STATIC_SMEM_LIMIT
    x = torch.zeros(2 * 160 + 1)
    assert backward_copy_width(x, x[:4]) == 4                 # fresh tensors start 16-byte aligned
    assert backward_copy_width(x, x[1:]) == 1                 # a view one float in
    assert backward_copy_width(x[4:], x[160:]) == 4


class _Ring:
    """A ring of ``slots`` slots in shared memory (a walk's steps, or K8's
    list entries), its ``cp.async`` groups replayed: a slot's copies are
    views of the flat source buffers, read when a wait lets their group land
    (so a value written into a source before its copy landed would show);
    every read checks that its slot holds the step it expects and that no
    copy into it is in flight."""

    def __init__(self, width: int, slots: int = BACKWARD_RING):
        self.R = slots
        self.slots = np.full((self.R, width), np.nan)
        self.holds = [None] * self.R                     # the step a landed slot holds
        self.groups = []                                 # committed groups: [(slot, step, copies)]

    def commit(self, s=None, copies=()):                 # one group: step s's copies, or none
        self.groups.append([] if s is None else [(s % self.R, s, list(copies))])

    def wait(self, pending):                             # all but the last `pending` groups land
        for grp in self.groups[:len(self.groups) - pending]:
            for slot, s, copies in grp:
                for e, vals in copies:
                    self.slots[slot, e:e + len(vals)] = vals
                self.holds[slot] = s
            grp.clear()

    def read(self, s):
        slot = s % self.R
        assert self.holds[slot] == s, (s, self.holds)
        assert not any(sl == slot for grp in self.groups for sl, *_ in grp)   # no copy in flight
        return self.slots[slot].copy()


def _sig(v):
    return 1 / (1 + np.exp(-v))


def _factors(pre, cp, H):
    """F (4H) and A, f (2H) of one step from its pre-activations and c_prev,
    as csrc/lstm_util.cuh store_factors leaves them."""
    i, f, gg, o = _sig(pre[:H]), _sig(pre[H:2 * H]), np.tanh(pre[2 * H:3 * H]), _sig(pre[3 * H:])
    tc = np.tanh(f * cp + i * gg)
    return (np.concatenate([gg * i * (1 - i), cp * f * (1 - f), i * (1 - gg * gg), tc * o * (1 - o)]),
            np.concatenate([o * (1 - tc * tc), f]))


def _cell(slot, carry_h, carry_c, H):
    """One step of a walk's chain from its slot: the gate gradients and the
    cell's carry (csrc/lstm_util.cuh cell_backward)."""
    G = 4 * H
    F, A, f, dh_up = slot[:G], slot[G:G + H], slot[G + H:6 * H], slot[7 * H:]
    dh = dh_up + carry_h
    dc = carry_c + dh * A
    return np.concatenate([np.tile(dc, 3) * F[:3 * H], dh * F[3 * H:]]), dc * f


def _dh_prev(dg, w, H):
    """dh_prev as the unit pair's shuffles add it: the partials P_l of W_hh's
    rows (H/2)l..(H/2)(l+1)-1 as ((P0 + P4) + (P1 + P5)) + ((P2 + P6) + (P3 + P7))."""
    P = [dg[l * H // 2:(l + 1) * H // 2] @ w[l * H // 2:(l + 1) * H // 2] for l in range(8)]
    return ((P[0] + P[4]) + (P[1] + P[5])) + ((P[2] + P[6]) + (P[3] + P[7]))


def _k3_gates(xproj, lengths, w_hh, h, c):
    """K3's gates pass in float64: each valid frame's factors F into the
    d_xproj buffer (NaN elsewhere), A and f into cfac."""
    B, T, D, G = xproj.shape
    H = G // 4
    buf = np.full((B, T, D, G), np.nan)                  # d_xproj: F in, gradients out
    cfac = np.full((B, T, D, 2 * H), np.nan)
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        for d in range(D):
            for t in range(n):
                tp = t + (1 if d else -1)
                first = not 0 <= tp < n
                hp = np.zeros(H) if first else h[b, tp, d * H:(d + 1) * H].astype(np.float64)
                cp = np.zeros(H) if first else c[b, tp, d].astype(np.float64)
                buf[b, t, d], cfac[b, t, d] = _factors(xproj[b, t, d] + w_hh[d].astype(np.float64) @ hp,
                                                       cp, H)
    return buf, cfac


def _k3_replay(xproj, lengths, w_hh, h, c, grad_h, V):
    """K3 of csrc/lstm_bwd.cu in float64, its layout and schedule replayed.
    The gates pass: each valid frame's factors F into the d_xproj buffer, A
    and f into cfac.  The walk: each step's inputs copied V floats at a time
    from the flat buffers into the ring (``_Ring``); the gate gradients in
    two buffers."""
    B, T, D, G = xproj.shape
    H, R = G // 4, BACKWARD_RING
    buf, cfac = _k3_gates(xproj, lengths, w_hh, h, c)
    bf, cf, hf, gf = buf.reshape(-1), cfac.reshape(-1), h.astype(np.float64).ravel(), \
        grad_h.astype(np.float64).ravel()
    dw = np.zeros((B, D, G, H))
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        buf[b, n:] = 0                                   # pad frames
        for d in range(D):
            w = w_hh[d].astype(np.float64)
            ring = _Ring(8 * H)

            def copies(s):
                t = s if d else n - 1 - s
                tp, last = t + (1 if d else -1), s == n - 1
                out = []
                for e in range(0, 8 * H, V):
                    if e < G:
                        src = ((b * T + t) * D + d) * G + e
                        out.append((e, bf[src:src + V]))
                    elif e < 6 * H:
                        src = ((b * T + t) * D + d) * 2 * H + e - G
                        out.append((e, cf[src:src + V]))
                    elif e < 7 * H:
                        src = ((b * T + tp) * D + d) * H + e - 6 * H
                        out.append((e, np.zeros(V) if last else hf[src:src + V]))
                    else:
                        src = ((b * T + t) * D + d) * H + e - 7 * H
                        out.append((e, gf[src:src + V]))
                return out

            for s in range(R - 1):
                ring.commit(*((s, copies(s)) if s < n else ()))
            if n == 0:
                continue
            ring.wait(R - 2)
            dgv, carry_c = _cell(ring.read(0), 0.0, 0.0, H)
            dg_s = [(0, dgv), None]                      # (step, gradients) in each buffer
            for s in range(n):
                ring.wait(R - 3)
                t = s if d else n - 1 - s
                buf[b, t, d] = dgv
                dw[b, d] += np.outer(dgv, ring.read(s)[6 * H:7 * H])
                if s + 1 < n:
                    step, dg = dg_s[s & 1]
                    assert step == s
                    dgv, carry_c = _cell(ring.read(s + 1), _dh_prev(dg, w, H), carry_c, H)
                    dg_s[(s + 1) & 1] = (s + 1, dgv)
                ring.commit(*((s + R - 1, copies(s + R - 1)) if s + R - 1 < n else ()))
    return buf, dw.sum(axis=0)


@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("D,T,lengths", [(2, 20, [20, 0, 1, 2, 3, 7]),   # below the ring, 0 and 1
                                         (1, 20, [8, 9, 17, 20]),      # at it and off its multiples
                                         (2, 33, [33, 16, 25])])
def test_k3_ring_replayed_gives_the_plain_gradient(D, T, lengths, V):
    rng = np.random.default_rng(T + len(lengths) + D)
    H, B = 40, len(lengths)
    xproj = rng.standard_normal((B, T, D, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (D, 4 * H, H)) / np.sqrt(H)).astype(np.float32)
    grad_h = rng.standard_normal((B, T, D * H)).astype(np.float32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    hs, cs = lstm_recurrence_plain(torch.from_numpy(xproj), lens, torch.from_numpy(w_hh),
                                   with_cell=True)
    got_dx, got_dw = _k3_replay(xproj, lengths, w_hh, hs.numpy(), cs.numpy(), grad_h, V)
    want_dx, want_dw = lstm_backward_plain(torch.from_numpy(xproj), lens, torch.from_numpy(w_hh),
                                           hs, cs, torch.from_numpy(grad_h))
    # float64 here, float32 there, through at most 33 steps
    assert np.abs(got_dx - want_dx.double().numpy()).max() <= 1e-5
    assert np.abs(got_dw - want_dw.double().numpy()).max() <= 1e-5 * max(1.0, want_dw.abs().max())
    for b, n in enumerate(lengths):
        assert np.all(got_dx[b, n:] == 0)


def test_k3_h128_shared_memory_and_chunks():
    """K3's layout at the LSTM head's H = 128: a CTA of the pair stages 448
    floats a step (F of its 256 gates, A, f and grad_h of its 64 units) and
    holds all 512 gate gradients of two steps; H = 40's one-block layout is
    unchanged, and K8's pair CTA at H = 128 is K3's with its list ring."""
    H, U = PAIR_HIDDEN, PAIR_HIDDEN // 2
    assert backward_smem_bytes(H) == 4 * (BACKWARD_RING * 7 * U + 2 * 4 * H) == 18432 \
        <= STATIC_SMEM_LIMIT
    assert backward_smem_bytes(40) == 11520
    assert stacked_backward_smem_bytes(H) == 4 * (BACKWARD_RING * 7 * U + 2 * 4 * H) \
        + 4 * 2 * BACKWARD_RING == 18496
    # every staged segment is whole in V-float copies; 448 copies of one float fit 512 threads
    assert U % 4 == 0 and 7 * U <= 512
    # a dW chunk's partial tile (128 x 64 floats) holds the two copy stages (16 frames of 128 + 64)
    assert 2 * 16 * (128 + 64) <= 128 * 64 and 128 % DW_CHUNKS == 0 and 128 // DW_CHUNKS * 16 == 256


@pytest.mark.parametrize("bad", ["h_shape", "c_shape", "grad_h_dtype", "lengths_dtype", "w_hh_shape",
                                 "h_strided"])
def test_k3_h128_wrapper_refuses_what_the_kernels_cannot_take(bad):
    """``lstm_backward``'s checks at H = 128 (the pair walk and the dW pass
    read h, c and grad_h as contiguous float32 of the stated shapes): each
    wrong argument raises before any launch, on the CPU as on the card."""
    B, T, D, H = 2, 5, 2, PAIR_HIDDEN
    args = {"xproj": torch.zeros((B, T, D, 4 * H)), "lengths": torch.full((B,), T, dtype=torch.int32),
            "w_hh": torch.zeros((D, 4 * H, H)), "h": torch.zeros((B, T, D * H)),
            "c": torch.zeros((B, T, D, H)), "grad_h": torch.zeros((B, T, D * H))}
    args.update({"h_shape": {"h": torch.zeros((B, T, D * H + 4))},
                 "c_shape": {"c": torch.zeros((B, T, D * H))},
                 "grad_h_dtype": {"grad_h": torch.zeros((B, T, D * H), dtype=torch.float64)},
                 "lengths_dtype": {"lengths": torch.full((B,), T, dtype=torch.int64)},
                 "w_hh_shape": {"w_hh": torch.zeros((D, 4 * H, H + 4))},
                 "h_strided": {"h": torch.zeros((B, T, 2 * D * H))[..., ::2]}}[bad])
    before = lstm_backward.launches
    with pytest.raises(ValueError):
        lstm_backward(**args)
    assert lstm_backward.launches == before


def _pair_walk(buf, cfac, lengths, w_hh, grad_h, V):
    """The H = 128 walk of csrc/lstm_bwd.cu (lstm_bwd_pair_kernel) in
    float64: for each (row, direction) two CTAs r, each a ring of its 448
    floats a step copied V at a time from the flat buffers (``_Ring``); lane
    L of warp w holds W_hh[iH + 4L + e, rU + 4w + u]; the lanes' products
    with the step's 512 gradients summed over the warp land on unit (L >> 3)
    & 3; lane (kk, m) steps the cell and lanes L & 4 == 0 publish gate m of
    unit kk into both CTAs' buffers.  Writes the gradients into ``buf``."""
    B, T, D, G = buf.shape
    H, R = G // 4, BACKWARD_RING
    U = H // 2
    bf, cf, gf = buf.reshape(-1).copy(), cfac.reshape(-1), grad_h.astype(np.float64).ravel()
    lane = np.arange(32)
    kk = 4 * np.arange(16)[:, None] + (lane >> 3) % 4               # (warp, lane)
    m = np.broadcast_to(lane % 4, kk.shape)
    writer = np.broadcast_to(lane % 8 < 4, kk.shape)
    i, e, u = np.arange(4)[:, None, None], np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        buf[b, n:] = 0                                               # pad frames, both CTAs
        for d in range(D):
            w = w_hh[d].astype(np.float64)
            # wd[r][warp, lane, i, e, u]
            wd = [w[(i * H + 4 * lane[:, None, None, None] + e)[None],
                    r * U + 4 * np.arange(16)[:, None, None, None, None] + u] for r in range(2)]
            rings = [_Ring(7 * U), _Ring(7 * U)]

            def copies(r, s):
                t = s if d else n - 1 - s
                out = []
                for o in range(0, 7 * U, V):
                    seg, off = o // U, r * U + o % U
                    if seg < 4:
                        src = ((b * T + t) * D + d) * G + seg * H + off
                        out.append((o, bf[src:src + V]))
                    elif seg < 6:
                        src = ((b * T + t) * D + d) * 2 * H + (seg - 4) * H + off
                        out.append((o, cf[src:src + V]))
                    else:
                        src = (b * T + t) * D * H + d * H + off
                        out.append((o, gf[src:src + V]))
                return out

            def cell(slot, carry_h, carry_c):                        # every lane of the CTA
                dh = slot[6 * U + kk] + carry_h
                dc = carry_c + dh * slot[4 * U + kk]
                return np.where(m == 3, dh, dc) * slot[m * U + kk], dc * slot[5 * U + kk]

            def publish(dg, r, grads):                              # writers, into a CTA's buffer
                dg[m[writer] * H + r * U + kk[writer]] = grads[writer]

            for s in range(R - 1):
                for r in range(2):
                    rings[r].commit(*((s, copies(r, s)) if s < n else ()))
            if n == 0:
                continue
            carry_c = [np.zeros(kk.shape), np.zeros(kk.shape)]
            dg_s = [[np.full(G, np.nan), np.full(G, np.nan)] for _ in range(2)]   # [CTA][buffer]
            grads = [None, None]
            for r in range(2):
                rings[r].wait(R - 2)
                grads[r], carry_c[r] = cell(rings[r].read(0), 0.0, carry_c[r])
                for dst in range(2):
                    publish(dg_s[dst][0], r, grads[r])
            for s in range(n):
                for r in range(2):
                    rings[r].wait(R - 3)
                t = s if d else n - 1 - s
                for r in range(2):
                    buf[b, t, d, m[writer] * H + r * U + kk[writer]] = grads[r][writer]
                if s + 1 < n:
                    new = []
                    for r in range(2):
                        dg = dg_s[r][s & 1]
                        assert not np.isnan(dg).any()                # both halves landed
                        P = np.einsum("lie,wlieu->wlu", dg.reshape(4, 32, 4).transpose(1, 0, 2), wd[r])
                        dh = np.take_along_axis(P.sum(axis=1), (lane >> 3)[None, :] % 4, axis=1)
                        g_new, carry_c[r] = cell(rings[r].read(s + 1), dh, carry_c[r])
                        new.append(g_new)
                    for dst in range(2):
                        dg_s[dst][(s + 1) & 1][:] = np.nan          # step s - 1's, read by nobody now
                    for r in range(2):
                        grads[r] = new[r]
                        for dst in range(2):
                            publish(dg_s[dst][(s + 1) & 1], r, grads[r])
                for r in range(2):
                    rings[r].commit(*((s + R - 1, copies(r, s + R - 1)) if s + R - 1 < n else ()))
    return buf


def _dw_chunks(lens, frame, KB=16):
    """The H = 128 dW pass's sum over one direction's frames in float64
    (csrc/lstm_pair.cuh pair_dw_tile): the frames of all rows in order
    (row bb, then frame tt < lens[bb]) cut into ``DW_CHUNKS`` chunks
    [N c / C, N (c + 1) / C); thread f of a chunk's copies walks frame
    lo + f + KB k (skipping whole rows), zeros past the chunk; ``frame(bb,
    tt)`` gives the frame's gate gradients and h_prev; the chunks' partials
    summed in chunk order."""
    B, N = len(lens), sum(lens)
    total = None
    for c in range(DW_CHUNKS):
        lo, hi = N * c // DW_CHUNKS, N * (c + 1) // DW_CHUNKS
        part = 0.0
        cursors = []
        for f in range(KB):                                          # (n, bb, tt) of thread f
            n, bb, tt = lo + f, 0, lo + f
            while bb < B and tt >= lens[bb]:
                tt -= lens[bb]
                bb += 1
            cursors.append([n, bb, tt])
        for _ in range(-(-(hi - lo) // KB)):
            for cur in cursors:
                n, bb, tt = cur
                if n < hi:
                    part = part + np.outer(*frame(bb, tt))
                n, tt = n + KB, tt + KB
                while bb < B and tt >= lens[bb]:
                    tt -= lens[bb]
                    bb += 1
                cur[:] = [n, bb, tt]
        total = part if total is None else total + part
    return total


def _dw_pass(buf, lengths, h):
    """The H = 128 dW pass of csrc/lstm_bwd.cu (lstm_bwd_dw_kernel) in
    float64: ``_dw_chunks`` over each direction's valid frames, h_prev of
    frame t the h at t + dir, zeros where that leaves the row."""
    B, T, D, G = buf.shape
    H = G // 4
    lens = [max(0, min(int(x), T)) for x in lengths]
    dw = np.zeros((D, G, H))
    for d in range(D):
        dirn = 1 if d else -1

        def frame(bb, tt):
            hp = h[bb, tt + dirn, d * H:(d + 1) * H].astype(np.float64) if 0 <= tt + dirn < lens[bb] \
                else np.zeros(H)
            return buf[bb, tt, d], hp

        dw[d] = _dw_chunks(lens, frame)
    return dw


@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("D,T,lengths", [(2, 20, [20, 0, 1, 2, 3, 7]),   # below the ring, 0 and 1
                                         (1, 20, [8, 9, 17, 20]),      # at it and off its multiples
                                         (2, 33, [0, 33, 16, 0, 25])])  # empty rows between chunks
def test_k3_h128_pair_walk_and_dw_pass_replayed_give_the_plain_gradient(D, T, lengths, V):
    """K3 at the LSTM head's H = 128: the gates pass, the pair walk and the
    dW pass replayed in numpy against the plain backward."""
    rng = np.random.default_rng(T + len(lengths) + D + 128)
    H, B = PAIR_HIDDEN, len(lengths)
    xproj = rng.standard_normal((B, T, D, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (D, 4 * H, H)) / np.sqrt(H)).astype(np.float32)
    grad_h = rng.standard_normal((B, T, D * H)).astype(np.float32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    hs, cs = lstm_recurrence_plain(torch.from_numpy(xproj), lens, torch.from_numpy(w_hh),
                                   with_cell=True)
    buf, cfac = _k3_gates(xproj, lengths, w_hh, hs.numpy(), cs.numpy())
    got_dx = _pair_walk(buf, cfac, lengths, w_hh, grad_h, V)
    got_dw = _dw_pass(got_dx, lengths, hs.numpy())
    want_dx, want_dw = lstm_backward_plain(torch.from_numpy(xproj), lens, torch.from_numpy(w_hh),
                                           hs, cs, torch.from_numpy(grad_h))
    # float64 here, float32 there, through at most 33 steps
    assert np.abs(got_dx - want_dx.double().numpy()).max() <= 1e-5
    assert np.abs(got_dw - want_dw.double().numpy()).max() <= 1e-5 * max(1.0, want_dw.abs().max())
    for b, n in enumerate(lengths):
        assert np.all(got_dx[b, n:] == 0)


def test_k8_shared_memory_and_copy_width():
    """K8's walk has K3's ring and slot layout and a ring of 2
    ``BACKWARD_RING`` step-list entries; each (t, row) slice it stages (F
    4H, A and f 2H, h_prev and grad_h H floats) starts a multiple of 4
    floats from its tensor's start, so the starts decide its copy width."""
    T, B2, H = 7, 6, 40
    assert stacked_backward_smem_bytes(H) == backward_smem_bytes(H) + 4 * 2 * BACKWARD_RING \
        <= STATIC_SMEM_LIMIT
    assert all(width % 4 == 0 for width in (4 * H, 2 * H, H))
    h_prev, grad_h = torch.zeros((T, B2, H)), torch.zeros((T, B2, H))
    d_xproj, cfac = torch.zeros((T, B2, 4 * H)), torch.zeros((T, B2, 2 * H))
    assert backward_copy_width(h_prev, grad_h, d_xproj, cfac) == 4
    off = torch.zeros(T * B2 * H + 1)[1:].view(T, B2, H)      # grad_h.contiguous() one float in
    assert backward_copy_width(h_prev, off, d_xproj, cfac) == 1


def _k8_steps(valid):
    """csrc/lstm_bidir.cu's step lists replayed: a warp a row, lane j of a
    chunk at t = t0 - j, each valid step placed at the row's count so far
    plus the valid lanes below it (``__ballot_sync``, ``__popc``); entries
    past the count stay unwritten (-1)."""
    T, B2 = valid.shape
    steps, counts = np.full((B2, T), -1), np.zeros(B2, dtype=int)
    for row in range(B2):
        n = 0
        for t0 in range(T - 1, -1, -32):
            lanes = [t0 - j >= 0 and valid[t0 - j, row] > 0 for j in range(32)]
            vote = sum(1 << j for j, v in enumerate(lanes) if v)
            for j, v in enumerate(lanes):
                if v:
                    steps[row, n + bin(vote & ((1 << j) - 1)).count("1")] = t0 - j
            n += bin(vote).count("1")
        counts[row] = n
    return steps, counts


def _k8_gates(xproj, valid, w_f, w_b, h_prev, c_prev):
    """K8's gates pass in float64: each valid step's factors F into the
    d_xproj buffer and A and f into cfac, exact zeros into d_xproj at the
    invalid steps; cfac there stays NaN, so a walk that read it would show."""
    T, B2, G = xproj.shape
    B, H = B2 // 2, G // 4
    buf = np.full((T, B2, G), np.nan)                    # d_xproj: F in, gradients out
    cfac = np.full((T, B2, 2 * H), np.nan)
    for t in range(T):
        for row in range(B2):
            if valid[t, row] > 0:
                w = (w_f if row < B else w_b).astype(np.float64)
                buf[t, row], cfac[t, row] = _factors(xproj[t, row] + w @ h_prev[t, row], c_prev[t, row], H)
            else:
                buf[t, row] = 0
    return buf, cfac


def _k8_replay(xproj, valid, w_f, w_b, h_prev, c_prev, grad_h, V):
    """K8 of csrc/lstm_bidir.cu in float64, its layout and schedule replayed.
    The step lists (``_k8_steps``).  The gates pass: each valid step's
    factors F into the d_xproj buffer and A and f into cfac, exact zeros
    into d_xproj at the invalid steps; cfac there stays NaN, so a walk that
    read it would show.  The walk, one per stacked row: each listed step's
    inputs copied V floats at a time into the ring (``_Ring``) from step
    list[s]; the list entries in a ring of their own (2 ``BACKWARD_RING``
    slots), the first 2 ``BACKWARD_RING`` - 1 read before the walk, each
    later one copied in a step's group, and each iteration reading the next
    one's entries (an entry past the list is never used)."""
    T, B2, G = xproj.shape
    B, H, R = B2 // 2, G // 4, BACKWARD_RING
    LR = 2 * R
    steps, counts = _k8_steps(valid)
    buf, cfac = _k8_gates(xproj, valid, w_f, w_b, h_prev, c_prev)
    flats = [(buf.reshape(-1), G, 0), (cfac.reshape(-1), 2 * H, G),
             (h_prev.astype(np.float64).ravel(), H, 6 * H), (grad_h.astype(np.float64).ravel(), H, 7 * H)]
    dw = np.zeros((B2, G, H))
    for row in range(B2):
        n, lst = counts[row], steps[row].astype(np.float64)
        w = (w_f if row < B else w_b).astype(np.float64)
        ring, lring = _Ring(8 * H), _Ring(1, LR)

        def copies(t):
            t = int(t)
            assert 0 <= t < T and valid[t, row] > 0, (row, t)
            out = []
            for e in range(0, 8 * H, V):
                flat, width, lo = next(f for f in reversed(flats) if e >= f[2])
                src = (t * B2 + row) * width + e - lo
                out.append((e, flat[src:src + V]))
            return out

        def commit(s, t):                                # iteration s's group: step s + R - 1, entry s + LR - 1
            ring.commit(s + R - 1, copies(t))
            lring.commit(*((s + LR - 1, [(0, lst[s + LR - 1:s + LR])]) if s + LR - 1 < T else ()))

        for e in range(min(T, LR - 1)):                  # read before the walk
            lring.slots[e], lring.holds[e] = lst[e], e
        for s in range(R - 1):
            ring.commit(*((s, copies(lring.read(s)[0])) if s < n else ()))
            lring.commit()
        if n == 0:
            continue
        ring.wait(R - 2)
        lring.wait(R - 2)
        dgv, carry_c = _cell(ring.read(0), 0.0, 0.0, H)
        dg_s = [(0, dgv), None]                          # (step, gradients) in each buffer
        t_dx = int(lring.read(0)[0])
        t_st = lring.read(R - 1)[0] if R - 1 < n else None
        for s in range(n):
            ring.wait(R - 3)
            lring.wait(R - 3)
            t_dx_next = int(lring.read(s + 1)[0]) if s + 1 < n else None
            t_st_next = lring.read(s + R)[0] if s + R < n else None
            buf[t_dx, row] = dgv
            dw[row] += np.outer(dgv, ring.read(s)[6 * H:7 * H])
            step, dg = dg_s[s & 1]
            assert step == s
            if s + 1 < n:
                dgv, carry_c = _cell(ring.read(s + 1), _dh_prev(dg, w, H), carry_c, H)
                dg_s[(s + 1) & 1] = (s + 1, dgv)
            if s + R - 1 < n:
                commit(s, t_st)
            else:
                ring.commit()
                lring.commit()
            t_dx, t_st = t_dx_next, t_st_next
    return buf, dw[:B].sum(axis=0), dw[B:].sum(axis=0)


# stacked rows from lengths (forward rows valid at t < len, reverse rows at
# T-1-t < len), or a random 0/1 mask with holes; lengths 0, 1 and around the
# ring's 8 slots, T below the ring, off its multiples and off a gates
# block's 32 steps
K8_REPLAY_CASES = [(20, [0, 1, 7, 8, 9, 20], False), (5, [5, 0, 2], False),
                   (33, [33, 16, 25, 9], False), (45, [45, 45, 45], True), (70, [70, 3], True)]


@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("T,lengths,random_mask", K8_REPLAY_CASES)
def test_k8_schedule_replayed_gives_the_plain_gradient(T, lengths, random_mask, V):
    rng = np.random.default_rng(T + len(lengths))
    H, B = 40, len(lengths)
    xproj = rng.standard_normal((T, 2 * B, 4 * H)).astype(np.float32)
    w_f, w_b = ((rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32) for _ in range(2))
    grad_h = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    lens, t = np.array(lengths), np.arange(T)[:, None]
    valid = np.concatenate([t < lens[None], T - 1 - t < lens[None]], axis=1).astype(np.float32)
    if random_mask:
        valid = (rng.uniform(size=(T, 2 * B)) < 0.7).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xproj, valid, w_f, w_b)]
    _, h_prev, c_prev = lstm_recurrence_stacked_plain(*args)
    got_dx, got_f, got_b = _k8_replay(xproj, valid, w_f, w_b, h_prev.numpy(), c_prev.numpy(), grad_h, V)
    want_dx, want_f, want_b = lstm_backward_stacked_plain(*args, h_prev, c_prev, torch.from_numpy(grad_h))
    # float64 here, float32 there, through at most 70 steps
    assert np.abs(got_dx - want_dx.double().numpy()).max() <= 1e-5
    for got, want in ((got_f, want_f), (got_b, want_b)):
        assert np.abs(got - want.double().numpy()).max() <= 1e-5 * max(1.0, want.abs().max())
    assert np.all(got_dx[valid <= 0] == 0)


def test_k8_h128_shared_memory():
    """K8's layout at the LSTM head's H = 128: a CTA of the pair walk holds
    K3's pair ring and gate gradients and the list ring of 2
    ``BACKWARD_RING`` entries; H = 40's one-block layout is unchanged."""
    H = PAIR_HIDDEN
    assert stacked_backward_smem_bytes(H) == backward_smem_bytes(H) + 4 * 2 * BACKWARD_RING == 18496 \
        <= STATIC_SMEM_LIMIT
    assert stacked_backward_smem_bytes(40) == 4 * (BACKWARD_RING * 8 * 40 + 2 * 160) \
        + 4 * 2 * BACKWARD_RING == 11584


def _k8_dw_frame(steps, counts, d, bb, tt):
    """(stacked row, t) of frame tt of direction d's row bb in K8's dW pass at
    H = 128: the row's listed steps in original time, so a forward row's
    list (t descending) is read from its end and a reverse row's (stacked t
    descending is original t ascending) as it is."""
    row = d * (len(counts) // 2) + bb
    return row, int(steps[row, counts[row] - 1 - tt] if d == 0 else steps[row, tt])


def _k8_pair_walk(buf, cfac, valid, w_f, w_b, grad_h, V):
    """K8's H = 128 walk of csrc/lstm_bidir.cu (lstm_stacked_bwd_pair_kernel)
    in float64: _pair_walk's two CTAs a stacked row, each a ring of its 448
    floats a step copied V at a time from listed step list[s] (``_Ring``,
    reading the d_xproj buffer as the walk rewrites it) and a list ring of 2
    ``BACKWARD_RING`` entries (the first 2 ``BACKWARD_RING`` - 1 read before
    the walk, each later one copied in a step's group, each iteration
    reading the next one's entries).  Between two cluster barriers the CTAs
    run one after the other, in turns, so that a gate-gradient buffer
    published before its owner had read the step it held would show; each
    buffer records the step it holds.  Writes the gradients into ``buf``."""
    T, B2, G = buf.shape
    B, H, R = B2 // 2, G // 4, BACKWARD_RING
    U, LR = H // 2, 2 * R
    steps, counts = _k8_steps(valid)
    bf, cf, gf = buf.reshape(-1), cfac.reshape(-1), grad_h.astype(np.float64).ravel()
    lane = np.arange(32)
    kk = 4 * np.arange(16)[:, None] + (lane >> 3) % 4               # (warp, lane)
    m = np.broadcast_to(lane % 4, kk.shape)
    writer = np.broadcast_to(lane % 8 < 4, kk.shape)
    i, e, u = np.arange(4)[:, None, None], np.arange(4)[None, :, None], np.arange(4)[None, None, :]
    for row in range(B2):
        n, lst = counts[row], steps[row].astype(np.float64)
        w = (w_f if row < B else w_b).astype(np.float64)
        wd = [w[(i * H + 4 * lane[:, None, None, None] + e)[None],
                r * U + 4 * np.arange(16)[:, None, None, None, None] + u] for r in range(2)]
        rings, lrings = [_Ring(7 * U), _Ring(7 * U)], [_Ring(1, LR), _Ring(1, LR)]

        def copies(r, t):
            t = int(t)
            assert 0 <= t < T and valid[t, row] > 0, (row, t)
            out = []
            for o in range(0, 7 * U, V):
                seg, off = o // U, r * U + o % U
                if seg < 4:
                    src = (t * B2 + row) * G + seg * H + off
                    out.append((o, bf[src:src + V]))
                elif seg < 6:
                    src = (t * B2 + row) * 2 * H + (seg - 4) * H + off
                    out.append((o, cf[src:src + V]))
                else:
                    src = (t * B2 + row) * H + off
                    out.append((o, gf[src:src + V]))
            return out

        def cell(slot, carry_h, carry_c):                            # every lane of the CTA
            dh = slot[6 * U + kk] + carry_h
            dc = carry_c + dh * slot[4 * U + kk]
            return np.where(m == 3, dh, dc) * slot[m * U + kk], dc * slot[5 * U + kk]

        # dg[CTA][buffer] = [step held, its 4H gradients]; the first writer
        # of a step into a buffer finds the step before last there, read
        def publish(s, r, grads):
            for dst in range(2):
                held = dg[dst][s & 1]
                if held[0] != s:
                    assert held[0] is None or held[0] == s - 2 and read[dst] >= s - 2, (s, held[0])
                    held[0], held[1] = s, np.full(G, np.nan)
                held[1][m[writer] * H + r * U + kk[writer]] = grads[writer]

        for r in range(2):
            for k in range(min(T, LR - 1)):                          # read before the walk
                lrings[r].slots[k], lrings[r].holds[k] = lst[k], k
        for s in range(R - 1):
            for r in range(2):
                rings[r].commit(*((s, copies(r, lrings[r].read(s)[0])) if s < n else ()))
                lrings[r].commit()
        if n == 0:
            continue
        carry_c = [np.zeros(kk.shape), np.zeros(kk.shape)]
        dg = [[[None, None], [None, None]] for _ in range(2)]
        read = [-1, -1]                                              # the last step a CTA read
        grads = [None, None]
        t_dx, t_st = [None, None], [None, None]
        for r in range(2):
            rings[r].wait(R - 2)
            lrings[r].wait(R - 2)
            grads[r], carry_c[r] = cell(rings[r].read(0), 0.0, carry_c[r])
            publish(0, r, grads[r])
            t_dx[r] = int(lrings[r].read(0)[0])
            t_st[r] = lrings[r].read(R - 1)[0] if R - 1 < n else None
        for s in range(n):
            for r in range(2):
                rings[r].wait(R - 3)
                lrings[r].wait(R - 3)
            # the cluster barrier; then each CTA's iteration, in turns
            for r in ((0, 1) if s % 2 == 0 else (1, 0)):
                t_dx_next = int(lrings[r].read(s + 1)[0]) if s + 1 < n else None
                t_st_next = lrings[r].read(s + R)[0] if s + R < n else None
                buf[t_dx[r], row, m[writer] * H + r * U + kk[writer]] = grads[r][writer]
                if s + 1 < n:
                    step, dgs = dg[r][s & 1]
                    assert step == s and not np.isnan(dgs).any()     # both halves landed
                    read[r] = s
                    P = np.einsum("lie,wlieu->wlu", dgs.reshape(4, 32, 4).transpose(1, 0, 2), wd[r])
                    dh = np.take_along_axis(P.sum(axis=1), (lane >> 3)[None, :] % 4, axis=1)
                    grads[r], carry_c[r] = cell(rings[r].read(s + 1), dh, carry_c[r])
                    publish(s + 1, r, grads[r])
                if s + R - 1 < n:
                    rings[r].commit(s + R - 1, copies(r, t_st[r]))
                    lrings[r].commit(*((s + LR - 1, [(0, lst[s + LR - 1:s + LR])]) if s + LR - 1 < T
                                       else ()))
                else:
                    rings[r].commit()
                    lrings[r].commit()
                t_dx[r], t_st[r] = t_dx_next, t_st_next
    return buf


def _k8_dw_pass(buf, valid, h_prev):
    """K8's H = 128 dW pass of csrc/lstm_bidir.cu (lstm_stacked_bwd_dw_kernel)
    in float64: ``_dw_chunks`` over each direction's B rows and their listed
    steps (``_k8_dw_frame``), h_prev read at the frame's own (t, row)."""
    T, B2, G = buf.shape
    B = B2 // 2
    steps, counts = _k8_steps(valid)

    def frame(d, bb, tt):
        row, t = _k8_dw_frame(steps, counts, d, bb, tt)
        assert valid[t, row] > 0 and not np.isnan(buf[t, row]).any()
        return buf[t, row], h_prev[t, row].astype(np.float64)

    dw = np.zeros((2, G, G // 4))
    for d in range(2):
        dw[d] = _dw_chunks([int(x) for x in counts[d * B:(d + 1) * B]],
                           lambda bb, tt, d=d: frame(d, bb, tt))
    return dw


@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("T,lengths,random_mask", [(20, [0, 1, 7, 8, 9, 20], False),
                                                   (45, [45, 45], True)])
def test_k8_h128_pair_walk_and_dw_pass_replayed_give_the_plain_gradient(T, lengths, random_mask, V):
    """K8 at the LSTM head's H = 128: the step lists, the gates pass, the
    pair walk and the dW pass replayed in numpy against the plain backward,
    on stacked rows from lengths (0, 1, around the ring's 8 slots, T) and on
    a random mask with holes."""
    rng = np.random.default_rng(T + len(lengths) + 128)
    H, B = PAIR_HIDDEN, len(lengths)
    xproj = rng.standard_normal((T, 2 * B, 4 * H)).astype(np.float32)
    w_f, w_b = ((rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32) for _ in range(2))
    grad_h = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    lens, t = np.array(lengths), np.arange(T)[:, None]
    valid = np.concatenate([t < lens[None], T - 1 - t < lens[None]], axis=1).astype(np.float32)
    if random_mask:
        valid = (rng.uniform(size=(T, 2 * B)) < 0.7).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xproj, valid, w_f, w_b)]
    _, h_prev, c_prev = lstm_recurrence_stacked_plain(*args)
    buf, cfac = _k8_gates(xproj, valid, w_f, w_b, h_prev.numpy(), c_prev.numpy())
    got_dx = _k8_pair_walk(buf, cfac, valid, w_f, w_b, grad_h, V)
    got_dw = _k8_dw_pass(got_dx, valid, h_prev.numpy())
    want_dx, want_f, want_b = lstm_backward_stacked_plain(*args, h_prev, c_prev, torch.from_numpy(grad_h))
    # float64 here, float32 there, through at most 45 steps
    assert np.abs(got_dx - want_dx.double().numpy()).max() <= 1e-5
    for got, want in ((got_dw[0], want_f), (got_dw[1], want_b)):
        assert np.abs(got - want.double().numpy()).max() <= 1e-5 * max(1.0, want.abs().max())
    assert np.all(got_dx[valid <= 0] == 0)


@pytest.mark.parametrize("T,lengths", [(20, [0, 1, 7, 8, 9, 20]), (33, [33, 16, 25, 9])])
def test_k8_h128_dw_frames_in_k3_order(T, lengths):
    """On a contiguous mask, the frames of K8's H = 128 dW pass, unstacked,
    are K3's frames in K3's order (row, then time ascending) and each row
    has K3's count, so the chunks and each tile's sums are K3's."""
    B = len(lengths)
    lens, t = np.array(lengths), np.arange(T)[:, None]
    valid = np.concatenate([t < lens[None], T - 1 - t < lens[None]], axis=1).astype(np.float32)
    steps, counts = _k8_steps(valid)
    assert list(counts) == lengths + lengths
    for d in range(2):
        got = [_k8_dw_frame(steps, counts, d, bb, tt) for bb in range(B) for tt in range(counts[d * B + bb])]
        unstacked = [(row - d * B, t if d == 0 else T - 1 - t) for row, t in got]
        assert unstacked == [(b, t) for b in range(B) for t in range(lengths[b])]


def test_k7_shared_memory_and_copy_width():
    """K7's walk: a ring of ``BACKWARD_RING`` slots of one step's 4H
    projections, h of two steps and K8's list ring of 2 ``BACKWARD_RING``
    entries; each (t, row) slice of xproj it stages starts a multiple of 4
    floats from the tensor's start, so the start decides its copy width."""
    T, B2, H = 7, 6, 40
    assert stacked_forward_smem_bytes(H) == 4 * (BACKWARD_RING * 4 * H + 2 * H + 2 * BACKWARD_RING) \
        == 5504 <= STATIC_SMEM_LIMIT
    xproj = torch.zeros((T, B2, 4 * H))
    assert backward_copy_width(xproj) == 4
    assert backward_copy_width(torch.zeros(T * B2 * 4 * H + 1)[1:].view(T, B2, 4 * H)) == 1


def _k7_replay(xproj, valid, w_f, w_b, V):
    """K7 of csrc/lstm_bidir.cu in float64, its schedule replayed.  The step
    lists (``_k8_steps``, t descending), read from the end.  The walk, one
    per stacked row: each listed step's projection copied V floats at a
    time into the ring (``_Ring``), ``BACKWARD_RING - 1`` steps ahead; the
    list entries in a ring of their own (2 ``BACKWARD_RING`` slots), the
    first 2 ``BACKWARD_RING`` - 1 read before the walk and each later one
    copied in a step's group, ``BACKWARD_RING`` iterations before it is
    read, and each step's copies issued after its h; lane 4k + m's
    activation of gate m of unit k, the quad's four taken by each of its
    lanes, h in two buffers; the gap after each valid step, then the steps
    before the first, written outside the walk.  The
    outputs start as NaN, so a step nobody writes would show."""
    T, B2, G = xproj.shape
    B, H, R = B2 // 2, G // 4, BACKWARD_RING
    LR = 2 * R
    steps, counts = _k8_steps(valid)
    outs = [np.full((T, B2, H), np.nan) for _ in range(3)]          # h, h_prev, c_prev
    xf = xproj.astype(np.float64).ravel()
    for row in range(B2):
        n = counts[row]
        lst = steps[row].astype(np.float64)
        entry = lambda e: lst[n - 1 - e:n - e]                       # noqa: E731 (ascending entry e)
        w = (w_f if row < B else w_b).astype(np.float64)
        ring, lring = _Ring(G), _Ring(1, LR)

        def copies(t):
            t = int(t)
            assert 0 <= t < T and valid[t, row] > 0, (row, t)
            return [(e, xf[(t * B2 + row) * G + e:(t * B2 + row) * G + e + V]) for e in range(0, G, V)]

        for e in range(min(n, LR - 1)):                              # read before the walk
            lring.slots[e], lring.holds[e] = entry(e), e
        for s in range(R - 1):
            ring.commit(*((s, copies(lring.read(s)[0])) if s < n else ()))
            lring.commit()
        t_first = int(lring.read(0)[0]) if n else T
        t_cur, h, c = t_first, np.zeros(H), np.zeros(H)
        h_s = [(0, np.zeros(H)), None]                               # (step, h) in each buffer
        for s in range(n):
            ring.wait(R - 2)
            lring.wait(R - 2)
            t_next = int(lring.read(s + 1)[0]) if s + 1 < n else T
            t_st = lring.read(s + R - 1)[0] if s + R - 1 < n else None
            step, hb = h_s[s & 1]
            assert step == s
            pre = ring.read(s) + w @ hb
            act = np.concatenate([_sig(pre[:2 * H]), np.tanh(pre[2 * H:3 * H]), _sig(pre[3 * H:])])
            lane = np.array([act[(l % 4) * H + l // 4] for l in range(G)])       # lane 4k + m: gate m of k
            quad = lane.reshape(H, 4)                                # __shfl_sync(a, q, 4) in each lane
            h_old, c_old = h, c
            c = quad[:, 1] * c + quad[:, 0] * quad[:, 2]
            h = quad[:, 3] * np.tanh(c)
            h_s[(s + 1) & 1] = (s + 1, h)
            if s + R - 1 < n:                                        # the step's copies, after h
                ring.commit(s + R - 1, copies(t_st))
                lring.commit(*((s + LR - 1, [(0, entry(s + LR - 1))]) if s + LR - 1 < n else ()))
            else:
                ring.commit()
                lring.commit()
            for o, v in zip(outs, (h, h_old, c_old)):
                o[t_cur, row] = v
            for t in range(t_cur + 1, t_next):                       # the gap after step s
                for o, v in zip(outs, (0.0, h, c)):
                    o[t, row] = v
            t_cur = t_next
        for o in outs:                                               # the steps before the first
            o[:t_first, row] = 0.0
    return outs


# stacked rows from lengths: 0, 1 and around the ring's 8 slots, around the
# list ring's 16 entries, T below the ring; random 0/1 masks with holes
K7_REPLAY_CASES = [(20, [0, 1, 7, 8, 9, 20], False), (5, [5, 0, 2], False),
                   (40, [15, 16, 17, 40], False), (45, [45, 45, 45], True), (70, [70, 3], True)]


@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("T,lengths,random_mask", K7_REPLAY_CASES)
def test_k7_walk_replayed_gives_the_plain_forward(T, lengths, random_mask, V):
    rng = np.random.default_rng(T + len(lengths) + 1)
    H, B = 40, len(lengths)
    xproj = rng.standard_normal((T, 2 * B, 4 * H)).astype(np.float32)
    w_f, w_b = ((rng.uniform(-1, 1, (4 * H, H)) / np.sqrt(H)).astype(np.float32) for _ in range(2))
    lens, t = np.array(lengths), np.arange(T)[:, None]
    valid = np.concatenate([t < lens[None], T - 1 - t < lens[None]], axis=1).astype(np.float32)
    if random_mask:
        valid = (rng.uniform(size=(T, 2 * B)) < 0.7).astype(np.float32)
    got = _k7_replay(xproj, valid, w_f, w_b, V)
    want = lstm_recurrence_stacked_plain(*(torch.from_numpy(a) for a in (xproj, valid, w_f, w_b)))
    # float64 here, float32 there, through at most 70 steps; |c| grows past 1
    for g, w in zip(got, want):
        w = w.double().numpy()
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
    assert np.all(got[0][valid <= 0] == 0)


def test_k2_shared_memory_and_copy_width():
    """K2's walk: a ring of ``BACKWARD_RING`` slots of one step's 4H
    projections, then h of two steps; each (b, t, d) slice of xproj it
    stages starts a multiple of 4 floats from the tensor's start, so the
    start decides its copy width."""
    B, T, D, H = 3, 7, 2, 40
    assert forward_smem_bytes(H) == 4 * (BACKWARD_RING * 4 * H + 2 * H) == 5440 <= STATIC_SMEM_LIMIT
    assert all(((b * T + t) * D + d) * 4 * H % 4 == 0
               for b in range(B) for t in range(T) for d in range(D))
    xproj = torch.zeros((B, T, D, 4 * H))
    assert backward_copy_width(xproj) == 4
    assert backward_copy_width(torch.zeros(xproj.numel() + 1)[1:].view(xproj.shape)) == 1


def _dot_h(w, h):
    """W_hh h in float32 in dot_h's order (csrc/lstm_util.cuh): four chains
    over j mod 4, then (a0 + a1) + (a2 + a3)."""
    a = np.zeros((4, w.shape[0]), np.float32)
    for j in range(w.shape[1]):
        a[j % 4] = a[j % 4] + w[:, j] * h[j]
    return (a[0] + a[1]) + (a[2] + a[3])


def _k2_replay(xproj, lengths, w_hh, V):
    """K2 of csrc/lstm.cu in float32, its schedule replayed, one walk a
    (row, direction): walk step s is frame s (direction 0) or len-1-s
    (direction 1); its projection copied V floats at a time into the ring
    (``_Ring``), ``BACKWARD_RING - 1`` steps ahead, each step's copies
    issued after its h; lane 4k + m's activation of gate m of unit k, the
    quad's four taken by each of its lanes, h in two buffers; h and c stored
    at the step's frame, and the pad frames filled after the walk.  The
    outputs start as NaN, so a frame nobody writes would show."""
    B, T, D, G = xproj.shape
    H, R = G // 4, BACKWARD_RING
    out = np.full((B, T, D * H), np.nan, np.float32)
    cell = np.full((B, T, D, H), np.nan, np.float32)
    xf = xproj.ravel()
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        for d in range(D):
            t0, dt = (n - 1, -1) if d else (0, 1)
            ring = _Ring(G)

            def copies(s):
                t = t0 + s * dt
                assert 0 <= t < n, (b, d, s, t)
                base = ((b * T + t) * D + d) * G
                return [(e, xf[base + e:base + e + V]) for e in range(0, G, V)]

            for s in range(R - 1):
                ring.commit(*((s, copies(s)) if s < n else ()))
            c = np.zeros(H, np.float32)
            h_s = [(0, np.zeros(H, np.float32)), None]               # (step, h) in each buffer
            for s in range(n):
                ring.wait(R - 2)
                step, hb = h_s[s & 1]
                assert step == s
                pre = ring.read(s).astype(np.float32) + _dot_h(w_hh[d], hb)
                sg, th = _sig(pre).astype(np.float32), np.tanh(pre)
                lane = np.array([th[g] if g // H == 2 else sg[g]
                                 for g in ((l % 4) * H + l // 4 for l in range(G))])
                quad = lane.reshape(H, 4)                            # __shfl_sync(a, q, 4) in each lane
                c = quad[:, 1] * c + quad[:, 0] * quad[:, 2]
                h = quad[:, 3] * np.tanh(c)
                h_s[(s + 1) & 1] = (s + 1, h)
                ring.commit(*((s + R - 1, copies(s + R - 1)) if s + R - 1 < n else ()))
                t = t0 + s * dt
                out[b, t, d * H:(d + 1) * H] = h
                cell[b, t, d] = c
            out[b, n:, d * H:(d + 1) * H] = 0.0                      # the pad frames, after the walk
            cell[b, n:, d] = 0.0
    return out, cell


K2_REPLAY_T = 12


# a row of each length beside a full one: 0, 1, around the ring's 8 slots
# and T; copy widths 4 and 1; one direction and two
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("length", [0, 1, 6, 7, 8, 9, K2_REPLAY_T])
def test_k2_walk_replayed_gives_the_plain_forward(length, V, D):
    rng = np.random.default_rng(length + 10 * V + D)
    T, H = K2_REPLAY_T, 40
    lengths = np.array([length, T], np.int32)
    xproj = rng.standard_normal((2, T, D, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (D, 4 * H, H)) / np.sqrt(H)).astype(np.float32)
    got_h, got_c = _k2_replay(xproj, lengths, w_hh, V)
    want_h, want_c = lstm_recurrence_plain(torch.from_numpy(xproj), torch.from_numpy(lengths),
                                           torch.from_numpy(w_hh), with_cell=True)
    # float32 both, sums in another order, through at most 12 steps; |c| past 1
    for got, want in ((got_h, want_h), (got_c, want_c)):
        want = want.numpy()
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    for b, n in enumerate(lengths):
        assert np.all(got_h[b, n:] == 0) and np.all(got_c[b, n:] == 0)


def _pair_h_index(k):
    """csrc/lstm_pair.cuh pair_h_index: where h[k] lies in the pair's h
    buffer (bits 1 and 2 of k swapped)."""
    return (k & ~6) | ((k & 2) << 1) | ((k & 4) >> 1)


def test_k2_h128_shared_memory_and_h_layout():
    """K2's layout at the LSTM head's H = 128: a CTA of the pair stages the
    projections of its 256 gates a step (four whole 64-float segments, one
    copy a thread at either width) and holds h of all 128 units for two
    steps, with an mbarrier for each of the two; the h buffer is a permutation of the units whose float4 at 8q +
    4p holds what lane p's chains 2p and 2p + 1 read at q, in dot_h's
    order; H = 40's one-block layout is unchanged."""
    H, U = PAIR_HIDDEN, PAIR_HIDDEN // 2
    assert forward_smem_bytes(H) == 4 * (BACKWARD_RING * 4 * U + 2 * H) + 2 * 8 == 9232 \
        <= STATIC_SMEM_LIMIT
    assert forward_smem_bytes(40) == 5440
    assert U % 4 == 0 and 4 * U <= 512                       # 2 x 4U gate-row lanes, 4U copies of 1
    k = np.arange(H)
    assert sorted(_pair_h_index(k)) == list(k)
    inv = np.empty(H, int)
    inv[_pair_h_index(k)] = k
    for p in range(2):
        read = inv[(8 * np.arange(H // 8)[:, None] + 4 * p + np.arange(4)).ravel()]
        assert sorted(read) == [j for j in k if j % 4 in (2 * p, 2 * p + 1)]
        for chain in (2 * p, 2 * p + 1):                     # each chain's k ascending
            mine = [j for j in read if j % 4 == chain]
            assert mine == sorted(mine)


def _k2_pair_replay(xproj, lengths, w_hh, V, order_seed=0):
    """K2's H = 128 walk (csrc/lstm.cu lstm_fwd_pair_kernel) in float32, the
    two CTAs r of each (row, direction) stepping in any order their waits
    allow (a seeded choice, so that either runs a step ahead): CTA r's ring
    of its 4U projections a step (gate i's U at [iU, (i + 1) U)), copied V
    floats at a time (``_Ring``); thread 32w + L steps unit rU + 4w + (L >>
    3), gate (L >> 1) & 3, and with p = L & 1 keeps W_hh[g, k] of the k it
    reads from the h buffer's float4s at 8q + 4p, running chains 2p and 2p
    + 1 in dot_h's order; the lane pair's halves summed in both lanes; the
    unit's gates from lanes 0, 2, 4, 6 of its eight; h of step s + 1 stored
    at ``_pair_h_index`` into the CTA's own buffer (s + 1) & 1 and into the
    partner's, where its 4 bytes count on the partner's mbarrier of that
    buffer, which the partner arms for U floats; step s waits for that
    mbarrier's phase.  Each buffer is checked whole and of the right step
    when read, and read by its CTA before anything is stored into it again;
    nothing is stored into a CTA that has left; each CTA's pad frames after
    its walk.  The outputs start as NaN, so a frame nobody writes would
    show."""
    B, T, D, G = xproj.shape
    H, R = G // 4, BACKWARD_RING
    U = H // 2
    out = np.full((B, T, D * H), np.nan, np.float32)
    cell = np.full((B, T, D, H), np.nan, np.float32)
    xf = xproj.ravel()
    order = np.random.default_rng(order_seed)
    thread = np.arange(2 * 4 * U)
    L = thread % 32
    kk = 4 * (thread // 32) + (L >> 3)
    m, p = (L >> 1) % 4, L % 2
    pos = 8 * np.arange(H // 8)[None, :, None] + 4 * p[:, None, None] + np.arange(4)   # (NT, Q, 4)
    inv = np.empty(H, int)
    inv[_pair_h_index(np.arange(H))] = np.arange(H)
    units = np.arange(U)
    for b in range(B):
        n = max(0, min(int(lengths[b]), T))
        for d in range(D):
            t0, dt = (n - 1, -1) if d else (0, 1)
            wv = [w_hh[d][(m * H + r * U + kk)[:, None, None], inv[pos]] for r in range(2)]
            rings = [_Ring(4 * U), _Ring(4 * U)]
            # [CTA][buffer]: h, the step each value is of, the step the CTA last read it at
            hbuf = [[np.full(H, np.nan, np.float32) for _ in range(2)] for _ in range(2)]
            tag = [[np.full(H, -1) for _ in range(2)] for _ in range(2)]
            read_at = [[None, None] for _ in range(2)]
            # [CTA][buffer] mbarrier: phases completed, the open phase's arming and bytes
            phases = [[0, 0] for _ in range(2)]
            armed = [[False, False] for _ in range(2)]
            got = [[0, 0] for _ in range(2)]
            left = [False, False]
            nxt = [0, 0]
            c = [np.zeros(U, np.float32), np.zeros(U, np.float32)]

            def copies(r, s):
                t = t0 + s * dt
                assert 0 <= t < n, (b, d, s, t)
                base = ((b * T + t) * D + d) * G
                return [(e, xf[base + e // U * H + r * U + e % U:][:V]) for e in range(0, 4 * U, V)]

            def settle(r, buf):                              # the phase completes when armed and full
                if armed[r][buf] and got[r][buf] == 4 * U:     # U floats from the partner
                    phases[r][buf] += 1
                    armed[r][buf], got[r][buf] = False, 0

            def store(dst, buf, s, h, r):                    # h of step s + 1 of CTA r's units
                assert not left[dst], (b, d, s, r)
                assert read_at[dst][buf] == (s - 1 if s else None), (b, d, s, r, read_at)
                hbuf[dst][buf][_pair_h_index(r * U + units)] = h
                tag[dst][buf][_pair_h_index(r * U + units)] = s + 1

            def ready(r):                                    # its wait at its next step holds
                s = nxt[r]
                return s == 0 or phases[r][s & 1] > (s - 1) >> 1

            def step(r):
                s, buf = nxt[r], nxt[r] & 1
                assert np.all(tag[r][buf] == s), (b, d, s, r)    # both halves of step s landed
                read_at[r][buf] = s
                x = rings[r].read(s).astype(np.float32)[m * U + kk]
                hv = hbuf[r][buf][pos]
                a0, a1 = np.zeros(len(thread), np.float32), np.zeros(len(thread), np.float32)
                for q in range(H // 8):
                    a0 = a0 + wv[r][:, q, 0] * hv[:, q, 0]
                    a1 = a1 + wv[r][:, q, 1] * hv[:, q, 1]
                    a0 = a0 + wv[r][:, q, 2] * hv[:, q, 2]
                    a1 = a1 + wv[r][:, q, 3] * hv[:, q, 3]
                half = a0 + a1
                pre = x + (half + half[thread ^ 1])
                sg, th = _sig(pre).astype(np.float32), np.tanh(pre)
                act = np.where(m == 2, th, sg).reshape(U, 8)
                ig, fg, gg, og = act[:, 0], act[:, 2], act[:, 4], act[:, 6]
                c[r] = fg * c[r] + ig * gg
                h = og * np.tanh(c[r])
                t = t0 + s * dt
                out[b, t, d * H + r * U:d * H + (r + 1) * U] = h
                cell[b, t, d, r * U:(r + 1) * U] = c[r]
                nxt[r] += 1
                if s + 1 == n:                               # the last step: nothing to publish
                    out[b, n:, d * H + r * U:d * H + (r + 1) * U] = 0.0   # its pad frames
                    cell[b, n:, d, r * U:(r + 1) * U] = 0.0
                    left[r] = True
                    return
                nb = (s + 1) & 1
                store(r, nb, s, h, r)                        # its own half, st.shared
                store(r ^ 1, nb, s, h, r)                    # the partner's, st.async
                assert got[r ^ 1][nb] == 0, (b, d, s, r)        # no bytes of a later phase early
                got[r ^ 1][nb] += 4 * U
                settle(r ^ 1, nb)
                assert not armed[r][nb], (b, d, s, r)        # the phase before has completed
                armed[r][nb] = True                          # thread 0 arms its own
                settle(r, nb)
                rings[r].commit(*((s + R - 1, copies(r, s + R - 1)) if s + R - 1 < n else ()))
                rings[r].wait(R - 2)                         # step s + 1 landed; __syncthreads

            for s in range(R - 1):
                for r in range(2):
                    rings[r].commit(*((s, copies(r, s)) if s < n else ()))
            for r in range(2):                               # before the cluster barrier
                if n > 0:
                    rings[r].wait(R - 2)
                    hbuf[r][0][:] = 0.0
                    tag[r][0][:] = 0
                else:
                    out[b, :, d * H + r * U:d * H + (r + 1) * U] = 0.0
                    cell[b, :, d, r * U:(r + 1) * U] = 0.0
                    left[r] = True
            while not all(left):
                can = [r for r in range(2) if not left[r] and ready(r)]
                assert can, (b, d, nxt)                      # no deadlock
                step(can[order.integers(len(can))])
    return out, cell


# the pair walk at the LSTM head's width beside a full row: lengths 0, 1,
# around the ring's 8 slots and T; copy widths 4 and 1; one direction and two
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("length", [0, 1, 7, 8, 9, K2_REPLAY_T])
def test_k2_h128_pair_walk_replayed_gives_the_one_block_bits(length, V, D):
    """K2 at H = 128: the pair walk replayed equals the one-block walk's
    replay (``_k2_replay``) bit for bit, and the plain forward within 1e-5."""
    rng = np.random.default_rng(length + 10 * V + D + 128)
    T, H = K2_REPLAY_T, PAIR_HIDDEN
    lengths = np.array([length, T], np.int32)
    xproj = rng.standard_normal((2, T, D, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (D, 4 * H, H)) / np.sqrt(H)).astype(np.float32)
    got_h, got_c = _k2_pair_replay(xproj, lengths, w_hh, V, order_seed=length + D)
    one_h, one_c = _k2_replay(xproj, lengths, w_hh, V)
    assert np.array_equal(got_h, one_h) and np.array_equal(got_c, one_c)
    want_h, want_c = lstm_recurrence_plain(torch.from_numpy(xproj), torch.from_numpy(lengths),
                                           torch.from_numpy(w_hh), with_cell=True)
    # float32 both, sums in another order, through at most 12 steps; |c| past 1
    for got, want in ((got_h, want_h), (got_c, want_c)):
        want = want.numpy()
        assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    for b, n in enumerate(lengths):
        assert np.all(got_h[b, n:] == 0) and np.all(got_c[b, n:] == 0)


def test_k7_h128_shared_memory():
    """K7's layout at the LSTM head's H = 128: a CTA of the pair walk holds
    K2's pair layout (its 256 gates' projections a slot, two h buffers of
    all 128 units, their two mbarriers) and the list ring of 2
    ``BACKWARD_RING`` entries; H = 40's one-block layout is unchanged."""
    H, U = PAIR_HIDDEN, PAIR_HIDDEN // 2
    assert stacked_forward_smem_bytes(H) == forward_smem_bytes(H) + 4 * 2 * BACKWARD_RING \
        == 4 * (BACKWARD_RING * 4 * U + 2 * H + 2 * BACKWARD_RING) + 2 * 8 == 9296 <= STATIC_SMEM_LIMIT
    assert stacked_forward_smem_bytes(40) == 5504


def _k7_pair_replay(xproj, valid, w_f, w_b, V, order_seed=0):
    """K7's H = 128 walk (csrc/lstm_bidir.cu lstm_stacked_fwd_pair_kernel,
    the loop of csrc/lstm_pair.cuh pair_forward_walk) in float32:
    ``_k2_pair_replay``'s two CTAs a stacked row, stepping in any order their
    waits allow (a seeded choice), each with its ring of its 4U projections
    a step copied V floats at a time from listed step list[s] (``_Ring``)
    and its own list ring of 2 ``BACKWARD_RING`` entries (the list read from
    its end: the first 2 ``BACKWARD_RING`` - 1 entries read before the
    walk, each later one copied in an iteration's group, both rings' groups
    committed and landed together).  The mbarrier's phases count listed
    steps; each h buffer is checked whole and of the right step when read,
    and read by its CTA before anything is stored into it again; nothing is
    stored into a CTA that has left.  Lanes 0, 1, 2 of a unit's eight store
    h, h_prev and c_prev at the listed step, then the gap up to the next one
    (0, the state); each CTA's steps before the first listed one after its
    walk.  The outputs start as NaN, so a step nobody writes would show."""
    T, B2, G = xproj.shape
    B, H, R = B2 // 2, G // 4, BACKWARD_RING
    U, LR = H // 2, 2 * R
    steps, counts = _k8_steps(valid)
    outs = [np.full((T, B2, H), np.nan, np.float32) for _ in range(3)]     # h, h_prev, c_prev
    xf = xproj.ravel()
    order = np.random.default_rng(order_seed)
    thread = np.arange(2 * 4 * U)
    L = thread % 32
    kk = 4 * (thread // 32) + (L >> 3)
    m, p = (L >> 1) % 4, L % 2
    pos = 8 * np.arange(H // 8)[None, :, None] + 4 * p[:, None, None] + np.arange(4)   # (NT, Q, 4)
    inv = np.empty(H, int)
    inv[_pair_h_index(np.arange(H))] = np.arange(H)
    units = np.arange(U)
    for row in range(B2):
        n, lst = int(counts[row]), steps[row]
        entry = lambda e: lst[n - 1 - e:n - e].astype(np.float64)   # noqa: E731 (ascending entry e)
        w = w_f if row < B else w_b
        wv = [w[(m * H + r * U + kk)[:, None, None], inv[pos]] for r in range(2)]
        rings, lrings = [_Ring(4 * U), _Ring(4 * U)], [_Ring(1, LR), _Ring(1, LR)]
        hbuf = [[np.full(H, np.nan, np.float32) for _ in range(2)] for _ in range(2)]
        tag = [[np.full(H, -1) for _ in range(2)] for _ in range(2)]
        read_at = [[None, None] for _ in range(2)]
        phases = [[0, 0] for _ in range(2)]
        armed = [[False, False] for _ in range(2)]
        got = [[0, 0] for _ in range(2)]
        left, nxt = [False, False], [0, 0]
        c = [np.zeros(U, np.float32), np.zeros(U, np.float32)]
        old = [(np.zeros(U, np.float32), np.zeros(U, np.float32)) for _ in range(2)]   # h_prev, c_prev
        t_first, t_cur = [T, T], [T, T]

        def cols(r):
            return slice(r * U, (r + 1) * U)

        def copies(r, t):
            t = int(t)
            assert 0 <= t < T and valid[t, row] > 0, (row, t)
            base = (t * B2 + row) * G
            return [(e, xf[base + e // U * H + r * U + e % U:][:V]) for e in range(0, 4 * U, V)]

        def commit(r, s):                                # iteration s's group (both rings')
            st = s + R - 1
            rings[r].commit(*((st, copies(r, lrings[r].read(st)[0])) if st < n else ()))
            lrings[r].commit(*((s + LR - 1, [(0, entry(s + LR - 1))]) if s + LR - 1 < n else ()))

        def settle(r, buf):
            if armed[r][buf] and got[r][buf] == 4 * U:
                phases[r][buf] += 1
                armed[r][buf], got[r][buf] = False, 0

        def store(dst, buf, s, h, r):
            assert not left[dst], (row, s, r)
            assert read_at[dst][buf] == (s - 1 if s else None), (row, s, r, read_at)
            hbuf[dst][buf][_pair_h_index(r * U + units)] = h
            tag[dst][buf][_pair_h_index(r * U + units)] = s + 1

        def ready(r):
            s = nxt[r]
            return s == 0 or phases[r][s & 1] > (s - 1) >> 1

        def leave(r):                                    # the steps before the first listed one
            for o in outs:
                o[:t_first[r], row, cols(r)] = 0.0
            left[r] = True

        def emit(r, s, h, last):
            t_next = T if last else int(lrings[r].read(s + 1)[0])
            for o, v in zip(outs, (h, *old[r])):
                o[t_cur[r], row, cols(r)] = v
            for o, v in zip(outs, (0.0, h, c[r])):       # the gap up to the next listed step
                o[t_cur[r] + 1:t_next, row, cols(r)] = v
            t_cur[r], old[r] = t_next, (h, c[r].copy())

        def step(r):
            s, buf = nxt[r], nxt[r] & 1
            assert np.all(tag[r][buf] == s), (row, s, r)
            read_at[r][buf] = s
            x = rings[r].read(s).astype(np.float32)[m * U + kk]
            hv = hbuf[r][buf][pos]
            a0, a1 = np.zeros(len(thread), np.float32), np.zeros(len(thread), np.float32)
            for q in range(H // 8):
                a0 = a0 + wv[r][:, q, 0] * hv[:, q, 0]
                a1 = a1 + wv[r][:, q, 1] * hv[:, q, 1]
                a0 = a0 + wv[r][:, q, 2] * hv[:, q, 2]
                a1 = a1 + wv[r][:, q, 3] * hv[:, q, 3]
            half = a0 + a1
            pre = x + (half + half[thread ^ 1])
            sg, th = _sig(pre).astype(np.float32), np.tanh(pre)
            act = np.where(m == 2, th, sg).reshape(U, 8)
            ig, fg, gg, og = act[:, 0], act[:, 2], act[:, 4], act[:, 6]
            c[r] = fg * c[r] + ig * gg
            h = og * np.tanh(c[r])
            nxt[r] += 1
            if s + 1 == n:                               # the last step: nothing to publish
                emit(r, s, h, True)
                leave(r)
                return
            nb = (s + 1) & 1
            store(r, nb, s, h, r)
            store(r ^ 1, nb, s, h, r)
            assert got[r ^ 1][nb] == 0, (row, s, r)
            got[r ^ 1][nb] += 4 * U
            settle(r ^ 1, nb)
            assert not armed[r][nb], (row, s, r)
            armed[r][nb] = True
            settle(r, nb)
            commit(r, s)
            emit(r, s, h, False)
            rings[r].wait(R - 2)                         # step s + 1 landed; __syncthreads
            lrings[r].wait(R - 2)

        for r in range(2):
            for e in range(min(n, LR - 1)):              # read before the walk
                lrings[r].slots[e], lrings[r].holds[e] = entry(e), e
            for s in range(R - 1):
                rings[r].commit(*((s, copies(r, lrings[r].read(s)[0])) if s < n else ()))
                lrings[r].commit()
            if n > 0:                                    # before the cluster barrier
                rings[r].wait(R - 2)
                lrings[r].wait(R - 2)
                hbuf[r][0][:] = 0.0
                tag[r][0][:] = 0
                t_first[r] = t_cur[r] = int(lrings[r].read(0)[0])
            else:
                leave(r)
        while not all(left):
            can = [r for r in range(2) if not left[r] and ready(r)]
            assert can, (row, nxt)                       # no deadlock
            step(can[order.integers(len(can))])
    return outs


K7_PAIR_T = 24


# the pair walk at the LSTM head's width: a row of each length beside a
# full one (0, 1, around the ring's 8 slots, around the list ring's 16
# entries, T), or a random mask with holes; copy widths 4 and 1
@pytest.mark.parametrize("V", [4, 1])
@pytest.mark.parametrize("rows", [0, 1, 7, 8, 9, 15, 16, 17, K7_PAIR_T, "holes"])
def test_k7_h128_pair_walk_replayed_gives_k2s_bits_and_the_plain_forward(rows, V):
    """K7 at H = 128: the pair walk fed from the step lists, replayed, gives
    h equal to K2's pair walk's replay (``_k2_pair_replay``) bit for bit on
    a contiguous mask, and h, h_prev and c_prev within 1e-5 of the plain
    forward, exactly 0 at the invalid steps."""
    seed = (rows if rows != "holes" else 99) + 10 * V
    rng = np.random.default_rng(seed + 128)
    T, H = K7_PAIR_T, PAIR_HIDDEN
    lengths = np.array([rows, T] if rows != "holes" else [T, T, T], np.int32)
    B = len(lengths)
    xproj = rng.standard_normal((B, T, 2, 4 * H)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (2, 4 * H, H)) / np.sqrt(H)).astype(np.float32)
    xs = stack_directions(torch.from_numpy(xproj)).contiguous().numpy()
    valid = stacked_valid(T, torch.from_numpy(lengths)).numpy()
    if rows == "holes":
        valid = (rng.uniform(size=(T, 2 * B)) < 0.7).astype(np.float32)
    got = _k7_pair_replay(xs, valid, w_hh[0], w_hh[1], V, order_seed=seed)
    if rows != "holes":
        k2_h, _ = _k2_pair_replay(xproj, lengths, w_hh, V, order_seed=seed + 1)
        assert np.array_equal(unstack_directions(torch.from_numpy(got[0])).reshape(B, T, 2 * H).numpy(),
                              k2_h)
    want = lstm_recurrence_stacked_plain(*(torch.from_numpy(a) for a in (xs, valid, w_hh[0], w_hh[1])))
    # float32 both, sums in another order, through at most 24 steps; |c| past 1
    for g, w in zip(got, want):
        w = w.numpy()
        assert not np.isnan(g).any()
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
    assert np.all(got[0][valid <= 0] == 0)


def test_k5_ring_and_shared_memory_for_every_S():
    """Every S the wrapper takes on the card (S = 2L + 1 <= 4095): the most
    slots up to ``BETA_RING``, an even number, whose layout (the ring of
    2S-float slots, then the two S-float recursion buffers) fits
    ``SMEM_LIMIT``; 6 or 8, the rings csrc/ctc.cu instantiates."""
    for S in range(1, 4096, 2):
        R = ctc_beta_ring(S)
        assert R in (6, 8), S
        assert ctc_beta_smem_bytes(S) == 4 * (R * 2 * S + 2 * S) <= SMEM_LIMIT
        assert R == BETA_RING or 4 * ((R + 2) * 2 * S + 2 * S) > SMEM_LIMIT
    assert ctc_beta_ring(3227) == BETA_RING and ctc_beta_ring(3229) == ctc_beta_ring(4095) == 6


def _lse3(a, b, c):
    """csrc/ctc.cu lse3 on float32 vectors, in its order."""
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log((torch.exp(a - m) + torch.exp(b - m)) + torch.exp(c - m))


def _k5_replay(lp, lens, targets, tls, alpha, ll, gbar, blank):
    """K5 of csrc/ctc.cu in float32 (its -1e30 sentinel is absorbed as
    there), its layout and schedule replayed: the threads' states (s = tid
    + j NT); the walkers, the warps up to the last valid state; each step's
    emissions (gathered through the labels) and alpha row copied one float
    at a time from the flat buffers into the ring (``_Ring``), R - 1 steps
    ahead, for the walkers' states only; the chain reads only the slot's
    emissions, the gradient only its alpha row and the chain's beta; the
    other warps' states keep u at NEG_INF + NEG_INF and take their gradient
    from alpha directly."""
    B, T, C = lp.shape
    L = targets.shape[1]
    S = 2 * L + 1
    NT, R = ctc_kernels._threads(S), ctc_beta_ring(S)
    ext, valid, skip, final = (a.numpy() for a in lattice(torch.from_numpy(targets),
                                                          torch.from_numpy(tls), blank))
    lpf, alf = lp.ravel(), alpha.ravel()
    s_idx = np.arange(S)
    neg = torch.full((S,), NEG_INF)
    ge = np.full((B, T, S), np.nan, np.float32)
    for b in range(B):
        n = max(0, min(int(lens[b]), T))
        n_states = 2 * max(0, min(int(tls[b]), L)) + 1
        walkers = 32 * min(NT // 32, -(-n_states // 32))
        walks_np = s_idx % NT < walkers
        assert valid[b][~walks_np].sum() == 0                 # no valid state stops walking
        walks = torch.from_numpy(walks_np)
        skip2 = torch.from_numpy(np.concatenate([skip[b, 2:], [False, False]]))
        ring = _Ring(2 * S, R)

        def copies(k):
            row = b * T + n - 1 - k
            # K5's alpha rows start row * S floats in: at odd offsets for odd rows
            assert (row * S) % 2 == row % 2
            return ([(s, lpf[row * C + ext[b, s]:row * C + ext[b, s] + 1] if valid[b, s]
                      else np.zeros(1)) for s in s_idx[walks_np]]
                    + [(S + s, alf[row * S + s:row * S + s + 1]) for s in s_idx[walks_np]])

        for k in range(R - 1):
            ring.commit(*((k, copies(k)) if k < n else ()))
        ge[b, n:] = 0
        if n == 0:
            continue
        cur = neg + neg                                     # the other warps' u, for good
        nxt = cur.clone()
        for k in range(n):
            t = n - 1 - k
            ring.wait(R - 2)
            slot = torch.from_numpy(ring.read(k).astype(np.float32))
            emit, a = slot[:S], torch.where(walks, slot[S:], torch.from_numpy(alpha[b, t]))
            if k == 0:
                bt = torch.where(torch.from_numpy(final[b]), 0.0, neg)
            else:
                u1 = torch.cat([cur[1:], neg[:1]])
                u2 = torch.where(skip2, torch.cat([cur[2:], neg[:2]]), neg)
                bt = _lse3(cur, u1, u2)
            bt = torch.where(walks, bt, neg)
            nxt = torch.where(walks, bt + torch.where(torch.from_numpy(valid[b]), emit, neg), nxt)
            ge[b, t] = (-float(gbar[b]) * torch.exp((a + bt) - float(ll[b]))).numpy()
            ring.commit(*((k + R - 1, copies(k + R - 1)) if k + R - 1 < n else ()))
            cur, nxt = nxt, cur
    return ge


# (T, input lengths, target lengths, L, C): lengths 0, 1, R - 1, R, R + 1
# and T beside an empty target and an impossible alignment (8 labels in 3
# frames); S at one warp (31 states), above 1024 threads (1041: two states
# a thread), and at the largest S (4095: a 6-slot ring, four a thread)
K5_REPLAY_CASES = [
    (20, [20, 0, 1, 7, 8, 9, 3, 20], [6, 2, 0, 3, 4, 2, 8, 0], 15, 29),
    (12, [12, 10, 1, 9], [5, 0, 520, 1], 520, 9),
    (9, [9, 5, 6, 7, 0], [2047, 3, 1, 0, 2], 2047, 29),
]


@pytest.mark.parametrize("T,lengths,tls,L,C", K5_REPLAY_CASES)
def test_k5_walk_replayed_gives_the_plain_gradient(T, lengths, tls, L, C):
    rng = np.random.default_rng(T + L)
    B = len(lengths)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(0, C - 1, (B, L)).astype(np.int32)
    targets[0, 1] = targets[0, 0]                             # a repeat: no skip
    lens, tl = np.array(lengths, np.int32), np.array(tls, np.int32)
    args = (torch.from_numpy(lp), torch.from_numpy(lens), torch.from_numpy(targets),
            torch.from_numpy(tl))
    alpha, ll = ctc_alpha_plain(*args, C - 1)
    gbar = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))
    want = ctc_beta_plain(*args, alpha, ll, gbar, C - 1).numpy()
    got = _k5_replay(lp, lens, targets, tl, alpha.numpy(), ll.numpy(), gbar.numpy(), C - 1)
    # both in float32, with the same order and functions
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    for b, n in enumerate(lengths):
        assert np.all(got[b, n:] == 0)


def test_k4_shared_memory_for_every_S():
    """Every S the wrapper takes on the card (S = 2L + 1 <= 4095): K4's one
    ring of ``ALPHA_RING`` slots of S floats, then the two S-float buffers
    of alpha, fits ``SMEM_LIMIT`` (163,800 B at S = 4095)."""
    for S in range(1, 4096, 2):
        assert ctc_alpha_smem_bytes(S) == 4 * (ALPHA_RING * S + 2 * S) <= SMEM_LIMIT
    assert ctc_alpha_smem_bytes(4095) == 163_800


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _k4_replay(lp, lens, targets, tls, blank, all_walk=False):
    """K4 of csrc/ctc.cu in float32 (its -1e30 sentinel is absorbed as
    there), its layout and schedule replayed: the threads' states (s = tid
    + j NT, a lane past S taking state S-1 whole: its copies, values and
    stores, which must agree with the owner's); the walkers, the warps up
    to the last valid state (every warp with ``all_walk``); each step's
    emissions gathered through the labels and copied one float at a time
    from the flat log-probs into the ring (``_Ring``), R - 1 steps ahead,
    for the walkers' states only, landing only at the waits; the chain
    reads only the slot and the other alpha buffer; the other warps fill
    both buffers once with NEG_INF + NEG_INF and store their constant
    alpha; ll from the two final states.  Returns alpha (NaN where nothing
    was stored), ll, the ll that thread 0's two loops over every state
    give from the same buffer, and the states of the warps out of the
    walk (B, S)."""
    B, T, C = lp.shape
    L = targets.shape[1]
    S = 2 * L + 1
    NT, R = ctc_kernels._threads(S), ALPHA_RING
    PER = -(-S // NT)
    ext, valid, skip, final = (a.numpy() for a in lattice(torch.from_numpy(targets),
                                                          torch.from_numpy(tls), blank))
    lpf = lp.ravel()
    tid = np.tile(np.arange(NT), PER)
    st = np.minimum(tid + np.repeat(np.arange(PER), NT) * NT, S - 1)
    neg = np.float32(NEG_INF)
    alpha = np.full((B, T, S), np.nan, np.float32)
    ll, ll_loops = np.full(B, neg), np.full(B, neg)
    dead_states = np.zeros((B, S), bool)

    def store(b, t, s, v):                       # every store of a state holds the same bits
        prev = alpha[b, t, s]
        done = ~np.isnan(prev)
        assert np.array_equal(_bits(prev[done]), _bits(v[done])), (b, t)
        alpha[b, t, s] = v
        assert np.array_equal(_bits(alpha[b, t, s]), _bits(v)), (b, t)

    for b in range(B):
        n = max(0, min(int(lens[b]), T))
        tl = max(0, min(int(tls[b]), L))
        n_states = 2 * tl + 1
        if n == 0:
            continue
        walkers = NT if all_walk else 32 * min(NT // 32, -(-n_states // 32))
        walk = tid < walkers
        sw, sd = st[walk], st[~walk]
        assert not valid[b][sd].any()                         # no valid state stops walking
        dead_states[b, sd] = True
        buf = torch.full((2, S), float("nan"))
        buf[:, sd] = torch.tensor(neg) + torch.tensor(neg)
        store(b, 0, sd, np.full(len(sd), neg))
        for t in range(1, n):
            store(b, t, sd, np.full(len(sd), neg + neg))
        ring = _Ring(S, R)
        ok = torch.from_numpy(valid[b][sw])
        sk = torch.from_numpy(skip[b][sw])

        def copies(k):
            row = b * T + k
            return [(s, lpf[row * C + ext[b, s]:row * C + ext[b, s] + 1] if valid[b, s]
                     else np.zeros(1)) for s in sw]

        for k in range(R - 1):
            ring.commit(*((k, copies(k)) if k < n else ()))
        for k in range(n):
            ring.wait(R - 2)
            slot = torch.from_numpy(ring.read(k).astype(np.float32))
            e = torch.where(ok, slot[sw], neg)
            if k == 0:
                a = torch.where(torch.from_numpy(sw <= 1), e, neg)
            else:
                cur = buf[(k - 1) % 2]
                a1 = torch.where(torch.from_numpy(sw >= 1), cur[np.maximum(sw - 1, 0)], neg)
                a2 = torch.where(sk, cur[np.where(skip[b][sw], sw - 2, sw)], neg)
                a = _lse3(cur[sw], a1, a2) + e
            buf[k % 2, sw] = a
            assert torch.equal(buf[k % 2, sw], a)                # a lane past S agrees
            ring.commit(*((k + R - 1, copies(k + R - 1)) if k + R - 1 < n else ()))
            store(b, k, sw, a.numpy())
        fin = buf[(n - 1) % 2]
        c1 = fin[n_states - 1]
        c2 = fin[n_states - 2] if tl > 0 else torch.tensor(neg)
        m = torch.maximum(torch.maximum(torch.tensor(neg), c2), c1)
        ll[b] = (m + torch.log(torch.exp(c2 - m) + torch.exp(c1 - m))).item()
        # thread 0's two loops: the maximum, then the sum in state order
        masked = torch.where(torch.from_numpy(final[b]), fin, neg)
        m_all = torch.tensor(neg)
        for v in masked:
            m_all = torch.maximum(m_all, v)
        terms = torch.exp(masked - m_all).numpy()
        total = np.add.accumulate(np.concatenate([[np.float32(0)], terms]), dtype=np.float32)[-1]
        ll_loops[b] = (m_all + torch.log(torch.tensor(total))).item()
    return alpha, ll, ll_loops, dead_states


@pytest.mark.parametrize("T,lengths,tls,L,C", K5_REPLAY_CASES)
def test_k4_walk_replayed_gives_the_plain_alpha(T, lengths, tls, L, C):
    """K5's cases, the ring 8 slots at every S: lengths 0, 1, R - 1, R,
    R + 1 and T, an empty target, an impossible alignment, S at one warp,
    above 1024 threads and at 4095 (the warps out of the walk with one,
    two and four states a thread)."""
    rng = np.random.default_rng(T + L + 1)
    B = len(lengths)
    x = rng.standard_normal((B, T, C)).astype(np.float32) * 2
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    targets = rng.integers(0, C - 1, (B, L)).astype(np.int32)
    targets[0, 1] = targets[0, 0]                             # a repeat: no skip
    lens, tl = np.array(lengths, np.int32), np.array(tls, np.int32)
    want, want_ll = (a.numpy() for a in ctc_alpha_plain(
        torch.from_numpy(lp), torch.from_numpy(lens), torch.from_numpy(targets),
        torch.from_numpy(tl), C - 1))
    got, got_ll, loops_ll, dead = _k4_replay(lp, lens, targets, tl, C - 1)
    full, full_ll, _, _ = _k4_replay(lp, lens, targets, tl, C - 1, all_walk=True)
    frames = np.arange(T)[None, :] < lens[:, None]
    assert not np.isnan(got[frames]).any() and np.isnan(got[~frames]).all()
    # both in float32, with the same order and functions
    live = frames[:, :, None] & (want > -1e29)
    assert np.all(np.abs(got - want)[live] <= 1e-6 * np.maximum(1.0, np.abs(want[live])))
    assert np.all(np.abs(got_ll - want_ll) <= 1e-6 * np.maximum(1.0, np.abs(want_ll)))
    impossible = (lens > 0) & (want_ll < -1e29)
    assert impossible.any() and np.all(got_ll[impossible] == np.float32(NEG_INF))
    assert np.array_equal(_bits(got_ll), _bits(loops_ll))       # ll from the final lanes
    # the walkers alone give the full recursion's bits, and the constant of
    # the warps out of the walk is what the recursion gives at their states
    assert np.array_equal(_bits(got[frames]), _bits(full[frames]))
    assert np.array_equal(_bits(got_ll), _bits(full_ll))
    at_dead = frames[:, :, None] & dead[:, None, :]
    assert np.array_equal(_bits(got[at_dead]), _bits(want[at_dead]))
    assert dead.any() == (ctc_kernels._threads(2 * L + 1) > 32)
