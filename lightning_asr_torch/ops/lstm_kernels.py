"""LSTM recurrence kernels: the forward K2 and the backward (BPTT) K3, both
directions in one launch each.

K2 replaces ``lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel`` and K3
``::_bwd_kernel`` (each launched once per direction by ``_run_fwd`` /
``_core_bwd`` under ``lstm_pallas``), the context BiLSTM of
``QuartNet12Context``.  The input projection ``x·W_ihᵀ + b_ih + b_hh`` and
its gradients (``dx``, ``dW_ih``, ``db``) stay outside, one matmul each for
all frames and both directions (``ops/lstm.py``); ``lstm_core`` is the
``torch.autograd.Function`` between them.

Semantics (``pack_padded_sequence`` parity): gate order i, f, g, o; the
forward direction runs t = 0..len-1, the reverse direction t = len-1..0 from
zero state; output frames t >= len are exactly 0.  For training K2 also
stores each valid frame's cell state c (exact zeros at pad frames); K3
takes ``h_prev`` / ``c_prev`` as the previous valid frame's h and c in the
walk order (zero at the first), recomputes the gates from ``xproj`` and
``h_prev``, and walks the valid frames in reverse, so its carries pass pad
frames untouched and its ``d_xproj`` is exactly 0 there.

What bounds them on the H100: not bytes (K2 reads the projections and
writes h, ~10 MB at B=8, T=801: ~3 µs; K3 at B=32, T=836 moves ~60 MB:
~18 µs) nor flops (2·4H·H a step forward, three times that backward), but
latency: each direction is ``len`` dependent steps, each a 40-term dot, a
gate nonlinearity and a state update (K3: two dots more and a reduction
across the four gate groups).

What the designs do about it (``csrc/lstm.cu``, ``csrc/lstm_bwd.cu``): one
block per (row, direction), all rows and both directions in one launch, so
the chains run in parallel; thread g keeps W_hh's row g in registers and h
sits in shared memory, so a step touches device memory only for its own
frame; rows stop at their own length.  K3 also keeps W_hh in shared memory
(25.6 KB) for ``dh_prev[k] = Σ_g dgates[g]·W_hh[g, k]``, split over all 4H
threads as four 40-term partial dots, and accumulates ``dW_hh[g, :] +=
dgates[g]·h_prev`` in thread g's 40 registers across the whole walk; the
per-(row, direction) partials are summed over the batch in a fixed order
(deterministic).  The TPU kernels' 128-lane padding of H, their 32-step
time blocks and the 32-row batch tiling (a VMEM cap) do not carry over.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_LOCK = threading.Lock()
_KERNEL_HIDDEN = (40,)      # hidden sizes instantiated in csrc/lstm.cu


def _walk_valid(T: int, lengths: torch.Tensor, d: int) -> torch.Tensor:
    """(T, B) validity of the walk positions of direction d: direction 1
    walks the time-flipped padded batch, its valid frames last."""
    t_idx = torch.arange(T, device=lengths.device)
    if d == 1:
        return (T - 1 - t_idx)[:, None] < lengths[None, :]
    return t_idx[:, None] < lengths[None, :]


def _walk(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, T, ...) in the walk order of direction d (its own inverse)."""
    return torch.flip(x, dims=(1,)) if d == 1 else x


def _gates(xp_t: torch.Tensor, h: torch.Tensor, w: torch.Tensor, H: int):
    i, f, g, o = (xp_t + h @ w.t()).split(H, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_recurrence_plain(xproj: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor,
                          with_cell: bool = False):
    """Plain PyTorch version of K2, a masked step loop per direction
    (``lightning_asr_tpu/ops/lstm.py::_direction``): the reverse direction
    runs over the time-flipped padded batch, keeping its state at zero until
    the row's last true frame.  Returns h, or (h, c) with ``with_cell``."""
    B, T, D, G = xproj.shape
    H = G // 4
    hs, cs = [], []
    for d in range(D):
        xp = _walk(xproj[:, :, d], d)
        valid = _walk_valid(T, lengths, d)
        h = xproj.new_zeros((B, H))
        c = xproj.new_zeros((B, H))
        h_steps, c_steps = [], []
        for t in range(T):
            i, f, g, o = _gates(xp[:, t], h, w_hh[d], H)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            v = valid[t][:, None]
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            h_steps.append(torch.where(v, h_new, torch.zeros_like(h_new)))
            c_steps.append(torch.where(v, c_new, torch.zeros_like(c_new)))
        hs.append(_walk(torch.stack(h_steps, dim=1), d))              # (B, T, H)
        cs.append(_walk(torch.stack(c_steps, dim=1), d))
    h = torch.cat(hs, dim=-1)
    return (h, torch.stack(cs, dim=2)) if with_cell else h


def _check_recurrence_args(xproj, lengths, w_hh):
    if xproj.dim() != 4 or xproj.shape[2] not in (1, 2) or xproj.shape[3] % 4:
        raise ValueError(f"xproj must be (B, T, D in {{1, 2}}, 4H), got {tuple(xproj.shape)}")
    B, T, D, G = xproj.shape
    H = G // 4
    if tuple(w_hh.shape) != (D, G, H):
        raise ValueError(f"w_hh must be {(D, G, H)}, got {tuple(w_hh.shape)}")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({B},) int32, got {tuple(lengths.shape)} {lengths.dtype}")
    for name, t in (("xproj", xproj), ("w_hh", w_hh)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if len({xproj.device, lengths.device, w_hh.device}) != 1:
        raise ValueError("xproj, lengths and w_hh must be on one device")
    if xproj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the LSTM kernels run on cpu or cuda, not {xproj.device}")
    if xproj.device.type == "cuda" and H not in _KERNEL_HIDDEN:
        raise ValueError(f"the LSTM kernels are built for hidden sizes {_KERNEL_HIDDEN}, got {H}")
    return B, T, D, G, H


def lstm_recurrence(xproj: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor,
                    with_cell: bool = False):
    """K2: xproj (B, T, D, 4H) float32 gate projections (biases folded in),
    lengths (B,) int32, w_hh (D, 4H, H) float32 -> h (B, T, D·H), direction
    1 (when D == 2) reversed; with ``with_cell`` also c (B, T, D, H), the
    cell state of each valid frame (0 at pad frames).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
    B, T, D, G, H = _check_recurrence_args(xproj, lengths, w_hh)
    if xproj.device.type == "cpu":
        return lstm_recurrence_plain(xproj, lengths, w_hh, with_cell)

    from .kernel_build import library

    fn = library("lstm").lasr_lstm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = torch.empty((B, T, D * H), dtype=torch.float32, device=xproj.device)
    cell = torch.empty((B, T, D, H), dtype=torch.float32, device=xproj.device) if with_cell else None
    if B and T:
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                 cell.data_ptr() if with_cell else None, B, T, D, H, xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"LSTM kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_recurrence.launches += 1
    return (out, cell) if with_cell else out


lstm_recurrence.launches = 0


def lstm_backward_plain(xproj: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor,
                        h: torch.Tensor, c: torch.Tensor, grad_h: torch.Tensor):
    """Plain PyTorch version of K3, the TPU kernel's masked reverse loop over
    the whole padded walk (``lstm_pallas.py::_bwd_kernel``): pad frames give
    zero gate gradients and pass the carries on.  Returns (d_xproj (B, T, D,
    4H), dW_hh (D, 4H, H))."""
    B, T, D, G = xproj.shape
    H = G // 4
    dxs, dws = [], []
    for d in range(D):
        xp = _walk(xproj[:, :, d], d)
        gd = _walk(grad_h[:, :, d * H:(d + 1) * H], d)
        # h_prev / c_prev: the previous walk position's h and c; the forward
        # stores zeros at pad frames, so a row's first valid frame reads zeros
        zero = xproj.new_zeros((B, 1, H))
        h_prev = torch.cat([zero, _walk(h[:, :, d * H:(d + 1) * H], d)[:, :-1]], dim=1)
        c_prev = torch.cat([zero, _walk(c[:, :, d], d)[:, :-1]], dim=1)
        valid = _walk_valid(T, lengths, d).to(xproj.dtype)
        dh_c = xproj.new_zeros((B, H))
        dc_c = xproj.new_zeros((B, H))
        dw = xproj.new_zeros((G, H))
        steps = [None] * T
        for t in reversed(range(T)):
            i, f, g, o = _gates(xp[:, t], h_prev[:, t], w_hh[d], H)
            tc = torch.tanh(f * c_prev[:, t] + i * g)
            v = valid[t][:, None]
            dh = (gd[:, t] + dh_c) * v
            dc = dc_c * v + dh * o * (1.0 - tc * tc)
            dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev[:, t] * f * (1.0 - f),
                                dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
            steps[t] = dgates
            dw = dw + dgates.t() @ h_prev[:, t]
            dh_c = dgates @ w_hh[d] + dh_c * (1.0 - v)
            dc_c = dc * f + dc_c * (1.0 - v)
        dxs.append(_walk(torch.stack(steps, dim=1), d))
        dws.append(dw)
    return torch.stack(dxs, dim=2), torch.stack(dws)


def lstm_backward(xproj: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor, grad_h: torch.Tensor):
    """K3: the forward's inputs, its h (B, T, D·H) and c (B, T, D, H), and
    the gradient of h -> (d_xproj (B, T, D, 4H), exactly 0 at pad frames;
    dW_hh (D, 4H, H)).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    B, T, D, G, H = _check_recurrence_args(xproj, lengths, w_hh)
    for name, t, shape in (("h", h, (B, T, D * H)), ("c", c, (B, T, D, H)),
                           ("grad_h", grad_h, (B, T, D * H))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != xproj.device:
            raise ValueError(f"{name} is on {t.device}, xproj on {xproj.device}")
    if xproj.device.type == "cpu":
        return lstm_backward_plain(xproj, lengths, w_hh, h, c, grad_h)

    from .kernel_build import library

    fn = library("lstm_bwd").lasr_lstm_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    d_xproj = torch.empty_like(xproj)
    dw_part = torch.empty((B, D, G, H), dtype=torch.float32, device=xproj.device)
    if B and T:
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), h.data_ptr(),
                 c.data_ptr(), grad_h.data_ptr(), d_xproj.data_ptr(), dw_part.data_ptr(),
                 B, T, D, H, xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"LSTM backward kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_backward.launches += 1
    else:
        dw_part.zero_()
    return d_xproj, dw_part.sum(dim=0)


lstm_backward.launches = 0


class _LSTMCore(torch.autograd.Function):
    """h = K2(xproj, lengths, w_hh), with K3 as its backward."""

    @staticmethod
    def forward(ctx, xproj, lengths, w_hh):
        h, c = lstm_recurrence(xproj, lengths, w_hh, with_cell=True)
        ctx.save_for_backward(xproj, lengths, w_hh, h, c)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        xproj, lengths, w_hh, h, c = ctx.saved_tensors
        d_xproj, dw_hh = lstm_backward(xproj, lengths, w_hh, h, c, grad_h.contiguous())
        return d_xproj, None, dw_hh


def lstm_core(xproj: torch.Tensor, lengths: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence as autograd sees it: K2 alone when no gradient is
    needed (serving stores no cell states), K2 with cell states and K3 as
    its backward when one is."""
    if torch.is_grad_enabled() and (xproj.requires_grad or w_hh.requires_grad):
        return _LSTMCore.apply(xproj, lengths, w_hh)
    return lstm_recurrence(xproj, lengths, w_hh)
