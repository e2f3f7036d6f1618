"""LSTM forward recurrence kernel K2, both directions in one launch.

Replaces ``lightning_asr_tpu/ops/lstm_pallas.py::_fwd_kernel`` (launched once
per direction by ``_run_fwd`` under ``lstm_pallas``), the context BiLSTM of
``QuartNet12Context``.  The input projection ``x·W_ihᵀ + b_ih + b_hh`` stays
outside, one matmul for all frames and both directions (``ops/lstm.py``).

Semantics (``pack_padded_sequence`` parity): gate order i, f, g, o; the
forward direction runs t = 0..len-1, the reverse direction t = len-1..0 from
zero state; output frames t >= len are exactly 0.

What bounds it on the H100: not bytes (the projections in and h out are
~10 MB at B=8, T=801: ~3 µs) nor flops (2·4H·H a step, ~0.1 GFLOP), but
latency: each direction is ``len`` dependent steps, each a 40-term dot, a
gate nonlinearity and a state update.

What the design does about it (``csrc/lstm.cu``): one block per (row,
direction), all rows and both directions in one launch, so the chains run in
parallel; W_hh's row for each gate sits in that thread's registers and h in
shared memory, so a step touches device memory only for its own projection
(prefetched a step ahead) and its h output; two barriers a step; rows stop
at their own length.  The TPU kernel's 128-lane padding of H and its
32-step / 32-row tiling do not carry over.  This slice serves only, so the
kernel stores no h/c residuals for a backward pass.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_LOCK = threading.Lock()
_KERNEL_HIDDEN = (40,)      # hidden sizes instantiated in csrc/lstm.cu


def lstm_recurrence_plain(xproj: torch.Tensor, lengths: torch.Tensor,
                          w_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2, a masked step loop per direction
    (``lightning_asr_tpu/ops/lstm.py::_direction``): the reverse direction
    runs over the time-flipped padded batch, keeping its state at zero until
    the row's last true frame."""
    B, T, D, G = xproj.shape
    H = G // 4
    t_idx = torch.arange(T, device=xproj.device)
    outs = []
    for d in range(D):
        xp = xproj[:, :, d]
        if d == 1:
            xp = torch.flip(xp, dims=(1,))
            valid = (T - 1 - t_idx)[:, None] < lengths[None, :]     # (T, B)
        else:
            valid = t_idx[:, None] < lengths[None, :]
        h = xproj.new_zeros((B, H))
        c = xproj.new_zeros((B, H))
        steps = []
        for t in range(T):
            gates = xp[:, t] + h @ w_hh[d].t()
            i, f, g, o = gates.split(H, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            v = valid[t][:, None]
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            steps.append(torch.where(v, h_new, torch.zeros_like(h_new)))
        out = torch.stack(steps, dim=1)                             # (B, T, H)
        outs.append(torch.flip(out, dims=(1,)) if d == 1 else out)
    return torch.cat(outs, dim=-1)


def lstm_recurrence(xproj: torch.Tensor, lengths: torch.Tensor,
                    w_hh: torch.Tensor) -> torch.Tensor:
    """xproj (B, T, D, 4H) float32 gate projections (biases folded in),
    lengths (B,) int32, w_hh (D, 4H, H) float32 -> h (B, T, D·H), direction
    1 (when D == 2) reversed.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel or raises."""
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
    if xproj.device.type == "cpu":
        return lstm_recurrence_plain(xproj, lengths, w_hh)
    if xproj.device.type != "cuda":
        raise ValueError(f"lstm_recurrence runs on cpu or cuda, not {xproj.device}")
    if H not in _KERNEL_HIDDEN:
        raise ValueError(f"the LSTM kernel is built for hidden sizes {_KERNEL_HIDDEN}, got {H}")

    from .kernel_build import library

    fn = library("lstm").lasr_lstm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = torch.empty((B, T, D * H), dtype=torch.float32, device=xproj.device)
    if B and T:
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(),
                 out.data_ptr(), B, T, D, H, xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"LSTM kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
