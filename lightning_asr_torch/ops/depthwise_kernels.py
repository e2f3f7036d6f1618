"""Depthwise-convolution weight gradient kernel K11.

Replaces ``lightning_asr_tpu/ops/depthwise_pallas.py::_wgrad_kernel``
(wrapper ``_wgrad_pallas`` under ``depthwise_conv1d``), the weight gradient
of every block's depthwise convolution (same padding k//2, stride 1, odd k)
when the model is built with ``conv_kernel="dw_wgrad"``
(``models/layers.py``):

    dw[c, j] = Σ_{b,t} x[b, c, t+j-P] · dy[b, c, t]

``depthwise_conv`` is the ``torch.autograd.Function`` around it.  Its
forward and its input gradient stay ``F.conv1d``, as the JAX package leaves
them to XLA's conv emitter outside any Pallas kernel
(``depthwise_pallas.py:160-187``).

Numerics, the TPU kernel's: each product in the input type (in bf16,
rounded to bf16), summed in float32 over t in 256-frame chunks, the chunks'
sums added in order; here each row's total is formed first and the rows'
totals are then added in order.  The result is float32; ``depthwise_conv``
casts it to the weight's type, and the model passes the weight already cast
to the compute type, as JAX does (``layers.py:154``), so in a bf16 model the
gradient is rounded to bf16 before it reaches the float32 parameter.

What bounds it on the H100: bytes.  At B=32, T=836, C=512, k=87 in bf16 it
reads x and dy once (55 MB, ~16 µs) and does 2·B·T·C·k = 2.4 GFLOP (~2.4
µs at the bf16 peak).  What the design does about it (``csrc/depthwise.cu``):
one block per (32 channels, row) stages a 256-frame chunk of x (with its
halo) and dy in shared memory once and forms all k taps from it, so each
input byte is read from device memory once; the thread that owns (c, j)
keeps its running total in shared memory, each row's totals are written
once, and a second launch sums them over the rows in a fixed order (the TPU
kernel carries one sum across its sequential grid; blocks here have no
order).
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .kernel_build import DTYPE_CODES, SMEM_LIMIT

_LOCK = threading.Lock()
_CHUNK = 256                # frames a chunk (csrc/depthwise.cu TC, the TPU kernel's _CHUNK_T)


def _check(x: torch.Tensor, dy: torch.Tensor, k: int):
    if x.dim() != 3 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be (B, C, T) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("x and dy must be contiguous")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be odd, got {k}")
    if x.device != dy.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_wgrad runs on cpu or cuda, not {x.device}")
    return x.shape


def depthwise_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of K11, in the kernel's summation order up to
    the order within a chunk."""
    B, C, T = x.shape
    P, n = k // 2, -(-T // _CHUNK)
    xp = F.pad(x, (P, P + n * _CHUNK - T))
    dyp = F.pad(dy, (0, n * _CHUNK - T))
    sums = torch.stack([(xp[:, :, j:j + n * _CHUNK] * dyp).float().reshape(B, C, n, _CHUNK).sum(-1)
                        for j in range(k)], dim=-1)                 # (B, C, n, k)
    out = torch.zeros((C, k), dtype=torch.float32, device=x.device)
    for b in range(B):
        row = torch.zeros_like(out)
        for i in range(n):
            row = row + sums[b, :, i]
        out = out + row
    return out[:, None, :]


def depthwise_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """K11: x and dy (B, C, T) float32 or bf16, k odd -> (C, 1, k) float32.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    B, C, T = _check(x, dy, k)
    if x.device.type == "cpu":
        return depthwise_wgrad_plain(x, dy, k)

    from .kernel_build import library

    lib = library("depthwise")
    lib.lasr_dw_wgrad_smem.restype = ctypes.c_size_t
    lib.lasr_dw_wgrad_smem.argtypes = [ctypes.c_int]
    smem = lib.lasr_dw_wgrad_smem(k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"k={k} needs {smem} B of shared memory per block (> {SMEM_LIMIT})")
    fn = lib.lasr_dw_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = torch.zeros((C, 1, k), dtype=torch.float32, device=x.device)
    if B and T:
        part = torch.empty((B, C, k), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), part.data_ptr(), B, C, T, k,
                 DTYPE_CODES[x.dtype], x.device.index, stream)
        if err != 0:
            raise RuntimeError(f"depthwise weight-gradient kernel launch failed: CUDA error {err}")
        with _LOCK:
            depthwise_wgrad.launches += 1
    return out


depthwise_wgrad.launches = 0


class _DepthwiseConv(torch.autograd.Function):
    """Stride-1 same-padded depthwise conv: ``F.conv1d`` forward and input
    gradient, K11 as the weight gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv1d(x, w, None, 1, w.shape[-1] // 2, 1, x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        k = w.shape[-1]
        dx = (F.conv1d(dy, w.flip(-1), None, 1, k // 2, 1, x.shape[1])
              if ctx.needs_input_grad[0] else None)
        dw = depthwise_wgrad(x, dy, k).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, C, T), w (C, 1, k) with k odd, both in the compute type ->
    (B, C, T): the depthwise half of a separable block, whose weight
    gradient is K11."""
    if w.dim() != 3 or w.shape[:2] != (x.shape[1], 1) or w.shape[2] % 2 == 0:
        raise ValueError(f"w must be ({x.shape[1]}, 1, k) with k odd, got {tuple(w.shape)}")
    return _DepthwiseConv.apply(x, w)
