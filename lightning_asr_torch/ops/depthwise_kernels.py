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

What bounds it on the H100: bytes, then the instructions of its products.  At
B=32, T=836, C=512, k=87 in bf16 it reads x and dy once (55 MB, ~16 µs)
and forms 1.19 G products, each rounded to bf16 before its float32 sum
(2.4 GFLOP, ~2.4 µs at the bf16 tensor-core peak): on the CUDA cores alone
at ~6 instructions a product that is ~0.2 ms of instruction slots.

What the bf16 design does about it (``csrc/depthwise.cu``).  One block per
(8 channels, row), one warp a channel and no block barrier: each warp walks
its row in 256-frame chunks, reading the next chunk's window of x (with
the taps' reach, zeros outside [0, T)) and its dy into registers while it
computes the current one, as wide as T and the pointers allow (T' = 836
gives 8-byte rows), and stages them in its own shared memory in bf16.  The
time sum runs on the tensor cores as the TPU kernel's does (it sums each
tap's products with a ones-row matmul): ``mma.sync`` m16n8k16 with the
products as A (taps on M, 16 a tile; frames on K, 16 a step), B = bf16
ones and float32 sums.  A lane builds its four A registers from three x
pairs, each one 32-bit word of the chunk's array of pairs (x[e], x[e+1])
at every window element e, built once a chunk so that odd taps cost no
byte permute, and two dy pairs that stay in registers across the tap tiles, each pair product by ``mul.rn.bf16x2``,
which rounds as the plain version does (``bf16_product_mismatches``); a
product enters the sum as 1.0·p, exactly.  The tensor cores' float32 sums
are not rounded to nearest, so each (chunk, tile) starts from zero and its
256-frame sums are added to the row's totals in shared memory with ordinary
float32 adds, in chunk order.  Each row's totals are written once and a
second launch sums them over the rows in a fixed order, so two calls give
the same bits and no float atomics are used.  The float32 kernel (the
parity checks) keeps the CUDA-core design: one block per (32 channels,
row), the chunk staged in float32 and each (c, j) owned by one thread.
The input's dtype picks the path; ``wgrad_smem_bytes`` states each block's
shared memory.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .kernel_build import DTYPE_CODES, SMEM_LIMIT

_LOCK = threading.Lock()
_CHUNK = 256                # frames a chunk (csrc/depthwise.cu TC, the TPU kernel's _CHUNK_T)
_WARPS = 8                  # the bf16 kernel's channels a block, one a warp
_F32_CHANNELS = 32          # the float32 kernel's channels a block
_KMAX = 127                 # the bf16 kernel's largest k: its window loads sit in registers


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


def wgrad_smem_bytes(k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one K11 block, the one statement of
    csrc/depthwise.cu's layouts.  bf16: each of the 8 warps' window of x
    (the chunk + 16 per tile of 16 taps + 16) and chunk of dy in bf16, then
    their windows' pairs (a 32-bit word at each element but the last 8),
    then their float32 totals (16 per tile).  float32: 32 channels' window of x
    (the chunk + 2·(k//2)), chunk of dy and k totals."""
    if dtype == torch.bfloat16:
        tiles = -(-k // 16)
        window = _CHUNK + 16 * tiles + 16
        return _WARPS * (2 * (window + _CHUNK) + 4 * (window - 8) + 4 * 16 * tiles)
    return 4 * _F32_CHANNELS * (2 * _CHUNK + 2 * (k // 2) + k)


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

    if x.dtype == torch.bfloat16 and k > _KMAX:
        raise ValueError(f"the bf16 depthwise weight gradient takes k <= {_KMAX}, got {k}")
    smem = wgrad_smem_bytes(k, x.dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"k={k} needs {smem} B of shared memory per block (> {SMEM_LIMIT})")
    fn = library("depthwise").lasr_dw_wgrad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    if not (B and T):
        return torch.zeros((C, 1, k), dtype=torch.float32, device=x.device)
    out = torch.empty((C, 1, k), dtype=torch.float32, device=x.device)   # sum_partials writes it all
    part = torch.empty((B, C, k), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(), part.data_ptr(), B, C, T, k,
             DTYPE_CODES[x.dtype], smem, x.device.index, stream)
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
