"""Fused separable convolution kernels: the forward K9 and the backward K10.

K9 replaces ``lightning_asr_tpu/ops/sepconv_pallas.py:80`` ``_fwd_kernel``
(wrapper ``sepconv``) and K10 ``:148`` ``_bwd_kernel``
(``_sepconv_vjp_bwd``): a depthwise k-tap convolution (same padding k//2,
stride 1, odd k) followed by a pointwise 1x1 convolution, the body of every
block of ``QuartNet12Context`` when the model is built with
``conv_kernel="sepconv"`` (``models/layers.py``).  ``sepconv`` is the
``torch.autograd.Function`` that pairs them.

Layout NCT, the port's: x (B, Cin, T), depthwise weight (Cin, 1, k),
pointwise weight (Cout, Cin, 1), y (B, Cout, T).  The kernels read a
channel's frames as one contiguous run; nothing is transposed to the JAX
package's NWC.

Numerics, those of the TPU kernels (x float32 or bf16, the weights cast to
x's type first):

  forward   acc = Σ_j float32(x[t+j-P]·wd[j]) in tap order j = 0..k-1, each
            product taken in x's type (in bf16, rounded to bf16); dw =
            acc rounded to x's type; y = Σ_c wp[o, c]·dw[c] with float32 sums,
            rounded to x's type.
  backward  in float32: dz = wpᵀ·dy; dx[t] = Σ_j dz[t+j-P]·wd[k-1-j], rounded
            to x's type; wd_grad[c, j] = Σ_{b,t} x[t+j-P]·dz[t]; the depthwise
            output recomputed with float32 products, rounded to x's type, as
            dwr; wp_grad = Σ_{b,t} dy·dwrᵀ.  Both weight gradients are summed
            over the batch and returned in float32, not rounded to x's type.

What bounds them on the H100: at B=32, T=836, 512→512, k=87 in bf16, K9
moves ~55 MB (x in, y out: ~16 µs) and does 2·B·T·Cin·(k + Cout) = 16 GFLOP
(~17 µs at the bf16 tensor-core peak); K10 moves ~82 MB (~25 µs) and does
2·B·T·Cin·(2·Cout + 3·k) = 35 GFLOP (~36 µs).  Both sit near the balance
point, so the intermediates must stay on chip and the products want tensor
cores.  K9's depthwise stage cannot use them: its k products per output are
each rounded to bf16 before the float32 sum (the numerics above), 1.2 G
rounded products at the widest layer on the CUDA cores; K10's dx, dwr and
wd_grad, 7 GFLOP of float32 products (dz is float32), stay there too.

What the designs do about it (``csrc/sepconv.cu``).  K9 in bf16, the
instantiation serving and every ``conv_kernel="sepconv"`` step run, takes
one block per (64 frames, row) and 8 warps.  It computes the depthwise
output of all input channels of its tile once into shared memory as bf16,
never to device memory: a thread walks 8 frames of one channel, 8 taps at a
time from registers, each pair of frames' products taken by one
``mul.rn.bf16x2`` (which the card rounds exactly as the plain version
does: ``bf16_product_mismatches``, run by a card test), with the next
pass's window read into registers while it computes.  Then the pointwise
product runs on ``mma.sync`` m16n8k16 tensor cores, bf16 in and float32
sums: ``wp``, packed by ``pack_pointwise`` to (Cout, Cin) with zeros up to
whole 128 x 32 stages, streams through shared memory in a ring of three
``cp.async`` stages, each byte feeding 64 frames; the dw tile feeds ``ldmatrix.trans``;
each warp rounds its 32 x 32 tile of y to bf16 and stages it in shared
memory so that its stores run along T.  The tiles are XOR-swizzled rather
than padded, so that two blocks fit an SM at Cin = 512.  K9 in float32
(the parity checks) keeps the CUDA-core product, a 4 x 4 register tile of
float32 sums a thread over 32 frames: TF32 tensor cores would round its
products.  The input's dtype picks the path.

K10 is five launches.  In bf16, the instantiation every
``conv_kernel="sepconv"`` step runs, its two products, 28 of its 35 GFLOP at
the widest layer, run on ``mma.sync`` as K9's does (bf16 operands, exact
products, float32 sums): dz = wpᵀ·dy with wpᵀ packed by
``pack_pointwise_transposed`` and dy's stages read into registers a stage
ahead, as wide as T's alignment allows (T' = 836 gives 8-byte rows), then
wp_grad = Σ dy·dwrᵀ split over the rows, both operands K-contiguous, dwr
into K10's own buffer with rows padded by zeros to whole 32-frame stages.
Between them, one block per (32 channels, row) walks the frames: each
thread owns 8 frames of a channel and, for each 8-tap block, reads the
window (x in bf16, exact; dz in float32) once for its dx and dwr products
(float32, each product and sum rounded apart in tap order, as the plain
version's) and its 64 wd_grad products, whose per-tap sums the channel's 8
threads reduce by shuffles.  Two fixed-order sums of the partials (over
rows for wd_grad, over the splits for wp_grad) follow, so two runs give the
same bits; no float atomics.  The float32 K10 (the parity checks) keeps the
CUDA-core kernels, which TF32 would otherwise round.  The TPU kernels'
sequential batch grid, which carries the weight gradients in VMEM, becomes
the per-row and per-split partials.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .kernel_build import DTYPE_CODES, SMEM_LIMIT

_LOCK = threading.Lock()
# the bf16 K9's tiles (csrc/sepconv.cu): frames a block, output channels
# and input channels of a wp stage, channels a depthwise pass, wp stages in
# flight
_BT, _BM, _BK, _BXC, _STAGES = 64, 128, 32, 32, 3
_KMAX = 127                 # the bf16 K9's and K10's largest k: taps and window sit in registers
_ZS = 40                    # the bf16 K10 dz: floats a row of a warp's staged tile
_WN = 64                    # the bf16 K10 wp_grad: input channels a tile (x _BM output channels)
_WP_TILE = 64               # csrc/sepconv.cu PT: the float32 wp_grad's tile edge
_WP_BLOCKS = 264            # wp_grad blocks to aim for: two an SM of an H100


def _check(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor):
    """(B, Cin, T, Cout, k) of a valid call; raises on anything the kernels
    do not take."""
    if x.dim() != 3 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be (B, Cin, T) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    B, Cin, T = x.shape
    if wd.dim() != 3 or wd.shape[:2] != (Cin, 1) or wd.shape[2] % 2 == 0:
        raise ValueError(f"wd must be ({Cin}, 1, k) with k odd, got {tuple(wd.shape)}")
    if wp.dim() != 3 or wp.shape[1:] != (Cin, 1):
        raise ValueError(f"wp must be (Cout, {Cin}, 1), got {tuple(wp.shape)}")
    for name, w in (("wd", wd), ("wp", wp)):
        if w.dtype not in (torch.float32, x.dtype):
            raise ValueError(f"{name} must be float32 or {x.dtype}, got {w.dtype}")
    if len({x.device, wd.device, wp.device}) != 1:
        raise ValueError("x, wd and wp must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the sepconv kernels run on cpu or cuda, not {x.device}")
    return B, Cin, T, wp.shape[0], wd.shape[2]


def sepconv_forward_plain(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9, in the kernel's operation order."""
    B, Cin, T = x.shape
    k = wd.shape[-1]
    dt = x.dtype
    w = wd.reshape(Cin, k).to(dt)
    xp = F.pad(x, (k // 2, k // 2))
    acc = torch.zeros((B, Cin, T), dtype=torch.float32, device=x.device)
    for j in range(k):
        acc = acc + (xp[:, :, j:j + T] * w[:, j:j + 1]).float()
    dw = acc.to(dt).float()
    return torch.matmul(wp.reshape(-1, Cin).to(dt).float(), dw).to(dt)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fwd_smem_bytes(Cin: int, k: int) -> int:
    """Dynamic shared memory of one bf16 K9 block, the one statement of
    csrc/sepconv.cu's layout size: the (CinP, 64) dw tile, the (128, 32) wp
    stages, and the larger of the depthwise window with its taps and the
    eight warps' (32, 32) y tiles.  (The float32 K9 sizes its own.)"""
    kp = _round_up(k, 8)
    window = _BXC * (_BT + 2 * kp)
    return 2 * (_round_up(Cin, _BK) * _BT + _STAGES * _BM * _BK + max(window, 8 * 32 * 32))


def pack_pointwise(wp: torch.Tensor) -> torch.Tensor:
    """The bf16 K9's A operand: wp (Cout, Cin, 1) rounded to bf16 as
    (CoutP, CinP), zero-padded to whole 128 x 32 stages."""
    Cout, Cin = wp.shape[0], wp.shape[1]
    w = wp.reshape(Cout, Cin).to(torch.bfloat16)
    pads = (0, _round_up(Cin, _BK) - Cin, 0, _round_up(Cout, _BM) - Cout)
    return F.pad(w, pads).contiguous() if any(pads) else w.contiguous()


def pack_pointwise_transposed(wp: torch.Tensor) -> torch.Tensor:
    """The bf16 K10's dz operand A: wp' (Cin, Cout) rounded to bf16 as
    (CinP, CoutP), zero-padded to whole 128 x 32 stages."""
    return pack_pointwise(wp.transpose(0, 1))


def bwd_smem_bytes(k: int) -> list:
    """Dynamic shared memory of the bf16 K10's blocks, the one statement of
    csrc/sepconv.cu's layouts, in launch order: dz (the ring of (128, 32) wp'
    stages, two (32, 64) dy stages, the eight warps' (32, 40) float32 dz
    tiles); dx/dwr/wd_grad (two windows of 32 channels x (64 + kp) frames,
    dz in float32 and x in bf16, and the float32 taps, flipped taps and
    wd_grad sums of 32 channels x kp); wp_grad (two (128, 32) dy and two
    (64, 32) dwr stages).  (The float32 K10 sizes its own.)"""
    kp = _round_up(k, 8)
    ws = _BT + kp
    dz = 2 * (_STAGES * _BM * _BK + 2 * _BK * _BT) + 4 * 8 * 32 * _ZS
    dw = _BXC * (2 * ws * (4 + 2) + 3 * kp * 4)
    wp_grad = 2 * 2 * (_BM + _WN) * _BK
    return [dz, dw, wp_grad]


def _wp_grad_splits(B: int, Cin: int, Cout: int, dtype: torch.dtype) -> int:
    """The splits of the rows that K10's wp_grad sums apart (then adds in
    order): as many as one wave of blocks takes (a second wave of a few
    blocks would nearly double the time), at most one a row."""
    if dtype == torch.bfloat16:
        tiles = -(-Cout // _BM) * -(-Cin // _WN)
        return max(1, min(B, _WP_BLOCKS // tiles))
    tiles = -(-Cin // _WP_TILE) * -(-Cout // _WP_TILE)
    return max(1, min(B, -(-_WP_BLOCKS // tiles)))


def sepconv_forward(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """K9: x (B, Cin, T) float32 or bf16, wd (Cin, 1, k) with k odd, wp
    (Cout, Cin, 1) -> y (B, Cout, T) in x's type.  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
    B, Cin, T, Cout, k = _check(x, wd, wp)
    if x.device.type == "cpu":
        return sepconv_forward_plain(x, wd, wp)

    from .kernel_build import library

    smem = 0                                   # the float32 K9 sizes its own
    if x.dtype == torch.bfloat16:
        if k > _KMAX:
            raise ValueError(f"the bf16 sepconv forward takes k <= {_KMAX}, got {k}")
        smem = fwd_smem_bytes(Cin, k)
        if smem > SMEM_LIMIT:
            raise ValueError(f"Cin={Cin}, k={k} need {smem} B of shared memory per block "
                             f"(> {SMEM_LIMIT})")
    fn = library("sepconv").lasr_sepconv_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    wd_t = wd.reshape(Cin, k).to(x.dtype).contiguous()
    if x.dtype == torch.bfloat16:
        wp_k = pack_pointwise(wp)
    else:
        wp_k = wp.reshape(Cout, Cin).t().to(x.dtype).contiguous()      # (Cin, Cout)
    y = torch.empty((B, Cout, T), dtype=x.dtype, device=x.device)
    if B and T:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wd_t.data_ptr(), wp_k.data_ptr(), y.data_ptr(), B, Cin, Cout, T, k,
                 DTYPE_CODES[x.dtype], smem, x.device.index, stream)
        if err != 0:
            raise RuntimeError(f"sepconv forward kernel launch failed: CUDA error {err}")
        with _LOCK:
            sepconv_forward.launches += 1
    return y


sepconv_forward.launches = 0


def bf16_product_mismatches(device: torch.device) -> int:
    """The bf16 K9's depthwise stage and the bf16 K11
    (``depthwise_kernels``) take their products two at a time with
    ``mul.rn.bf16x2`` (``bf16x2_mul`` in ``csrc/conv_util.cuh``); that is the
    plain versions' product (float32, exact for bf16 operands, rounded to
    bf16) only if the card rounds the same way.  Runs both on every pair of finite bf16 values and returns how many
    results differ (0 is the premise).  Needs a CUDA device."""
    from .kernel_build import library

    fn = library("sepconv").lasr_bf16_product_mismatches
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    count = torch.zeros(1, dtype=torch.int64, device=device)
    err = fn(count.data_ptr(), device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bf16 product check launch failed: CUDA error {err}")
    return int(count.item())


def sepconv_backward_plain(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor,
                           dy: torch.Tensor):
    """Plain PyTorch version of K10: (dx in x's type, wd_grad (Cin, 1, k)
    float32, wp_grad (Cout, Cin, 1) float32)."""
    B, Cin, T = x.shape
    k = wd.shape[-1]
    P = k // 2
    dt = x.dtype
    w = wd.reshape(Cin, k).to(dt).float()
    p = wp.reshape(-1, Cin).to(dt).float()                          # (Cout, Cin)
    dz = torch.matmul(p.t(), dy.float())                            # (B, Cin, T)
    dzp, xp = F.pad(dz, (P, P)), F.pad(x.float(), (P, P))
    dx = torch.zeros_like(dz)
    dwr = torch.zeros_like(dz)
    taps = []
    for j in range(k):
        xs = xp[:, :, j:j + T]
        dx = dx + dzp[:, :, j:j + T] * w[:, k - 1 - j:k - j]
        taps.append((xs * dz).sum(dim=(0, 2)))
        dwr = dwr + xs * w[:, j:j + 1]
    wp_grad = torch.einsum("bot,bct->oc", dy.float(), dwr.to(dt).float())
    return dx.to(dt), torch.stack(taps, dim=1)[:, None, :], wp_grad[:, :, None]


def sepconv_backward(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor, dy: torch.Tensor):
    """K10: the forward's inputs and dy (B, Cout, T) in x's type -> (dx (B,
    Cin, T) in x's type, wd_grad (Cin, 1, k) float32, wp_grad (Cout, Cin, 1)
    float32).  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel or raises."""
    B, Cin, T, Cout, k = _check(x, wd, wp)
    if tuple(dy.shape) != (B, Cout, T) or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous {(B, Cout, T)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    if x.device.type == "cpu":
        return sepconv_backward_plain(x, wd, wp, dy)

    from .kernel_build import library

    if x.dtype == torch.bfloat16:
        if k > _KMAX:
            raise ValueError(f"the bf16 sepconv backward takes k <= {_KMAX}, got {k}")
        smem = bwd_smem_bytes(k)
        if max(smem) > SMEM_LIMIT:
            raise ValueError(f"k={k} needs {smem} B of shared memory per block (> {SMEM_LIMIT})")
        wp_t = pack_pointwise_transposed(wp)
        TP = _round_up(T, _BK)     # dwr, K10's own buffer: rows padded with zeros to whole stages
    else:                          # the float32 K10 sizes its own shared memory
        smem, wp_t, TP = [0, 0, 0], wp.reshape(Cout, Cin).to(x.dtype).contiguous(), T
    fn = library("sepconv").lasr_sepconv_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_int,
                                                                 ctypes.c_void_p]
    dev = x.device
    S = _wp_grad_splits(B, Cin, Cout, x.dtype)
    wd_t = wd.reshape(Cin, k).to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    wd_grad = torch.zeros((Cin, 1, k), dtype=torch.float32, device=dev)
    wp_grad = torch.zeros((Cout, Cin, 1), dtype=torch.float32, device=dev)
    if B and T:
        dz = torch.empty((B, Cin, T), dtype=torch.float32, device=dev)
        dwr = torch.empty((B, Cin, TP), dtype=x.dtype, device=dev)
        wd_part = torch.empty((B, Cin, k), dtype=torch.float32, device=dev)
        wp_part = torch.empty((S, Cout, Cin), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), wd_t.data_ptr(), wp_t.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 wd_grad.data_ptr(), wp_grad.data_ptr(), dz.data_ptr(), dwr.data_ptr(),
                 wd_part.data_ptr(), wp_part.data_ptr(), B, Cin, Cout, T, TP, k, S,
                 DTYPE_CODES[x.dtype], (ctypes.c_int * 3)(*smem), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"sepconv backward kernel launch failed: CUDA error {err}")
        with _LOCK:
            sepconv_backward.launches += 1
    else:
        dx.zero_()
    return dx, wd_grad, wp_grad


sepconv_backward.launches = 0


class _SepConv(torch.autograd.Function):
    """y = K9(x, wd, wp), with K10 as its backward."""

    @staticmethod
    def forward(ctx, x, wd, wp):
        ctx.save_for_backward(x, wd, wp)
        return sepconv_forward(x, wd, wp)

    @staticmethod
    def backward(ctx, dy):
        x, wd, wp = ctx.saved_tensors
        dx, wd_grad, wp_grad = sepconv_backward(x, wd, wp, dy.contiguous())
        return dx, wd_grad.to(wd.dtype), wp_grad.to(wp.dtype)


def sepconv(x: torch.Tensor, wd: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The separable convolution as autograd sees it: x (B, Cin, T) in the
    compute type, wd (Cin, 1, k) and wp (Cout, Cin, 1) the float32
    parameters, which receive float32 gradients."""
    return _SepConv.apply(x, wd, wp)
