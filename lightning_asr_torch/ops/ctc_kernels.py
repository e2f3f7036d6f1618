"""CTC alpha kernel K4 and beta + gradient kernel K5, and ``ctc_loss``, the
``torch.autograd.Function`` over them that the training step uses.

K4 replaces ``lightning_asr_tpu/ops/ctc_pallas.py::_alpha_kernel`` (launched
by ``_ctc_forward``) and K5 ``::_beta_kernel`` (launched by ``_ctc_bwd``),
the loss of ``make_train_step``.  Semantics are those of
``ctc_loss_pallas``: blank = any index (the reference uses the last),
``reduction='none'``; the sentinel is the finite ``NEG_INF = -1e30``; alpha_0
is the emission at states 0 and 1 (state 1 invalid for an empty target);
the skip transition s-2 -> s needs ``label ≠ blank ∧ label ≠ label[s-2]``
and a valid state; ``ll`` is the log-sum-exp of alpha at ``t = len-1`` over
the final states (2·tl, and 2·tl-1 when tl > 0); rows with ``input_lengths
== 0`` have loss 0 and zero gradient; ``grad_emit[t, s] = -g·exp(alpha_t(s)
+ beta_t(s) - ll)`` with beta excluding the emission of its own frame.  The
gradient reaches the classes outside the kernels, as the JAX package leaves
that scatter to XLA: one float32 batched matmul of ``grad_emit`` with the
(B, S, C) one-hot of the state labels, which sums each class's states in a
fixed order.  It is exact only while float32 matmuls do not run in TF32;
``make_train_step`` pins that on a CUDA model.

What bounds them on the H100: at the training shape (B=32, T=836 frames,
S=513 states, C=29) alpha is 32·836·513·4 B = 55 MB, written by K4 and read
by K5, and ``grad_emit`` as much again: the byte bound is ~0.05 ms a
kernel, the arithmetic (three exp and a log per state and frame) less.
Their real limit is the 836 dependent steps of each recursion.

What the design does about it (``csrc/ctc.cu``): one block per row, all
rows in one launch, threads over the states (up to four states a thread);
the recursion vector is double-buffered in shared memory with one barrier a
step; rows stop at their own length, and K4 stores alpha only for valid
frames.  Both walks keep only their chain between barriers: each step's
emissions, gathered through the states' labels (never a whole log-prob
row, which holds 4334 floats for AISHELL-1, and no row that an earlier
step has touched, so a load there would wait on L2), and for K5 the step's
alpha row, arrive in a ring of dynamic shared memory by four-byte
``cp.async`` copies, ring − 1 steps ahead, each thread copying and reading
only its own states, so the walk loads nothing from device memory.  K4's
ring has ``ALPHA_RING`` slots of S floats at every S
(``ctc_alpha_smem_bytes``), K5's ``ctc_beta_ring(S)`` slots of 2S
(``ctc_beta_smem_bytes``).  A step has no branch (a lane past S takes
state S − 1 whole), so what is off the chain interleaves with it: K4's
alpha store and next copies, K5's previous gradient (its ``expf`` and
store); each walk is unrolled by its (even) ring so that slots and buffers
are fixed addresses.  Warps whose states all lie past the row's last valid
state leave the walk and its barrier to the others: in K4 their alpha is
the constant the recursion gives there (NEG_INF at t = 0, NEG_INF +
NEG_INF after), which they store; in K5 their u is the constant ``NEG_INF
+ NEG_INF`` and they write their gradient from alpha directly.  K4 takes
``ll`` from the two final states alone, in the order of the sum over all
states (the others' terms are exactly 0, or the result NEG_INF either
way).  Neither kernel builds a (B, T, S) emission tensor.  The TPU
kernels' 128-lane rounding of S, their 32-step time blocks and their batch
tiling (a VMEM cap) do not carry over.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .ctc import NEG_INF, extended_labels, lse3, shift_right
from .kernel_build import SMEM_LIMIT

_LOCK = threading.Lock()
_MAX_PER_THREAD = 4          # states a thread owns (csrc/ctc.cu instantiates PER 1 to 4)
_MAX_THREADS = 1024
ALPHA_RING = 8               # K4's ring slots at every S (csrc/ctc.cu ctc_alpha_kernel)
BETA_RING = 8                # K5's ring slots where they fit (csrc/ctc.cu ctc_beta_kernel)


def ctc_alpha_smem_bytes(S: int) -> int:
    """K4's dynamic shared memory, the one statement of its layout
    (csrc/ctc.cu): the ring of ``ALPHA_RING`` slots, each a step's S
    emissions, then the two buffers of alpha; 163,800 B at S = 4095, the
    largest S the wrapper takes, within ``SMEM_LIMIT``."""
    return 4 * (ALPHA_RING * S + 2 * S)


def ctc_beta_ring(S: int) -> int:
    """Slots of K5's ring for S states: ``BETA_RING``, or the most that fit
    ``SMEM_LIMIT`` beside the recursion buffer, rounded down to even (the
    walk is unrolled by the ring, and a step's buffers alternate): 6 from
    S = 3229 to 4095, the largest S the wrapper takes."""
    return min(BETA_RING, (SMEM_LIMIT // 4 - 2 * S) // (2 * S) // 2 * 2)


def ctc_beta_smem_bytes(S: int) -> int:
    """K5's dynamic shared memory, the one statement of its layout
    (csrc/ctc.cu): the ring, each slot a step's emissions [0, S) and alpha
    row [S, 2S), then the two buffers of the recursion vector u."""
    return 4 * (ctc_beta_ring(S) * 2 * S + 2 * S)


def lattice(targets: torch.Tensor, target_lengths: torch.Tensor, blank_id: int):
    """(ext (B, S) int64 labels, valid (B, S), skip (B, S), final (B, S)) of
    the extended-state lattice, as ``ctc_loss_pallas`` builds them."""
    ext = extended_labels(targets, blank_id)
    B, S = ext.shape
    n_states = 2 * target_lengths.to(device=ext.device, dtype=torch.int64)[:, None] + 1
    s_idx = torch.arange(S, device=ext.device)[None, :]
    valid = s_idx < n_states
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], blank_id), ext[:, :-2]], dim=1)
    skip = (ext != blank_id) & (ext != ext_m2) & valid
    final = (s_idx == n_states - 1) | ((s_idx == n_states - 2) & (n_states > 1))
    return ext, valid, skip, final


def _emissions(log_probs: torch.Tensor, ext: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, T, S): log_probs at each state's label, NEG_INF at invalid states."""
    B, T, _ = log_probs.shape
    e = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, ext.shape[1]))
    return torch.where(valid[:, None, :], e, torch.full_like(e, NEG_INF))


def _final_ll(alpha: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    masked = torch.where(final, alpha, torch.full_like(alpha, NEG_INF))
    m = torch.max(masked, dim=1, keepdim=True).values
    return (m + torch.log(torch.sum(torch.exp(masked - m), dim=1, keepdim=True)))[:, 0]


def ctc_alpha_plain(log_probs, input_lengths, targets, target_lengths, blank_id: int):
    """Plain PyTorch version of K4, the TPU kernel's recursion over the
    padded time axis with per-row freezing.  Returns (alpha (B, T, S), ll
    (B,)); alpha at frames t >= len holds the frozen state (the kernel
    leaves those frames unwritten)."""
    B, T, _ = log_probs.shape
    ext, valid, skip, final = lattice(targets, target_lengths, blank_id)
    emit = _emissions(log_probs, ext, valid)
    lens = input_lengths.to(torch.int64).clamp(0, T)
    s_idx = torch.arange(ext.shape[1], device=ext.device)[None, :]
    alpha = torch.where(s_idx <= 1, emit[:, 0], torch.full_like(emit[:, 0], NEG_INF))
    steps = [alpha]
    for t in range(1, T):
        a_m2 = torch.where(skip, shift_right(alpha, 2), torch.full_like(alpha, NEG_INF))
        new = lse3(alpha, shift_right(alpha), a_m2) + emit[:, t]
        alpha = torch.where((t < lens)[:, None], new, alpha)
        steps.append(alpha)
    # alpha is frozen from t = len-1 on, so the last step holds it
    ll = torch.where(lens > 0, _final_ll(alpha, final), torch.full_like(alpha[:, 0], NEG_INF))
    return torch.stack(steps, dim=1), ll


def ctc_beta_plain(log_probs, input_lengths, targets, target_lengths, alpha, ll, gbar,
                   blank_id: int) -> torch.Tensor:
    """Plain PyTorch version of K5: the beta recursion in reverse time over
    the padded axis, carrying u_t = beta_t + emit_t, and the emission
    gradient ``-gbar·exp((alpha + beta) - ll)``, 0 at frames t >= len."""
    B, T, _ = log_probs.shape
    ext, valid, skip, final = lattice(targets, target_lengths, blank_id)
    emit = _emissions(log_probs, ext, valid)
    lens = input_lengths.to(torch.int64).clamp(0, T)
    skip2 = torch.cat([skip[:, 2:], torch.zeros_like(skip[:, :2])], dim=1)     # skip[s+2]
    neg = torch.full_like(emit[:, 0], NEG_INF)
    init = torch.where(final, torch.zeros_like(neg), neg)
    u = neg
    grads = [None] * T
    for t in reversed(range(T)):
        u1 = torch.cat([u[:, 1:], neg[:, :1]], dim=1)
        u2 = torch.where(skip2, torch.cat([u[:, 2:], neg[:, :2]], dim=1), neg)
        beta = lse3(u, u1, u2)
        beta = torch.where((t == lens - 1)[:, None], init, beta)
        live = (t < lens)[:, None]
        beta = torch.where(live, beta, neg)
        g = -gbar[:, None] * torch.exp((alpha[:, t] + beta) - ll[:, None])
        grads[t] = torch.where(live, g, torch.zeros_like(g))
        u = torch.where(live, beta + emit[:, t], u)
    return torch.stack(grads, dim=1)


def _check(log_probs, input_lengths, targets, target_lengths, blank_id):
    if log_probs.dim() != 3 or log_probs.dtype != torch.float32 or not log_probs.is_contiguous():
        raise ValueError(f"log_probs must be contiguous float32 (B, T, C), got "
                         f"{tuple(log_probs.shape)} {log_probs.dtype}")
    B, T, C = log_probs.shape
    if targets.dim() != 2 or targets.shape[0] != B or targets.dtype != torch.int32 \
            or not targets.is_contiguous():
        raise ValueError(f"targets must be contiguous int32 ({B}, L), got "
                         f"{tuple(targets.shape)} {targets.dtype}")
    for name, t in (("input_lengths", input_lengths), ("target_lengths", target_lengths)):
        if tuple(t.shape) != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({B},) int32, got {tuple(t.shape)} {t.dtype}")
    if len({log_probs.device, input_lengths.device, targets.device, target_lengths.device}) != 1:
        raise ValueError("log_probs, lengths and targets must be on one device")
    if not 0 <= blank_id < C:
        raise ValueError(f"blank_id {blank_id} outside [0, {C})")
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the CTC kernels run on cpu or cuda, not {log_probs.device}")
    S = 2 * targets.shape[1] + 1
    if log_probs.device.type == "cuda" and S > _MAX_PER_THREAD * _MAX_THREADS:
        raise ValueError(f"{S} CTC states exceed the kernels' {_MAX_PER_THREAD * _MAX_THREADS}")
    return B, T, C, targets.shape[1], S


def _threads(S: int) -> int:
    return min(_MAX_THREADS, -(-S // 32) * 32)


def ctc_alpha(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
              target_lengths: torch.Tensor, blank_id: int):
    """K4: log_probs (B, T, C) float32, input_lengths (B,) int32, targets
    (B, L) int32 in [0, C), target_lengths (B,) int32 -> (alpha (B, T, 2L+1),
    defined at frames t < input_lengths; ll (B,), NEG_INF where
    input_lengths == 0).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises."""
    B, T, C, L, S = _check(log_probs, input_lengths, targets, target_lengths, blank_id)
    if log_probs.device.type == "cpu":
        return ctc_alpha_plain(log_probs, input_lengths, targets, target_lengths, blank_id)

    from .kernel_build import library

    fn = library("ctc").lasr_ctc_alpha
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    alpha = torch.empty((B, T, S), dtype=torch.float32, device=log_probs.device)
    ll = torch.empty((B,), dtype=torch.float32, device=log_probs.device)
    if B:
        stream = torch.cuda.current_stream(log_probs.device).cuda_stream
        err = fn(log_probs.data_ptr(), input_lengths.data_ptr(), targets.data_ptr(),
                 target_lengths.data_ptr(), alpha.data_ptr(), ll.data_ptr(), B, T, C, L,
                 blank_id, _threads(S), ALPHA_RING, ctc_alpha_smem_bytes(S),
                 log_probs.device.index, stream)
        if err != 0:
            raise RuntimeError(f"CTC alpha kernel launch failed: CUDA error {err}")
        with _LOCK:
            ctc_alpha.launches += 1
    return alpha, ll


ctc_alpha.launches = 0


def ctc_beta(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, alpha: torch.Tensor, ll: torch.Tensor,
             gbar: torch.Tensor, blank_id: int) -> torch.Tensor:
    """K5: K4's inputs and outputs and the upstream gradient gbar (B,)
    float32 -> grad_emit (B, T, 2L+1), the gradient of the losses with
    respect to each state's emission, exactly 0 at frames t >= input_lengths.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    B, T, C, L, S = _check(log_probs, input_lengths, targets, target_lengths, blank_id)
    for name, t, shape in (("alpha", alpha, (B, T, S)), ("ll", ll, (B,)), ("gbar", gbar, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != log_probs.device:
            raise ValueError(f"{name} is on {t.device}, log_probs on {log_probs.device}")
    if log_probs.device.type == "cpu":
        return ctc_beta_plain(log_probs, input_lengths, targets, target_lengths, alpha, ll,
                              gbar, blank_id)

    from .kernel_build import library

    fn = library("ctc").lasr_ctc_beta
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    grad = torch.empty((B, T, S), dtype=torch.float32, device=log_probs.device)
    if B:
        stream = torch.cuda.current_stream(log_probs.device).cuda_stream
        err = fn(log_probs.data_ptr(), input_lengths.data_ptr(), targets.data_ptr(),
                 target_lengths.data_ptr(), alpha.data_ptr(), ll.data_ptr(), gbar.data_ptr(),
                 grad.data_ptr(), B, T, C, L, blank_id, _threads(S), ctc_beta_ring(S),
                 ctc_beta_smem_bytes(S), log_probs.device.index, stream)
        if err != 0:
            raise RuntimeError(f"CTC beta kernel launch failed: CUDA error {err}")
        with _LOCK:
            ctc_beta.launches += 1
    return grad


ctc_beta.launches = 0


def ctc_alpha_smem_on_card(S: int) -> int:
    """K4's dynamic shared memory for S states as its launch lays it out
    (csrc/ctc.cu): the card's check of ``ctc_alpha_smem_bytes``."""
    from .kernel_build import library

    fn = library("ctc").lasr_ctc_alpha_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn(S, ALPHA_RING)


def ctc_beta_smem_on_card(S: int) -> int:
    """K5's dynamic shared memory for S states as its launch lays it out
    (csrc/ctc.cu): the card's check of ``ctc_beta_smem_bytes``."""
    from .kernel_build import library

    fn = library("ctc").lasr_ctc_beta_smem
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn(S, ctc_beta_ring(S))


class _CTCLoss(torch.autograd.Function):
    """Per-sample losses from K4; the gradient from K5, scattered from
    states to classes by a one-hot batched matmul."""

    @staticmethod
    def forward(ctx, log_probs, input_lengths, targets, target_lengths, blank_id):
        alpha, ll = ctc_alpha(log_probs, input_lengths, targets, target_lengths, blank_id)
        ctx.save_for_backward(log_probs, input_lengths, targets, target_lengths, alpha, ll)
        ctx.blank_id = blank_id
        return torch.where(input_lengths > 0, -ll, torch.zeros_like(ll))

    @staticmethod
    def backward(ctx, g):
        log_probs, input_lengths, targets, target_lengths, alpha, ll = ctx.saved_tensors
        gbar = torch.where(input_lengths > 0, g, torch.zeros_like(g)).to(torch.float32).contiguous()
        grad_emit = ctc_beta(log_probs, input_lengths, targets, target_lengths, alpha, ll,
                             gbar, ctx.blank_id)
        ext, valid, _, _ = lattice(targets, target_lengths, ctx.blank_id)
        C = log_probs.shape[2]
        onehot = ((ext[:, :, None] == torch.arange(C, device=ext.device)) & valid[:, :, None])
        return torch.bmm(grad_emit, onehot.to(torch.float32)), None, None, None, None


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B,) per-sample ``-log p(y|x)`` through K4, differentiable through
    K5; 0 for rows with ``input_lengths == 0``.  ``ctc_loss_pallas``'s
    counterpart."""
    return _CTCLoss.apply(log_probs.to(torch.float32).contiguous(),
                          input_lengths.to(torch.int32), targets.to(torch.int32).contiguous(),
                          target_lengths.to(torch.int32), blank_id)
