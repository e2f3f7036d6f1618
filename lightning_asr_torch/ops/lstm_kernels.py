"""LSTM recurrence kernels: the forward K2 and the backward (BPTT) K3, both
directions at once (K2 one launch, K3 a gates pass and a walk, and at the
LSTM head's H = 128 a dW pass); and the batch-stacked pair K7 / K8 of the
``fuse_directions`` layout (second half of this module).

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
the chains run in parallel; a thread keeps its row of W_hh in registers and
h sits in shared memory; rows stop at their own length.  K2 at H = 40 is
K7's walk (second half of this module) on K2's layout, without a step
list, since a row's valid frames are contiguous: walk step s is frame s
(direction 0) or len-1-s (direction 1), and its projection arrives in a ring of
``BACKWARD_RING`` slots in shared memory by predicated ``cp.async``,
``BACKWARD_RING - 1`` steps ahead, so the chain loads nothing from device
memory; thread 4k + m owns gate m of unit k, every lane takes both
activations and keeps its gate's by a select (no divergent branch), the
unit's four meet in its quad by warp shuffles and every lane of the quad
updates the cell; one barrier a step publishes h, double-buffered; h and c
leave after the step's copies, the pad frames after the walk.  Its shared
memory is ``forward_smem_bytes``, its copy width ``backward_copy_width``;
it keeps the old kernel's dot order, activations and cell expression, so
its bits (and K7's equality with it) are unchanged.  K3 leaves on its
walk's serial chain only ``dh -> dc -> dgates -> dh_prev = dgates·W_hh ->
carry_h``, with one barrier a step.  A first kernel recomputes the gates of every valid frame
at once, in K2's summation order (the same bits as K2's), and stores the
factors each gate gradient needs; each step's factors, h_prev and grad_h
arrive in a ring of ``BACKWARD_RING`` slots in shared memory by
``cp.async``, ``BACKWARD_RING - 1`` steps ahead; the eight lanes of a pair
of units sum their ``dh_prev`` partials by warp shuffles; ``dW_hh[g, :] +=
dgates[g]·h_prev`` accumulates in a thread's 40 registers across the whole
walk, and the per-(row, direction) partials are summed over the batch in a
fixed order (deterministic).  The TPU kernels' 128-lane padding of H, their
32-step time blocks and the 32-row batch tiling (a VMEM cap) do not carry over.

K2 at H = 128 (the LSTM head, ``PAIR_HIDDEN``): a block of 4H = 512
threads may hold 128 registers a thread, and its rows of W_hh (128 floats a
thread) spilled, so the walk runs on a cluster of two CTAs a (row,
direction), each owning 64 units and their 256 gate rows, two lanes a row
and 64 W_hh values a thread: lane p keeps the weights with k mod 4 in {2p,
2p + 1} and runs those two of the dot's four chains, and one shuffle adds
the pair's halves as the one-block kernel adds its chains, so h and c keep
its bits (and K7's equality with K2).  Each step a CTA stores its 64 units'
h into its own shared memory and, by ``st.async``, into its partner's (two
buffers, laid out in the order the lanes read them), where each store
counts on the partner's mbarrier of that buffer; a step waits on that
mbarrier for the partner's half and on a CTA barrier for its own.  A
cluster barrier a step in its place made the walk 1.7x as long on an H100
(``scripts/torch_k2_sync_probe.py``).  Its ring stages only the CTA's 256
projections (``forward_smem_bytes(128)``); ``forward_clusters_on_card``
reads how many pairs the card holds at once (B·D needed).

K3 at H = 128: one block's W_hh columns
(128 floats a thread) and dW_hh partials (128) would not fit 512 threads'
128 registers, so the walk is split over a cluster of two CTAs a (row,
direction), each owning 64 units and their four gates, 64 W_hh values a
thread in registers; each step a CTA publishes its 256 gate gradients into
its own and its partner's shared memory and one cluster barrier a step
orders them, and each CTA sums dh_prev of its 64 units from all 512 in a
fixed order.  Its ring stages only what its chain reads (F of its 256
gates, A, f and grad_h of its units: ``backward_smem_bytes(128)``).  dW_hh
leaves the walk: a third kernel sums dgates^T h_prev over the valid frames
on the CUDA cores in float32, the frames of all rows cut into
``DW_CHUNKS`` equal chunks whose partial tiles a cluster sums in chunk
order (no atomics, no (B, D, 4H, H) partials, no row sum).  What bounds it
on the H100: each step's chain and the cluster barrier between two SMs, and
residency (2·B·D CTAs of 512 threads, one an SM;
``backward_clusters_on_card`` reads how many pairs the card holds at once).
"""

from __future__ import annotations

import ctypes
import threading

import torch

_LOCK = threading.Lock()
_KERNEL_HIDDEN = (40, 128)  # hidden sizes instantiated in csrc/lstm*.cu (context BiLSTM, LSTM head)
BACKWARD_RING = 8           # K2's, K3's, K7's and K8's ring slots (csrc/lstm_util.cuh LSTM_RING)
PAIR_HIDDEN = 128           # K2's, K3's, K7's, K8's H walked by a CTA pair (csrc/lstm_pair.cuh)
DW_CHUNKS = 8               # frame chunks of their dW pass at PAIR_HIDDEN (PairShape::CHUNKS)


def forward_smem_bytes(H: int) -> int:
    """The static shared memory of a CTA of K2's walk (csrc/lstm.cu): a ring
    of ``BACKWARD_RING`` slots of one step's projection (4H floats), then h
    of two steps.  At ``PAIR_HIDDEN`` a CTA of the pair (units U = H/2): its
    slots hold the projections of its 4U gates, its two h buffers all H
    units, then the two buffers' mbarriers, 8 bytes each (csrc/lstm_pair.cuh
    PairForward)."""
    if H == PAIR_HIDDEN:
        return 4 * (BACKWARD_RING * 4 * (H // 2) + 2 * H) + 2 * 8
    return 4 * (BACKWARD_RING * 4 * H + 2 * H)


def backward_smem_bytes(H: int) -> int:
    """The static shared memory of a CTA of K3's walk, the one statement of
    its layout (csrc/lstm_bwd.cu).  At H = 40 one block a (row, direction),
    the layout K8's walk shares: the ring, whose slots hold one step each
    (the gate factors F [0, 4H), A [4H, 5H) and f [5H, 6H) of its step,
    h_prev [6H, 7H), grad_h [7H, 8H)), then the gate gradients of two steps.
    At ``PAIR_HIDDEN`` a CTA of the pair (units U = H/2): the ring of its
    chain's inputs (F of its 4U gates [0, 4U), A [4U, 5U), f [5U, 6U),
    grad_h [6U, 7U)), then all 4H gate gradients of two steps."""
    if H == PAIR_HIDDEN:
        return 4 * (BACKWARD_RING * 7 * (H // 2) + 2 * 4 * H)
    return 4 * (BACKWARD_RING * 8 * H + 2 * 4 * H)


def stacked_forward_smem_bytes(H: int) -> int:
    """The static shared memory of a CTA of K7's walk (csrc/lstm_bidir.cu):
    K2's layout at the same H (``forward_smem_bytes``: at H = 40 the
    one-block walk's, at ``PAIR_HIDDEN`` a pair CTA's), then a ring of
    ``2 * BACKWARD_RING`` step-list entries (int32)."""
    return forward_smem_bytes(H) + 4 * 2 * BACKWARD_RING


def stacked_backward_smem_bytes(H: int) -> int:
    """The static shared memory of a CTA of K8's walk (csrc/lstm_bidir.cu):
    K3's layout at the same H (``backward_smem_bytes``: at H = 40 the
    one-block walk's, at ``PAIR_HIDDEN`` a pair CTA's), then a ring of
    ``2 * BACKWARD_RING`` step-list entries (int32)."""
    return backward_smem_bytes(H) + 4 * 2 * BACKWARD_RING


def backward_copy_width(*tensors: torch.Tensor) -> int:
    """Floats a ``cp.async`` copy of K2's, K3's, K7's or K8's walk moves: 4 (16
    bytes) where every tensor it stages starts 16-byte aligned, else 1.
    Every slice it stages (a frame's or a stacked step's 4H, 2H or H
    floats) then starts at a multiple of 4 floats from its tensor's start
    (H % 4 == 0), so the start alone decides."""
    return 4 if all(t.data_ptr() % 16 == 0 for t in tensors) else 1


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
    plain version; a CUDA tensor launches the kernel (at ``PAIR_HIDDEN`` the
    pair walk) or raises."""
    B, T, D, G, H = _check_recurrence_args(xproj, lengths, w_hh)
    if xproj.device.type == "cpu":
        return lstm_recurrence_plain(xproj, lengths, w_hh, with_cell)

    from .kernel_build import library

    fn = library("lstm").lasr_lstm_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = torch.empty((B, T, D * H), dtype=torch.float32, device=xproj.device)
    cell = torch.empty((B, T, D, H), dtype=torch.float32, device=xproj.device) if with_cell else None
    if B and T:
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), out.data_ptr(),
                 cell.data_ptr() if with_cell else None, B, T, D, H, backward_copy_width(xproj),
                 xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"LSTM kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_recurrence.launches += 1
            lstm_recurrence.launches_at[H] = lstm_recurrence.launches_at.get(H, 0) + 1
    return (out, cell) if with_cell else out


lstm_recurrence.launches = 0
lstm_recurrence.launches_at = {}   # launches by hidden size


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
    launches the kernels (at ``PAIR_HIDDEN`` the pair walk and the dW pass)
    or raises."""
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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    d_xproj = torch.empty_like(xproj)
    # the walk's per-(row, direction) partials, or at PAIR_HIDDEN the dW pass's sum
    dw = torch.empty((D, G, H) if H == PAIR_HIDDEN else (B, D, G, H), dtype=torch.float32,
                     device=xproj.device)
    if B and T:
        cfac = torch.empty((B, T, D, 2 * H), dtype=torch.float32, device=xproj.device)
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), lengths.data_ptr(), w_hh.data_ptr(), h.data_ptr(),
                 c.data_ptr(), grad_h.data_ptr(), d_xproj.data_ptr(), dw.data_ptr(),
                 cfac.data_ptr(), B, T, D, H, backward_copy_width(h, grad_h, d_xproj, cfac),
                 xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"LSTM backward kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_backward.launches += 1
            lstm_backward.launches_at[H] = lstm_backward.launches_at.get(H, 0) + 1
    else:
        dw.zero_()
    return d_xproj, dw if H == PAIR_HIDDEN else dw.sum(dim=0)


lstm_backward.launches = 0
lstm_backward.launches_at = {}   # launches by hidden size


def _card_query(source: str, entry: str, arg: int, device: torch.device) -> int:
    # a library's query entry int(int arg, int device): shared memory by
    # hidden size, or resident clusters by kernel
    from .kernel_build import library

    fn = getattr(library(source), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn(arg, device.index or 0)


def forward_smem_on_card(H: int, device: torch.device) -> int:
    """The static shared memory of K2's walk as the compiler laid it out for
    hidden size H (-1 without an instantiation): the card's check of
    ``forward_smem_bytes``."""
    return _card_query("lstm", "lasr_lstm_fwd_smem", H, device)


def forward_clusters_on_card(device: torch.device) -> int:
    """How many clusters of K2's walk at ``PAIR_HIDDEN`` (pairs of CTAs) the
    card holds at once (``cudaOccupancyMaxActiveClusters``; -1 on an
    error)."""
    return _card_query("lstm", "lasr_lstm_fwd_clusters", PAIR_HIDDEN, device)


def backward_smem_on_card(H: int, device: torch.device) -> int:
    """The static shared memory of K3's walk as the compiler laid it out for
    hidden size H (-1 without an instantiation): the card's check of
    ``backward_smem_bytes``."""
    return _card_query("lstm_bwd", "lasr_lstm_bwd_smem", H, device)


def backward_clusters_on_card(device: torch.device, dw_pass: bool = False) -> int:
    """How many clusters of K3's H = 128 walk (pairs of CTAs), or of its dW
    pass with ``dw_pass``, the card holds at once
    (``cudaOccupancyMaxActiveClusters``; -1 on an error)."""
    return _card_query("lstm_bwd", "lasr_lstm_bwd_clusters", int(dw_pass), device)


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


# ---------------------------------------------------------------------------
# The batch-stacked layout: K7 and K8
# ---------------------------------------------------------------------------
#
# K7 replaces ``lstm_pallas.py::_fwd_kernel_bidir`` and K8
# ``::_bwd_kernel_bidir`` (``LASR_LSTM_FUSED_BIDIR=1`` in the JAX package,
# ``build_model(fuse_directions=True)`` here).  Both directions are the 2B
# rows of one time-major recurrence: rows [0, B) walk the batch forward with
# W_hh_f, rows [B, 2B) walk the time-flipped padded batch with W_hh_b.  Every
# row's validity is a float mask that may have holes: a step with valid <= 0
# keeps the row's state and gives h = 0, and valid > 0 decides.  K7 also
# stores the PRE-update states h_prev and c_prev of every step; K8
# recomputes the gates from xproj and h_prev in K7's summation order (gate
# order i, f, g, o), passes its dh / dc carries through invalid steps (the
# TPU kernel's ``(1 - v)`` terms), writes d_xproj = 0 there, and sums dW_hh
# of each direction over its own B rows.  The TPU kernels' 128-lane padding
# of H and 16-step time blocks do not carry over.
#
# Bound on the H100: as K2 and K3, latency: a row's valid steps are
# dependent, each a 40-term dot, the gate nonlinearities and the state
# update (K8: two dots more and a reduction across the four gate groups);
# bytes are ~35 MB (K7) and ~60 MB (K8) at B=32, T=836, about 10 and 20 µs
# at 3.35 TB/s.
#
# K7 (``csrc/lstm_bidir.cu``): each stacked row's valid steps listed on the
# card (the body of K8's step lists, no sync with the host), then one block
# per stacked row, 4H threads, that walks only its row's listed steps in
# ascending t, reading the list from its end.  Each step's projection and
# the list entries arrive by ``cp.async`` in K8's rings, ``BACKWARD_RING -
# 1`` steps ahead, so the chain loads nothing from device memory; thread
# 4k + m owns gate m of unit k (its W_hh row in registers), the unit's four
# activations meet in its quad by warp shuffles, every lane of the quad
# updates the cell as K2 does (so h is K2's bit for bit), and one barrier a
# step publishes h.  The invalid steps are never stepped: after each valid
# step its quad writes the gap up to the next one, and the steps before
# the first after the walk.  Its shared memory is
# ``stacked_forward_smem_bytes``, its copy width ``backward_copy_width``.
#
# At ``PAIR_HIDDEN`` that walk's rows of W_hh (128 floats a thread) spilled
# 1.3 KB, so K7 takes K2's H = 128 walk after the same step lists: a
# cluster of two CTAs a stacked row, each owning 64 units and their 256 gate
# rows, two lanes a row and 64 W_hh values a thread in ``dot_h``'s chain
# order (so h is K2's bit for bit), h sent to the partner by ``st.async``
# and counted on its mbarrier (the one loop K2 and K7 share,
# ``csrc/lstm_pair.cuh`` ``pair_forward_walk``), its ring of the CTA's 256
# projections a step fed from the row's step list through each CTA's own
# list ring.  The mbarrier's phases count listed steps, not frames.  Lanes
# 0, 1 and 2 of a unit's eight store h, h_prev and c_prev and the gap after
# the step; each CTA writes its own units' steps before the first listed
# one.  ``stacked_forward_clusters_on_card`` reads how many of its pairs
# (2B needed) the card holds at once.
#
# K8 is K3's design on the stacked rows, three kernels on the stream: each
# row's valid steps listed in walk order (t descending) with their count,
# on the card (no sync with the host); a gates pass that recomputes every
# valid step's gates at once and leaves each gate's factor in d_xproj (exact
# zeros at invalid steps) and A and f in a (T, 2B, 2H) scratch; then a walk,
# one block per stacked row, that steps only its row's listed steps, its
# inputs staged by ``cp.async`` ``BACKWARD_RING - 1`` steps ahead, with one
# barrier a step, W_hh's columns in registers for ``dh_prev`` and dW_hh of
# the row in registers; the list entries reach it through the ring's own
# ``cp.async`` groups, into a second ring of ``2 * BACKWARD_RING`` ints.
# Its ring, slot layout and copy width are K3's (``BACKWARD_RING``,
# ``backward_smem_bytes``, ``backward_copy_width``), its shared memory
# ``stacked_backward_smem_bytes``.  The (2B, 4H, H) per-row partials are
# summed over each direction's B rows in a fixed order (no float atomics).
#
# At ``PAIR_HIDDEN`` that walk's W_hh columns and dW_hh partials (256 floats
# a thread) spilled 16.6 KB, so K8 takes K3's H = 128 design after the same
# step lists and gates pass: the walk on a cluster of two CTAs a stacked
# row (each owning 64 units, 64 W_hh values a thread, the gate gradients
# through distributed shared memory, one cluster barrier a step), its ring
# of K3's pair slots fed from the row's step list as above; then a dW pass,
# each direction's dW_hh summed over its B rows and their listed steps in
# float32, its frames in K3's order (row, then original time ascending), in
# ``DW_CHUNKS`` chunks summed in chunk order, straight into (2, 4H, H): no
# partials and no row sum.  On a contiguous mask its d_xproj and dW_hh are
# K3's bit for bit.  ``stacked_backward_clusters_on_card`` reads how many of
# the walk's pairs (2B needed) the card holds at once.


def _check_stacked_args(xproj, valid, w_hh_f, w_hh_b):
    if xproj.dim() != 3 or xproj.shape[1] % 2 or xproj.shape[2] % 4:
        raise ValueError(f"xproj must be (T, 2B, 4H), got {tuple(xproj.shape)}")
    T, B2, G = xproj.shape
    H = G // 4
    if tuple(valid.shape) != (T, B2):
        raise ValueError(f"valid must be {(T, B2)}, got {tuple(valid.shape)}")
    for name, t in (("w_hh_f", w_hh_f), ("w_hh_b", w_hh_b)):
        if tuple(t.shape) != (G, H):
            raise ValueError(f"{name} must be {(G, H)}, got {tuple(t.shape)}")
    for name, t in (("xproj", xproj), ("valid", valid), ("w_hh_f", w_hh_f), ("w_hh_b", w_hh_b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if len({xproj.device, valid.device, w_hh_f.device, w_hh_b.device}) != 1:
        raise ValueError("xproj, valid and both w_hh must be on one device")
    if xproj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the LSTM kernels run on cpu or cuda, not {xproj.device}")
    if xproj.device.type == "cuda" and H not in _KERNEL_HIDDEN:
        raise ValueError(f"the LSTM kernels are built for hidden sizes {_KERNEL_HIDDEN}, got {H}")
    return T, B2 // 2, G, H


def _gates_stacked(xp_t, h, w_hh_f, w_hh_b, B: int, H: int):
    rec = torch.cat([h[:B] @ w_hh_f.t(), h[B:] @ w_hh_b.t()], dim=0)
    i, f, g, o = (xp_t + rec).split(H, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def lstm_recurrence_stacked_plain(xproj: torch.Tensor, valid: torch.Tensor,
                                  w_hh_f: torch.Tensor, w_hh_b: torch.Tensor):
    """Plain PyTorch version of K7, the TPU kernel's body step by step
    (``lstm_pallas.py:155-181``).  Returns (h, h_prev, c_prev), each
    (T, 2B, H)."""
    T, B2, G = xproj.shape
    B, H = B2 // 2, G // 4
    h = xproj.new_zeros((B2, H))
    c = xproj.new_zeros((B2, H))
    hs, h_prevs, c_prevs = [], [], []
    for t in range(T):
        h_prevs.append(h)
        c_prevs.append(c)
        i, f, g, o = _gates_stacked(xproj[t], h, w_hh_f, w_hh_b, B, H)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        v = valid[t][:, None] > 0
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        hs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
    return torch.stack(hs), torch.stack(h_prevs), torch.stack(c_prevs)


def lstm_recurrence_stacked(xproj: torch.Tensor, valid: torch.Tensor,
                            w_hh_f: torch.Tensor, w_hh_b: torch.Tensor):
    """K7: xproj (T, 2B, 4H) float32 gate projections (biases folded in),
    valid (T, 2B) float32, w_hh_f and w_hh_b (4H, H) -> (h, h_prev, c_prev),
    each (T, 2B, H): the masked h and the state before each step.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernels (at
    ``PAIR_HIDDEN`` the step lists and the pair walk) or raises."""
    T, B, G, H = _check_stacked_args(xproj, valid, w_hh_f, w_hh_b)
    if xproj.device.type == "cpu":
        return lstm_recurrence_stacked_plain(xproj, valid, w_hh_f, w_hh_b)
    if H == PAIR_HIDDEN and xproj.numel() >= 2 ** 31:
        raise ValueError(f"K7's pair walk indexes its (T, 2B, 4H) tensors with 32-bit offsets, got "
                         f"{tuple(xproj.shape)}")

    from .kernel_build import library

    fn = library("lstm_bidir").lasr_lstm_stacked_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    outs = [torch.empty((T, 2 * B, H), dtype=torch.float32, device=xproj.device) for _ in range(3)]
    if B and T:
        steps = torch.empty((2 * B, T), dtype=torch.int32, device=xproj.device)
        counts = torch.empty((2 * B,), dtype=torch.int32, device=xproj.device)
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), valid.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
                 *(o.data_ptr() for o in outs), steps.data_ptr(), counts.data_ptr(), T, B, H,
                 backward_copy_width(xproj), xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"stacked LSTM kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_recurrence_stacked.launches += 1
            lstm_recurrence_stacked.launches_at[H] = lstm_recurrence_stacked.launches_at.get(H, 0) + 1
    return tuple(outs)


lstm_recurrence_stacked.launches = 0
lstm_recurrence_stacked.launches_at = {}   # launches by hidden size


def lstm_backward_stacked_plain(xproj: torch.Tensor, valid: torch.Tensor, w_hh_f: torch.Tensor,
                                w_hh_b: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                                grad_h: torch.Tensor):
    """Plain PyTorch version of K8, the TPU kernel's body step by step
    (``lstm_pallas.py:184-234``).  Returns (d_xproj (T, 2B, 4H), dW_hh_f,
    dW_hh_b (4H, H))."""
    T, B2, G = xproj.shape
    B, H = B2 // 2, G // 4
    dh_c = xproj.new_zeros((B2, H))
    dc_c = xproj.new_zeros((B2, H))
    dw_f = xproj.new_zeros((G, H))
    dw_b = xproj.new_zeros((G, H))
    steps = [None] * T
    for t in reversed(range(T)):
        hp, cp = h_prev[t], c_prev[t]
        i, f, g, o = _gates_stacked(xproj[t], hp, w_hh_f, w_hh_b, B, H)
        tc = torch.tanh(f * cp + i * g)
        v = valid[t][:, None]
        dh = (grad_h[t] + dh_c) * v
        dc = dc_c * v + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f),
                            dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        steps[t] = dgates
        dw_f = dw_f + dgates[:B].t() @ hp[:B]
        dw_b = dw_b + dgates[B:].t() @ hp[B:]
        dh_prev = torch.cat([dgates[:B] @ w_hh_f, dgates[B:] @ w_hh_b], dim=0)
        dh_c = dh_prev + dh_c * (1.0 - v)
        dc_c = dc * f + dc_c * (1.0 - v)
    return torch.stack(steps), dw_f, dw_b


def lstm_backward_stacked(xproj: torch.Tensor, valid: torch.Tensor, w_hh_f: torch.Tensor,
                          w_hh_b: torch.Tensor, h_prev: torch.Tensor, c_prev: torch.Tensor,
                          grad_h: torch.Tensor):
    """K8: K7's inputs, its h_prev and c_prev, and the gradient of h, each
    (T, 2B, H) -> (d_xproj (T, 2B, 4H), exactly 0 at invalid steps; dW_hh_f,
    dW_hh_b (4H, H)).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernels (at ``PAIR_HIDDEN`` the pair walk and the dW pass)
    or raises."""
    T, B, G, H = _check_stacked_args(xproj, valid, w_hh_f, w_hh_b)
    for name, t in (("h_prev", h_prev), ("c_prev", c_prev), ("grad_h", grad_h)):
        if tuple(t.shape) != (T, 2 * B, H) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {(T, 2 * B, H)}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != xproj.device:
            raise ValueError(f"{name} is on {t.device}, xproj on {xproj.device}")
    if xproj.device.type == "cpu":
        return lstm_backward_stacked_plain(xproj, valid, w_hh_f, w_hh_b, h_prev, c_prev, grad_h)
    if xproj.numel() >= 2 ** 31:
        raise ValueError(f"K8 indexes its (T, 2B, 4H) tensors with 32-bit offsets, got "
                         f"{tuple(xproj.shape)}")

    from .kernel_build import library

    fn = library("lstm_bidir").lasr_lstm_stacked_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    d_xproj = torch.empty_like(xproj)
    # the walk's per-row partials, or at PAIR_HIDDEN the dW pass's two sums
    dw_part = torch.empty((2 if H == PAIR_HIDDEN else 2 * B, G, H), dtype=torch.float32,
                          device=xproj.device)
    if B and T:
        cfac = torch.empty((T, 2 * B, 2 * H), dtype=torch.float32, device=xproj.device)
        steps = torch.empty((2 * B, T), dtype=torch.int32, device=xproj.device)
        counts = torch.empty((2 * B,), dtype=torch.int32, device=xproj.device)
        stream = torch.cuda.current_stream(xproj.device).cuda_stream
        err = fn(xproj.data_ptr(), valid.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
                 h_prev.data_ptr(), c_prev.data_ptr(), grad_h.data_ptr(), d_xproj.data_ptr(),
                 dw_part.data_ptr(), cfac.data_ptr(), steps.data_ptr(), counts.data_ptr(), T, B, H,
                 backward_copy_width(h_prev, grad_h, d_xproj, cfac), xproj.device.index, stream)
        if err != 0:
            raise RuntimeError(f"stacked LSTM backward kernel launch failed: CUDA error {err}")
        with _LOCK:
            lstm_backward_stacked.launches += 1
            lstm_backward_stacked.launches_at[H] = lstm_backward_stacked.launches_at.get(H, 0) + 1
    else:
        dw_part.zero_()
    dw = dw_part if H == PAIR_HIDDEN else dw_part.view(2, B, G, H).sum(dim=1)
    return d_xproj, dw[0], dw[1]


lstm_backward_stacked.launches = 0
lstm_backward_stacked.launches_at = {}   # launches by hidden size


def stacked_forward_smem_on_card(H: int, device: torch.device) -> int:
    """The static shared memory of K7's walk as the compiler laid it out for
    hidden size H (-1 without an instantiation): the card's check of
    ``stacked_forward_smem_bytes``."""
    return _card_query("lstm_bidir", "lasr_lstm_stacked_fwd_smem", H, device)


def stacked_forward_clusters_on_card(device: torch.device) -> int:
    """How many clusters of K7's walk at ``PAIR_HIDDEN`` (pairs of CTAs) the
    card holds at once (``cudaOccupancyMaxActiveClusters``; -1 on an
    error)."""
    return _card_query("lstm_bidir", "lasr_lstm_stacked_fwd_clusters", PAIR_HIDDEN, device)


def stacked_backward_smem_on_card(H: int, device: torch.device) -> int:
    """The static shared memory of K8's walk as the compiler laid it out for
    hidden size H (-1 without an instantiation): the card's check of
    ``stacked_backward_smem_bytes``."""
    return _card_query("lstm_bidir", "lasr_lstm_stacked_bwd_smem", H, device)


def stacked_backward_clusters_on_card(device: torch.device, dw_pass: bool = False) -> int:
    """How many clusters of K8's H = 128 walk (pairs of CTAs), or of its dW
    pass with ``dw_pass``, the card holds at once
    (``cudaOccupancyMaxActiveClusters``; -1 on an error)."""
    return _card_query("lstm_bidir", "lasr_lstm_stacked_bwd_clusters", int(dw_pass), device)


class _LSTMCoreStacked(torch.autograd.Function):
    """h = K7(xproj, valid, w_hh_f, w_hh_b), with K8 as its backward
    (``lstm_pallas.py::_lstm_core_bidir``)."""

    @staticmethod
    def forward(ctx, xproj, valid, w_hh_f, w_hh_b):
        h, h_prev, c_prev = lstm_recurrence_stacked(xproj, valid, w_hh_f, w_hh_b)
        ctx.save_for_backward(xproj, valid, w_hh_f, w_hh_b, h_prev, c_prev)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        d_xproj, dw_f, dw_b = lstm_backward_stacked(*ctx.saved_tensors, grad_h.contiguous())
        return d_xproj, None, dw_f, dw_b


def lstm_core_stacked(xproj: torch.Tensor, valid: torch.Tensor, w_hh_f: torch.Tensor,
                      w_hh_b: torch.Tensor) -> torch.Tensor:
    """The stacked recurrence as autograd sees it: K7, with K8 as its
    backward when a gradient is needed."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xproj, w_hh_f, w_hh_b)):
        return _LSTMCoreStacked.apply(xproj, valid, w_hh_f, w_hh_b)
    return lstm_recurrence_stacked(xproj, valid, w_hh_f, w_hh_b)[0]
