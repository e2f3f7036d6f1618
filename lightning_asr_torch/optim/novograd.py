"""NovoGrad (port of ``lightning_asr_tpu/optim/novograd.py``), per-tensor and
fused, with the NVIDIA implementation's quirks that the reference trains
with (betas (0.8, 0.5), lr 1e-2, wd 1e-3):

  * the second moment is a **scalar per parameter tensor** (the squared
    gradient L2 norm), *initialized to the first step's norm* rather than 0
    (the ``v == 0`` check);
  * update order: normalize the gradient by sqrt(second moment) + eps, add
    weight decay ON THE NORMALIZED gradient, optional gradient averaging,
    then momentum ``m = beta1·m + g``; step ``p -= lr·m``;
  * optional AMSGrad and LUC trust-ratio clipping;
  * the learning rate is read at ``count`` before it increments, so the
    first step of a warmup uses ``min_lr``.

The interface is optax's, so that the training step reads like the JAX one:
``opt = novograd(...)``; ``state = opt.init(params)``; ``updates, state =
opt.update(grads, state, params)``; ``params = apply_updates(params,
updates)``.  Parameters, gradients and updates are dicts of tensors (name ->
tensor); every function is pure (no tensor is changed in place), which is
what lets the training step's NaN guard keep the old state.  ``count`` and
every moment stay on the parameters' device, and a schedule is evaluated
there: an update makes no host round trip.

``fused=True`` (the default, as in the recipe) runs the update on ONE flat
buffer, as the JAX variant does: each tensor is zero-padded to whole
2048-element chunks; per-tensor norms are a chunked reduction plus a small
dense (n_tensors, n_chunks) 0/1 segment matmul, deterministic, and the
moment and step math is one elementwise pass over the buffer.  The state
keeps a flat master copy of the parameters (``p_flat``) that weight decay
and LUC read, updated by the same ``+u``, so it stays bit-equal to the
flattened parameters.  Results equal the per-tensor variant's up to
summation order.

``novograd_with_runtime_lr`` keeps the learning rate in the state, for the
ReduceLROnPlateau recipe; ``migrate_novograd_opt_state`` converts a saved
state between the fused and per-tensor variants on restore.

Under tensor parallelism (inside ``parallel/tp.py::model_parallel``) the
per-tensor variant updates this rank's blocks of the split leaves: their
squared gradient norm and LUC's two norms are summed over the model group,
so the scalar moments are the whole tensors', as GSPMD computes them in the
JAX package, and ``global_norm`` reads the whole tree.  The fused variant
refuses to run there, as the JAX ``train.py`` refuses it: its flat buffer
has no channel structure to split.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Union

import torch

from ..parallel import tp

Tensors = Dict[str, torch.Tensor]
_CHUNK = 2048


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class NovogradState(NamedTuple):
    count: torch.Tensor             # () int32 step counter
    exp_avg: Tensors                # momentum, like params (float32)
    exp_avg_sq: Tensors             # () float32 per tensor
    max_exp_avg_sq: Tensors         # () float32 per tensor (amsgrad)


class FusedNovogradState(NamedTuple):
    count: torch.Tensor             # () int32 step counter
    exp_avg: torch.Tensor           # (n_chunks, CHUNK) float32 momentum, flat layout
    exp_avg_sq: torch.Tensor        # (n_tensors,) float32
    max_exp_avg_sq: torch.Tensor    # (n_tensors,) float32 (amsgrad)
    p_flat: torch.Tensor            # (n_chunks, CHUNK) float32 flat master params


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (of the whole
    tensors under tensor parallelism)."""
    if tp.current() is not None:
        return torch.sqrt(tp.global_sum_of_squares(tree))
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tree.values()))


class FlatLayout:
    """Chunked layout of a dict of tensors: each tensor occupies whole
    2048-element chunks of one flat buffer; ``seg`` is the dense 0/1
    (n_tensors, n_chunks) membership matrix that reduces chunk sums to
    per-tensor scalars and broadcasts them back."""

    def __init__(self, params: Tensors):
        self.names = list(params)
        self.shapes = [tuple(p.shape) for p in params.values()]
        self.dtypes = [p.dtype for p in params.values()]
        self.sizes = [max(1, math.prod(s)) for s in self.shapes]
        self.chunks = [-(-n // _CHUNK) for n in self.sizes]
        self.n_tensors, self.n_chunks = len(self.names), sum(self.chunks)
        device = next(iter(params.values())).device
        self.seg = torch.zeros((self.n_tensors, self.n_chunks), dtype=torch.float32, device=device)
        self.offsets = []
        off = 0
        for i, c in enumerate(self.chunks):
            self.seg[i, off:off + c] = 1.0
            self.offsets.append(off)
            off += c

    def matches(self, params: Tensors) -> bool:
        return list(params) == self.names and [tuple(p.shape) for p in params.values()] == self.shapes

    def flatten(self, tree: Tensors) -> torch.Tensor:
        """-> (n_chunks, CHUNK) float32, zero-padded per tensor."""
        parts = []
        for name, n, c in zip(self.names, self.sizes, self.chunks):
            flat = tree[name].reshape(-1).to(torch.float32)
            if c * _CHUNK != n:
                flat = torch.cat([flat, flat.new_zeros(c * _CHUNK - n)])
            parts.append(flat)
        return torch.cat(parts).reshape(self.n_chunks, _CHUNK)

    def unflatten(self, buf: torch.Tensor) -> Tensors:
        flat = buf.reshape(-1)
        return {name: flat[off * _CHUNK: off * _CHUNK + n].reshape(shape).to(dtype)
                for name, shape, dtype, n, off in zip(self.names, self.shapes, self.dtypes,
                                                      self.sizes, self.offsets)}


def _lr_at(learning_rate, count: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``count``, a float32 scalar on its device; a
    constant is filled there, not uploaded."""
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    if not torch.is_tensor(lr):
        return torch.full((), lr, dtype=torch.float32, device=count.device)
    return lr.to(device=count.device, dtype=torch.float32)


def novograd(
    learning_rate: Union[float, Callable],
    betas=(0.95, 0.98),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_averaging: bool = False,
    amsgrad: bool = False,
    luc: bool = False,
    luc_trust: float = 1e-3,
    luc_eps: float = 1e-8,
    fused: bool = True,
) -> GradientTransformation:
    beta1, beta2 = betas
    if not (0.0 <= beta1 < 1.0 and 0.0 <= beta2 < 1.0):
        raise ValueError(f"Betas have to be between 0 and 1: {betas}")
    if eps < 0:
        raise ValueError(f"Invalid epsilon value: {eps}")
    if fused:
        return _novograd_fused(learning_rate, beta1, beta2, eps, weight_decay, grad_averaging,
                               amsgrad, luc, luc_trust, luc_eps)

    def init_fn(params: Tensors) -> NovogradState:
        dev = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
        return NovogradState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            exp_avg_sq={k: zero() for k in params},
            max_exp_avg_sq={k: zero() for k in params})

    def update_fn(grads: Tensors, state: NovogradState, params: Tensors):
        lr = _lr_at(learning_rate, state.count)
        new_m, new_v, new_vm, updates = {}, {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            norm = tp.model_sum(k, torch.sum(g * g))
            v = state.exp_avg_sq[k]
            v_new = torch.where(v == 0.0, norm, beta2 * v + (1.0 - beta2) * norm)
            vm_new = torch.maximum(state.max_exp_avg_sq[k], v_new) if amsgrad \
                else state.max_exp_avg_sq[k]
            g = g / (torch.sqrt(vm_new if amsgrad else v_new) + eps)
            if weight_decay != 0.0:
                g = g + weight_decay * p.to(torch.float32)
            if grad_averaging:
                g = g * (1.0 - beta1)
            m = beta1 * state.exp_avg[k] + g
            if luc:
                data_norm = tp.norm(k, p.to(torch.float32))
                factor = torch.minimum(luc_trust * data_norm / (tp.norm(k, m) + luc_eps), lr)
                updates[k] = (-factor * m).to(p.dtype)
            else:
                updates[k] = (-lr * m).to(p.dtype)
            new_m[k], new_v[k], new_vm[k] = m, v_new, vm_new
        return updates, NovogradState(state.count + 1, new_m, new_v, new_vm)

    return GradientTransformation(init_fn, update_fn)


def _novograd_fused(learning_rate, beta1, beta2, eps, weight_decay, grad_averaging, amsgrad,
                    luc, luc_trust, luc_eps) -> GradientTransformation:
    """Flat-buffer NovoGrad (see the module docstring)."""
    layouts = {}

    def layout_of(params: Tensors) -> FlatLayout:
        key = (tuple(params), next(iter(params.values())).device)
        if key not in layouts or not layouts[key].matches(params):
            layouts[key] = FlatLayout(params)
        return layouts[key]

    def refuse_split():
        if tp.current() is not None:
            raise ValueError("the fused NovoGrad runs on whole tensors; under tensor "
                             "parallelism (train.tp > 1) use novograd(..., fused=False)")

    def init_fn(params: Tensors) -> FusedNovogradState:
        refuse_split()
        layout = layout_of(params)
        dev = layout.seg.device
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
        return FusedNovogradState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            exp_avg=zeros(layout.n_chunks, _CHUNK),
            exp_avg_sq=zeros(layout.n_tensors),
            max_exp_avg_sq=zeros(layout.n_tensors),
            p_flat=layout.flatten(params))

    def update_fn(grads: Tensors, state: FusedNovogradState, params: Tensors):
        refuse_split()
        layout = layout_of(params)
        seg = layout.seg
        lr = _lr_at(learning_rate, state.count)
        g = layout.flatten(grads)
        # the flat master copy equals flatten(params) while every tensor is
        # float32 (flat `+u` is the per-tensor update); otherwise re-flatten
        resident = all(d == torch.float32 for d in layout.dtypes)
        p = state.p_flat if resident else layout.flatten(params)

        norms = seg @ torch.sum(g * g, dim=1)                 # (N,) squared grad norms
        v = state.exp_avg_sq
        v_new = torch.where(v == 0.0, norms, beta2 * v + (1.0 - beta2) * norms)
        vm_new = torch.maximum(state.max_exp_avg_sq, v_new) if amsgrad else state.max_exp_avg_sq
        denom_c = (torch.sqrt(vm_new if amsgrad else v_new) + eps) @ seg     # (C,)

        gn = g / denom_c[:, None]
        if weight_decay != 0.0:
            gn = gn + weight_decay * p                        # pad rows of p are 0
        if grad_averaging:
            gn = gn * (1.0 - beta1)
        m_new = beta1 * state.exp_avg + gn
        if luc:
            data_norm = torch.sqrt(seg @ torch.sum(p * p, dim=1))
            grad_norm = torch.sqrt(seg @ torch.sum(m_new * m_new, dim=1))
            factor = torch.minimum(luc_trust * data_norm / (grad_norm + luc_eps), lr)
            u = -(factor @ seg)[:, None] * m_new
        else:
            u = -lr * m_new
        return layout.unflatten(u), FusedNovogradState(state.count + 1, m_new, v_new, vm_new, p + u)

    return GradientTransformation(init_fn, update_fn)


class InjectHyperparamsState(NamedTuple):
    """The state of ``novograd_with_runtime_lr`` (optax's
    ``inject_hyperparams`` layout): the learning rate is a tensor in the
    state, which the trainer rewrites between epochs."""
    count: torch.Tensor             # () int32
    hyperparams: Tensors            # {"learning_rate": () float32}
    inner_state: Union[NovogradState, FusedNovogradState]


def novograd_with_runtime_lr(learning_rate: float, **kwargs) -> GradientTransformation:
    """NovoGrad whose learning rate lives in its state
    (``state.hyperparams["learning_rate"]``), the ReduceLROnPlateau recipe's
    requirement; every other argument is fixed at construction."""
    current: dict = {}
    inner = novograd(lambda count: current["lr"], **kwargs)

    def init_fn(params: Tensors) -> InjectHyperparamsState:
        inner_state = inner.init(params)
        lr = torch.tensor(float(learning_rate), dtype=torch.float32, device=inner_state.count.device)
        return InjectHyperparamsState(inner_state.count.clone(), {"learning_rate": lr}, inner_state)

    def update_fn(grads: Tensors, state: InjectHyperparamsState, params: Tensors):
        current["lr"] = state.hyperparams["learning_rate"]
        updates, inner_state = inner.update(grads, state.inner_state, params)
        return updates, InjectHyperparamsState(state.count + 1, dict(state.hyperparams), inner_state)

    return GradientTransformation(init_fn, update_fn)


def migrate_novograd_opt_state(raw_opt: dict, params: Tensors, target_opt_state):
    """A saved NovoGrad state (a dict of field name -> tensor or dict of
    tensors) in the variant of ``target_opt_state``, fused or per-tensor,
    either way: the flat layout follows from the params, so the conversion
    is exact.  ``p_flat``, the flat master copy of the params, is derived
    state: it is rebuilt from ``params`` when the saved state has none, is
    per-tensor, or holds one of another shape than the current layout's
    (fault C2 of the JAX package, which accepts any 2-D buffer)."""
    layout = FlatLayout(params)
    dev = layout.seg.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32).to(dev)  # noqa: E731
    count = torch.as_tensor(raw_opt["count"], dtype=torch.int32).to(dev)
    raw_m = raw_opt["exp_avg"]
    src_fused = torch.is_tensor(raw_m) and raw_m.dim() == 2

    def scalars_to_vec(tree) -> torch.Tensor:
        return torch.stack([f32(tree[n]).reshape(()) for n in layout.names])

    def vec_to_scalars(vec) -> Tensors:
        vec = f32(vec)
        return {n: vec[i] for i, n in enumerate(layout.names)}

    if isinstance(target_opt_state, FusedNovogradState):
        shape = (layout.n_chunks, _CHUNK)
        p_flat = raw_opt.get("p_flat")
        if not (torch.is_tensor(p_flat) and tuple(p_flat.shape) == shape):
            p_flat = layout.flatten(params)
        if src_fused:
            return FusedNovogradState(count, f32(raw_m), f32(raw_opt["exp_avg_sq"]),
                                      f32(raw_opt["max_exp_avg_sq"]), f32(p_flat))
        return FusedNovogradState(count, layout.flatten({n: f32(raw_m[n]) for n in layout.names}),
                                  scalars_to_vec(raw_opt["exp_avg_sq"]),
                                  scalars_to_vec(raw_opt["max_exp_avg_sq"]), f32(p_flat))
    if isinstance(target_opt_state, NovogradState):
        if src_fused:
            m = {n: t.to(torch.float32) for n, t in layout.unflatten(f32(raw_m)).items()}
            return NovogradState(count, m, vec_to_scalars(raw_opt["exp_avg_sq"]),
                                 vec_to_scalars(raw_opt["max_exp_avg_sq"]))
        return NovogradState(count, {n: f32(raw_m[n]) for n in layout.names},
                             vec_to_scalars(scalars_to_vec(raw_opt["exp_avg_sq"])),
                             vec_to_scalars(scalars_to_vec(raw_opt["max_exp_avg_sq"])))
    raise TypeError(f"cannot migrate NovoGrad state into {type(target_opt_state).__name__}")
