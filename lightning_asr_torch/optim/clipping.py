"""Gradient clipping (port of ``lightning_asr_tpu/optim/clipping.py``): the
reference's Lightning ``gradient_clip_val`` / ``gradient_clip_algorithm``
knobs (pinned off in the shipped recipes), composed AHEAD of the optimizer.

``clip_val == 0`` disables clipping; ``algorithm`` is ``'value'`` (clamp
each element to [-v, +v], optax ``clip``) or ``'norm'`` (rescale so the
global L2 norm is at most v, optax ``clip_by_global_norm``).  NaN gradients
stay non-finite under both, so the training step's NaN guard still skips
the step.
"""

from __future__ import annotations

from .novograd import GradientTransformation, Tensors, global_norm


def clip_by_value(grads: Tensors, max_delta: float) -> Tensors:
    return {k: g.clamp(-max_delta, max_delta) for k, g in grads.items()}


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """Each t -> t where the global norm is below max_norm, else
    (t / norm) · max_norm (optax's order of operations).  Under tensor
    parallelism the norm is the whole tree's (``global_norm``)."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return {k: g.where(trigger, (g / g_norm.to(g.dtype)) * max_norm) for k, g in grads.items()}


def with_gradient_clipping(optimizer: GradientTransformation, clip_val: float = 0.0,
                           algorithm: str = "value") -> GradientTransformation:
    """``optimizer`` with incoming gradients clipped first; the state is the
    optimizer's own."""
    if not clip_val:
        return optimizer
    if algorithm == "value":
        clip = clip_by_value
    elif algorithm == "norm":
        clip = clip_by_global_norm
    else:
        raise ValueError(f"gradient_clip_algorithm must be 'value' or 'norm', got {algorithm!r}")

    def update_fn(grads, state, params):
        return optimizer.update(clip(grads, float(clip_val)), state, params)

    return GradientTransformation(optimizer.init, update_fn)
