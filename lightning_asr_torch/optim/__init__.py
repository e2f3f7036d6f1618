from .clipping import clip_by_global_norm, clip_by_value, with_gradient_clipping
from .novograd import apply_updates, global_norm, novograd
from .schedules import cosine_annealing_warmup_restarts

__all__ = [
    "apply_updates",
    "clip_by_global_norm",
    "clip_by_value",
    "cosine_annealing_warmup_restarts",
    "global_norm",
    "novograd",
    "with_gradient_clipping",
]
