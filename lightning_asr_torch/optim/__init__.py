from .clipping import clip_by_global_norm, clip_by_value, with_gradient_clipping
from .novograd import (apply_updates, global_norm, migrate_novograd_opt_state, novograd,
                       novograd_with_runtime_lr)
from .schedules import ReduceLROnPlateau, cosine_annealing_warmup_restarts

__all__ = [
    "ReduceLROnPlateau",
    "apply_updates",
    "clip_by_global_norm",
    "clip_by_value",
    "cosine_annealing_warmup_restarts",
    "global_norm",
    "migrate_novograd_opt_state",
    "novograd",
    "novograd_with_runtime_lr",
    "with_gradient_clipping",
]
