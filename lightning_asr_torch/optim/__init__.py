from .clipping import clip_by_global_norm, clip_by_value, with_gradient_clipping
from .novograd import (apply_updates, global_norm, migrate_novograd_opt_state, novograd,
                       novograd_with_runtime_lr)
from .schedules import (LR_POLICIES, ReduceLROnPlateau, cosine_annealing_warmup_restarts,
                        get_lr_policy)

__all__ = [
    "LR_POLICIES",
    "ReduceLROnPlateau",
    "apply_updates",
    "clip_by_global_norm",
    "clip_by_value",
    "cosine_annealing_warmup_restarts",
    "get_lr_policy",
    "global_norm",
    "migrate_novograd_opt_state",
    "novograd",
    "novograd_with_runtime_lr",
    "with_gradient_clipping",
]
