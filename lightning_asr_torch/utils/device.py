"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for and absent (no silent fall back to the CPU).  A ``cuda``
    without an index is the current card: a data-parallel rank's own, which
    ``parallel/distributed.py::init`` pins."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                               "is False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        # cuDNN runs float32 convolutions in TF32 (about 3 decimal digits) by
        # default; the fp32 paths (the CTC decoder head, fp32 models) must
        # match the reference in full float32.  Matmuls already default to
        # full fp32; pinned here so a caller's global change cannot leak in.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
