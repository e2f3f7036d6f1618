"""The dual-stream SSL model (port of
``lightning_asr_tpu/models/dual_stream.py``): wav2vec2 features and a log-mel
stream at the same 20 ms rate, concatenated.

The wav2vec2 features (B, T1, 512) go through the float32 ``Dense``
``feature_mapping`` to 64 channels; both streams are cut to the shorter
length, concatenated to 128 channels (mapped features first) and fed to the
encoder with ``in_c=128``, whose convs run in float32 as the JAX model's
do (it passes no compute type).  The mel stream is ``DUAL_MEL_CONFIG``:
win 400, hop 320, no constant pad, so both streams tick at 20 ms; it stays
at the "highest" tier, where the JAX package runs no Pallas kernel, so K1
does not run on this path and K6 does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.frontend import MelFrontendConfig
from .layers import Conv, Dense
from .quartznet import ctc_head, make_encoder

# 20 ms hop, aligned with the wav2vec2 frames
DUAL_MEL_CONFIG = MelFrontendConfig(win_length=400, hop_length=320, pad=0)


class DualStreamAsrModel(nn.Module):
    """``forward(w2v_feats (B, T1, feature_in), mel_feats (B, T2, 64),
    percents (B,))`` -> ``(log_probs (B, T', num_classes), out_lengths)``.
    ``conv_kernel`` and ``fuse_directions`` as in ``build_model``."""

    def __init__(self, num_classes: int, encoder_name: str = "quartznet12_context",
                 drop_rate: float = 0.0, mask: bool = False, feature_in: int = 512,
                 in_c: int = 128, conv_kernel: Optional[str] = None,
                 fuse_directions: bool = False):
        super().__init__()
        self.dtype = None                                   # float32 encoder
        self.feature_mapping = Dense(feature_in, 64, bias=True)
        self.encoder = make_encoder(encoder_name, in_c, mask, drop_rate, None, conv_kernel,
                                    fuse_directions)
        self.decoder = Conv(1024, num_classes, 1, bias=True)

    def forward(self, w2v_feats: torch.Tensor, mel_feats: torch.Tensor, percents: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        w2v = self.feature_mapping(w2v_feats)
        T = min(w2v.shape[1], mel_feats.shape[1])
        x = torch.cat([w2v[:, :T], mel_feats[:, :T].to(torch.float32)], dim=-1)   # (B, T, 128)
        return ctc_head(self.decoder, self.encoder(x.transpose(1, 2), percents, generator),
                        percents)
