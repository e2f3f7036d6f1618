"""The SSL retrain model (port of ``lightning_asr_tpu/ssl_codec/retrain.py``):
raw waves -> the trainable wav2vec2 feature encoder -> cutout (train mode)
-> ``feature_mapping`` 512 -> 64 -> the encoder -> the CTC head, one
module with gradients end to end.

The encoder's convs run in float32, as the JAX model's do (it passes no
compute type).  The cutout's rectangles come from the generator passed to
``forward``, before any dropout draw.  ``load_hf_encoder_into_params`` puts
a HuggingFace feature encoder's weights into a parameter dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.layers import Conv, Dense
from ..models.quartznet import ctc_head, make_encoder
from ..ops.augment import cutout
from .wav2vec import Wav2Vec2FeatureEncoder, convert_hf_feature_encoder, output_lengths


class SSLRetrainAsrModel(nn.Module):
    """``forward(waves (B, S), wave_lens (B,))`` -> ``(log_probs (B, T',
    num_classes), out_lengths (B,))``.  ``conv_kernel`` and
    ``fuse_directions`` as in ``build_model``."""

    def __init__(self, num_classes: int, encoder_name: str = "quartznet12_context",
                 drop_rate: float = 0.0, mask: bool = False, feat_extract_norm: str = "layer",
                 conv_bias: bool = True, augment_cutout: bool = True,
                 conv_kernel: Optional[str] = None, fuse_directions: bool = False):
        super().__init__()
        self.dtype = None                                   # float32 encoder
        self.augment_cutout = augment_cutout
        self.wav2vec = Wav2Vec2FeatureEncoder(feat_extract_norm, conv_bias)
        self.feature_mapping = Dense(512, 64, bias=True)
        self.encoder = make_encoder(encoder_name, 64, mask, drop_rate, None, conv_kernel,
                                    fuse_directions)
        self.decoder = Conv(1024, num_classes, 1, bias=True)

    def forward(self, waves: torch.Tensor, wave_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.wav2vec(waves)                                  # (B, T', 512)
        feat_lens = output_lengths(wave_lens.to(device=feats.device, dtype=torch.int64))
        if self.training and self.augment_cutout:
            feats = cutout(feats, generator, rect_masks=5, rect_freq=150, rect_time=100)
        x = self.feature_mapping(feats)
        T = torch.full((), x.shape[1], dtype=torch.float32, device=x.device)
        percents = feat_lens.to(torch.float32) / T
        return ctc_head(self.decoder, self.encoder(x.transpose(1, 2), percents, generator),
                        percents)


def load_hf_encoder_into_params(params: Dict[str, torch.Tensor], hf_state_dict,
                                norm: str = "layer") -> Dict[str, torch.Tensor]:
    """``params`` with its ``wav2vec.*`` tensors replaced by a HuggingFace
    feature encoder's (a ``Wav2Vec2Model`` or ``Wav2Vec2ForCTC`` state_dict,
    or the feature encoder's own), on each tensor's device."""
    prefix = ""
    if any(k.startswith("wav2vec2.feature_extractor.") for k in hf_state_dict):
        prefix = "wav2vec2.feature_extractor."
    elif any(k.startswith("feature_extractor.") for k in hf_state_dict):
        prefix = "feature_extractor."
    converted = convert_hf_feature_encoder(hf_state_dict, norm=norm, prefix=prefix)
    ours = {k for k in params if k.startswith("wav2vec.")}
    if {f"wav2vec.{k}" for k in converted} != ours:
        raise ValueError("the HuggingFace state_dict's feature encoder does not match the "
                         f"model's ({norm!r} norm)")
    return {**params, **{f"wav2vec.{k}": v.to(params[f"wav2vec.{k}"].device)
                         for k, v in converted.items()}}
