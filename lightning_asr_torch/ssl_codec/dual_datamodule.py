"""Dual-stream SSL data pipeline (port of
``lightning_asr_tpu/ssl_codec/dual_datamodule.py``): each batch carries the
wav2vec2 features and, in ``batch.extra``, the raw waves (``raw_waves``
(B, bucket·320) float32, ``raw_wave_lens``), from which the dual step
computes the 20 ms mel stream on the device."""

from __future__ import annotations

import numpy as np

from ..data.audio import read_audio
from ..data.pipeline import Batch
from .ssl_datamodule import WAV2VEC_FPS, SSLBucketBatcher, SSLDataModule


class DualSSLBucketBatcher(SSLBucketBatcher):
    """``SSLBucketBatcher`` that also packs the raw waveform, padded to the
    feature bucket's samples, into ``batch.extra``."""

    SAMPLE_RATE = 16000

    def _assemble(self, bucket: int, chunk: list) -> Batch:
        batch = super()._assemble(bucket, chunk)
        S = bucket * (self.SAMPLE_RATE // WAV2VEC_FPS)
        raw = np.zeros((len(chunk), S), np.float32)
        raw_lens = np.zeros(len(chunk), np.int32)
        for i, idx in enumerate(chunk):
            wave = read_audio(self.entries[idx].audio_filepath, mono=True)[0][0]
            n = min(wave.shape[0], S)
            raw[i, :n] = wave[:n]
            raw_lens[i] = n
        batch.extra = {"raw_waves": raw, "raw_wave_lens": raw_lens}
        return batch


class DualSSLDataModule(SSLDataModule):
    batcher_class = DualSSLBucketBatcher
