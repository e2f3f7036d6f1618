"""Dual-stream SSL data pipeline (port of
``lightning_asr_tpu/ssl_codec/dual_datamodule.py``): each batch carries the
wav2vec2 features and, in ``batch.extra``, the raw waves (``raw_waves``
(B, bucket·320) float32, ``raw_wave_lens``), from which the dual step
computes the 20 ms mel stream on the device.  A data-parallel rank reads
the WAVs of its own rows only; a pad row's raw wave is zeros of length 0
(the JAX trainer zero-pads ``batch.extra``)."""

from __future__ import annotations

import numpy as np

from ..data.audio import read_audio
from ..data.pipeline import Batch
from .ssl_datamodule import WAV2VEC_FPS, SSLBucketBatcher, SSLDataModule


class DualSSLBucketBatcher(SSLBucketBatcher):
    """``SSLBucketBatcher`` that also packs the raw waveform of each of the
    batch's rows (``batch.paths``), padded to the feature bucket's samples,
    into ``batch.extra``."""

    SAMPLE_RATE = 16000

    def _assemble(self, bucket: int, chunk: list) -> Batch:
        batch = super()._assemble(bucket, chunk)
        S = bucket * (self.SAMPLE_RATE // WAV2VEC_FPS)
        B = batch.waves.shape[0]
        raw = np.zeros((B, S), np.float32)
        raw_lens = np.zeros(B, np.int32)
        for i, path in enumerate(batch.paths):
            wave = read_audio(path, mono=True)[0][0]
            n = min(wave.shape[0], S)
            raw[i, :n] = wave[:n]
            raw_lens[i] = n
        batch.extra = {"raw_waves": raw, "raw_wave_lens": raw_lens}
        return batch


class DualSSLDataModule(SSLDataModule):
    batcher_class = DualSSLBucketBatcher
