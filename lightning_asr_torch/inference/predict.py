"""Offline inference API (port of ``lightning_asr_tpu/inference/predict.py``):
load a port checkpoint, transcribe a wav path, bytes or BytesIO.

The checkpoint carries its hyperparameters, so construction needs no
config.  Waveforms are padded to a small ladder of bucket lengths and the
batch to the next power of two (rows copied from row 0), as the JAX
translator does, so a server sees few distinct shapes.

Not ported yet: ``translate_long``, ``evaluate_manifest``, the beam/LM
decoder, confidence scores and the SSL feature path.
"""

from __future__ import annotations

import io
import logging
import time
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.audio import read_audio
from ..data.vocab import Vocabulary
from ..decoding.greedy import greedy_decode_to_strings
from ..models.quartznet import build_model
from ..ops.frontend import MelFrontendConfig, log_mel_spectrogram, normalize_features
from ..training.checkpoint import load_checkpoint
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

_BUCKET_SECONDS = (2.0, 4.0, 8.0, 16.0, 24.0, 32.0, 40.0)
_COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


class AsrTranslator:
    """Checkpoint -> text transcription.

    Args:
      model_path: port checkpoint directory (``training/checkpoint.py``).
      device: ``cuda`` unless given; ``"cpu"`` runs the plain versions of
        the kernels.  Raises when CUDA is asked for and absent.
      conv_kernel: what runs the blocks' separable convs (``build_model``):
        None the ``F.conv1d`` pair, ``"sepconv"`` the fused kernel K9, as
        the JAX package's ``LASR_SEPCONV_PALLAS=1``; ``"dw_wgrad"`` changes
        only the weight gradient, so it serves as None does.

    Labels, frontend (precision tier included), compute dtype and model
    options come from the checkpoint's hparams.
    """

    EN_LABELS = [" ", "'"] + [chr(ord("a") + i) for i in range(26)]

    def __init__(self, model_path: Union[str, Path], device=None,
                 conv_kernel: Optional[str] = None):
        t0 = time.time()
        self.device = resolve_device(device)
        state_dict, meta = load_checkpoint(model_path)
        hparams = meta.get("hparams", {})
        labels = hparams.get("labels") or self.EN_LABELS
        self.vocab = Vocabulary(list(labels), bool(hparams.get("use_cer", False)))
        # the TRAINING frontend, precision tier included, so features match
        # what the BN statistics were calibrated on; serving passes no
        # generator, so the stored dither never fires
        fd = hparams.get("frontend")
        self.frontend = MelFrontendConfig.from_dict(fd) if fd else MelFrontendConfig(dither=0.0)
        self.normalize = bool(hparams.get("normalize", True))

        dtype_name = hparams.get("compute_dtype")
        if dtype_name not in _COMPUTE_DTYPES:
            raise ValueError(f"unsupported compute_dtype {dtype_name!r}")
        self.model = build_model(
            num_classes=self.vocab.num_classes,
            encoder=hparams.get("encoder", "quartznet12_context"),
            in_c=hparams.get("in_c", 64),
            mask=bool(hparams.get("mask", True)),
            feature_in=hparams.get("feature_in"),
            dtype=_COMPUTE_DTYPES[dtype_name],
            conv_kernel=conv_kernel,
        )
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        logger.info("loaded checkpoint in %.2fs on %s", time.time() - t0, self.device)

    @torch.inference_mode()
    def _forward(self, waves: torch.Tensor, wave_lens: torch.Tensor):
        """(B, S) float32 waves + (B,) lengths on the device -> (log_probs
        (B, T', V+1), out_lens (B,))."""
        feats, feat_lens = log_mel_spectrogram(waves, wave_lens, self.frontend)
        if self.normalize:
            feats = normalize_features(feats, feat_lens)
        percents = feat_lens.to(torch.float32) / torch.full((), feats.shape[1], dtype=torch.float32,
                                                            device=feats.device)
        return self.model(feats, percents)

    def _bucket_len(self, n: int) -> int:
        for s in _BUCKET_SECONDS:
            b = int(s * self.frontend.sample_rate)
            if n <= b:
                return b
        return n

    def pad_batch(self, waves: List[np.ndarray]):
        """Pad to the bucket ladder and the batch to the next power of two
        (extra rows copy row 0, keeping per-utterance normalization finite).
        Returns numpy (batch (Bp, S) float32, lens (Bp,) int32)."""
        n_max = self._bucket_len(max(w.shape[0] for w in waves))
        B = len(waves)
        Bp = 1 << (B - 1).bit_length()
        batch = np.zeros((Bp, n_max), np.float32)
        lens = np.zeros(Bp, np.int32)
        for i, w in enumerate(waves):
            batch[i, : w.shape[0]] = w
            lens[i] = w.shape[0]
        batch[B:] = batch[0]
        lens[B:] = lens[0]
        return batch, lens

    def transcribe_batch(self, waves: List[np.ndarray]) -> List[str]:
        """Transcribe a list of 1-D float32 waveforms."""
        return self.transcribe_batch_submit(waves)()

    def transcribe_batch_submit(self, waves: List[np.ndarray]):
        """Enqueue a batch's device work; return a zero-arg resolver.

        CUDA launches are asynchronous: the forward and the argmax are
        queued and this returns; the resolver's copy to the host waits for
        them.  A pipelined caller (``server.DynamicBatcher``) submits batch
        N+1 before resolving batch N."""
        B = len(waves)
        batch, lens = self.pad_batch(waves)
        log_probs, out_lens = self._forward(torch.from_numpy(batch).to(self.device),
                                            torch.from_numpy(lens).to(self.device))
        preds = torch.argmax(log_probs, dim=-1)

        def resolve() -> List[str]:
            # trim the padding rows on the host
            return greedy_decode_to_strings(preds.cpu().numpy()[:B], out_lens.cpu().numpy()[:B],
                                            self.vocab.labels, self.vocab.blank_id)

        return resolve

    def warmup(self, seconds: Sequence[float] = (5.0,), max_batch: int = 1) -> None:
        """Run one silent batch for each power-of-two batch size up to
        ``max_batch`` x each duration's bucket, so that the kernels are
        built and the allocator holds the ladder's memory before traffic."""
        sizes = [1]
        while sizes[-1] < max(1, max_batch):
            sizes.append(sizes[-1] * 2)
        buckets = sorted({self._bucket_len(int(s * self.frontend.sample_rate)) for s in seconds})
        for n in buckets:
            wave = np.zeros(n, np.float32)
            for b in sizes:
                self.transcribe_batch([wave] * b)

    def translate(self, audio: Union[str, Path, bytes, io.BytesIO]) -> str:
        """Transcribe one utterance from a path / bytes / BytesIO."""
        t0 = time.time()
        samples, sr = read_audio(audio, mono=True)
        if sr != self.frontend.sample_rate:
            raise ValueError(f"expected {self.frontend.sample_rate} Hz audio, got {sr}")
        t1 = time.time()
        out = self.transcribe_batch([samples[0]])[0]
        logger.info("load %.3fs  compute+decode %.3fs", t1 - t0, time.time() - t1)
        return out
