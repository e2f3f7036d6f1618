"""Offline inference API (port of ``lightning_asr_tpu/inference/predict.py``):
load a port checkpoint, transcribe a wav path, bytes or BytesIO, transcribe
audio of any length by overlapped windows, evaluate a manifest (WER or CER,
a per-utterance CSV, confidence scores), greedy or through a beam decoder
(``decoding/``: the LM-free search on the device, or the native one with an
ARPA LM and hot words).

The checkpoint carries its hyperparameters, so construction needs no
config.  Waveforms are padded to a small ladder of bucket lengths and the
batch to the next power of two (rows copied from row 0), as the JAX
translator does, so a server sees few distinct shapes.

An SSL checkpoint (``feature_in`` in its hparams) takes wav2vec2 features
in place of log-mels: a ``Wav2Vec2Extractor`` on the translator's device
gives them, each row's frames are the conv stack's output lengths (capped
at the feature length), and the batch is padded to a power of two.  The
long-audio paths (``long_log_probs``, ``translate_long``) take the mel path
only, as in the JAX package.
"""

from __future__ import annotations

import csv
import io
import logging
import time
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.audio import read_audio
from ..data.manifest import read_manifests
from ..data.vocab import Vocabulary
from ..decoding.greedy import compact_to_strings, greedy_collapse_device, greedy_decode_to_strings
from ..metrics.wer import WER
from ..models.quartznet import build_model
from ..ops.frontend import (MelFrontendConfig, log_mel_spectrogram, mel_num_frames,
                            normalize_features)
from ..ssl_codec.confidence import sum_logprob
from ..ssl_codec.extractor import DEFAULT_MODEL, Wav2Vec2Extractor
from ..ssl_codec.wav2vec import output_lengths
from ..training.checkpoint import load_checkpoint
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

_BUCKET_SECONDS = (2.0, 4.0, 8.0, 16.0, 24.0, 32.0, 40.0)
_COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def plan_chunks(n_samples: int, chunk: int, overlap: int) -> List[tuple]:
    """Split [0, n_samples) into windows of ``chunk`` samples overlapping by
    2·``overlap``, with keep-regions that tile the signal.

    Returns [(start, keep_lo, keep_hi)] with keep_lo/keep_hi relative to
    ``start``; the kept intervals [start+keep_lo, start+keep_hi) partition
    [0, n_samples).  The last window is right-aligned."""
    if chunk <= 2 * overlap:
        raise ValueError(f"chunk ({chunk}) must exceed 2*overlap ({2 * overlap})")
    if n_samples <= chunk:
        return [(0, 0, n_samples)]
    hop = chunk - 2 * overlap
    plans = []
    start = 0
    while True:
        if start + chunk >= n_samples:
            final_start = max(n_samples - chunk, 0)
            prev_keep_end = plans[-1][0] + plans[-1][2] if plans else 0
            plans.append((final_start, prev_keep_end - final_start, n_samples - final_start))
            return plans
        keep_lo = overlap if start > 0 else 0
        plans.append((start, keep_lo, chunk - overlap))
        start += hop


def out_frame(samples: int, frames: int, frames_of_chunk: int, cfg: MelFrontendConfig) -> int:
    """Output frames that a keep-prefix of ``samples`` samples of a window
    produces, for a window whose ``frames_of_chunk`` mel frames gave
    ``frames`` output frames: the model's own length function (mel framing,
    then the stride's trim), not a proportion."""
    if samples <= 0:
        return 0
    return min(frames, frames * mel_num_frames(samples, cfg) // frames_of_chunk)


class AsrTranslator:
    """Checkpoint -> text transcription.

    Args:
      model_path: port checkpoint directory (``training/checkpoint.py``).
      labels: override the vocabulary (default: the checkpoint's).
      lang: 'en' or 'cn'; 'cn' scores by characters unless the checkpoint
        says otherwise.
      beam_decoder: an object with ``forward(log_probs, lengths) -> [str]``
        (``BeamSearchDecoderWithLM``, ``DeviceBeamSearchDecoder``) in place
        of the greedy collapse; it is given the device's float32 log-probs.
      frontend: override the checkpoint's frontend.
      return_confidence: results become (text, confidence) pairs
        (``ssl_codec/confidence.py::sum_logprob``, blank frames skipped).
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

    def __init__(self, model_path: Union[str, Path], labels: Optional[Sequence[str]] = None,
                 lang: str = "en", beam_decoder=None,
                 frontend: Optional[MelFrontendConfig] = None, return_confidence: bool = False,
                 device=None, conv_kernel: Optional[str] = None):
        t0 = time.time()
        self.device = resolve_device(device)
        state_dict, meta = load_checkpoint(model_path)
        hparams = meta.get("hparams", {})
        if labels is None:
            labels = hparams.get("labels") or self.EN_LABELS
        self.vocab = Vocabulary(list(labels), bool(hparams.get("use_cer", lang == "cn")))
        if frontend is None:
            # the TRAINING frontend, precision tier included, so features
            # match what the BN statistics were calibrated on; serving passes
            # no generator, so the stored dither never fires
            fd = hparams.get("frontend")
            frontend = MelFrontendConfig.from_dict(fd) if fd else MelFrontendConfig(dither=0.0)
        self.frontend = frontend
        self.normalize = bool(hparams.get("normalize", True))
        self.beam_decoder = beam_decoder
        self.return_confidence = return_confidence

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
        self.ssl_extractor = None
        if hparams.get("feature_in"):
            self.ssl_extractor = Wav2Vec2Extractor(hparams.get("ssl_model_name", DEFAULT_MODEL),
                                                   device=self.device)
        logger.info("loaded checkpoint in %.2fs on %s", time.time() - t0, self.device)

    @torch.inference_mode()
    def _forward(self, waves: torch.Tensor, wave_lens: torch.Tensor):
        """(B, S) float32 waves + (B,) lengths on the device -> (log_probs
        (B, T', V+1) float32, out_lens (B,))."""
        feats, feat_lens = log_mel_spectrogram(waves, wave_lens, self.frontend)
        if self.normalize:
            feats = normalize_features(feats, feat_lens)
        percents = feat_lens.to(torch.float32) / torch.full((), feats.shape[1], dtype=torch.float32,
                                                            device=feats.device)
        return self.model(feats, percents)

    @torch.inference_mode()
    def _forward_feats(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """(B, T, feature_in) float32 features + (B,) frame counts on the
        device -> (log_probs (B, T', V+1) float32, out_lens (B,))."""
        percents = feat_lens.to(torch.float32) / torch.full((), feats.shape[1], dtype=torch.float32,
                                                            device=feats.device)
        return self.model(feats, percents)

    def feature_batch(self, waves: List[np.ndarray]):
        """The extractor's features of 1-D waves, with each row's frames
        (``output_lengths`` of its samples, capped at the feature length),
        the batch padded to the next power of two with copies of row 0.
        Returns numpy (feats (Bp, T, 512) float32, frames (Bp,) int32)."""
        feats, _ = self.ssl_extractor(list(waves))
        frames = output_lengths(np.asarray([w.shape[0] for w in waves], np.int64))
        frames = np.minimum(frames, feats.shape[1]).astype(np.int32)
        B = len(waves)
        Bp = 1 << (B - 1).bit_length()
        feats = np.concatenate([feats, np.repeat(feats[:1], Bp - B, axis=0)])
        return feats, np.concatenate([frames, np.repeat(frames[:1], Bp - B)])

    def _bucket_len(self, n: int) -> int:
        for s in _BUCKET_SECONDS:
            b = int(s * self.frontend.sample_rate)
            if n <= b:
                return b
        return n

    def pad_batch(self, waves: List[np.ndarray], n_max: Optional[int] = None):
        """Pad to the bucket ladder (or to ``n_max`` samples) and the batch
        to the next power of two (extra rows copy row 0, keeping
        per-utterance normalization finite).  Returns numpy (batch (Bp, S)
        float32, lens (Bp,) int32)."""
        if n_max is None:
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

    def _forward_batch(self, batch: np.ndarray, lens: np.ndarray):
        return self._forward(torch.from_numpy(batch).to(self.device),
                             torch.from_numpy(lens).to(self.device))

    def transcribe_batch(self, waves: List[np.ndarray]) -> list:
        """Transcribe a list of 1-D float32 waveforms: texts, or (text,
        confidence) pairs with ``return_confidence``."""
        return self.transcribe_batch_submit(waves)()

    def transcribe_batch_submit(self, waves: List[np.ndarray]):
        """Enqueue a batch's device work; return a zero-arg resolver.

        CUDA launches are asynchronous: the forward and, for greedy
        decoding, the argmax and the collapse are queued and this returns;
        the resolver's copy to the host waits for them.  A pipelined caller
        (``server.DynamicBatcher``, ``evaluate_manifest``) submits batch N+1
        before resolving batch N."""
        B = len(waves)
        if self.ssl_extractor is not None:
            feats, frames = self.feature_batch(waves)
            log_probs, out_lens = self._forward_feats(torch.from_numpy(feats).to(self.device),
                                                      torch.from_numpy(frames).to(self.device))
        else:
            log_probs, out_lens = self._forward_batch(*self.pad_batch(waves))
        # padding rows are trimmed by views of the device tensors
        log_probs, out_lens = log_probs[:B], out_lens[:B]
        if self.beam_decoder is None:
            ids, emit = greedy_collapse_device(torch.argmax(log_probs, dim=-1), out_lens,
                                               self.vocab.blank_id)

        def resolve() -> list:
            if self.beam_decoder is not None:
                texts = self.beam_decoder.forward(log_probs, out_lens)
            else:
                texts = compact_to_strings(ids.cpu().numpy(), emit.cpu().numpy(),
                                           self.vocab.labels)
            if self.return_confidence:
                conf = sum_logprob(log_probs.cpu().numpy(), out_lens.cpu().numpy(),
                                   self.vocab.blank_id)
                return list(zip(texts, conf.tolist()))
            return texts

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

    def _read(self, audio) -> np.ndarray:
        samples, sr = read_audio(audio, mono=True)
        if sr != self.frontend.sample_rate:
            raise ValueError(f"expected {self.frontend.sample_rate} Hz audio, got {sr}")
        return samples[0]

    def translate(self, audio: Union[str, Path, bytes, io.BytesIO]):
        """Transcribe one utterance from a path / bytes / BytesIO."""
        t0 = time.time()
        wave = self._read(audio)
        t1 = time.time()
        out = self.transcribe_batch([wave])[0]
        logger.info("load %.3fs  compute+decode %.3fs", t1 - t0, time.time() - t1)
        return out

    def long_log_probs(self, wave: np.ndarray, chunk_seconds: float = 20.0,
                       overlap_seconds: float = 2.0) -> np.ndarray:
        """(T_total, V+1) float32 log-probs of a wave of any length: windows
        of ``chunk_seconds`` overlapping by 2·``overlap_seconds``, run as one
        batch (rows padded to a power of two with copies of row 0), each
        window's frames trimmed to its keep-region, concatenated."""
        if self.ssl_extractor is not None:
            raise NotImplementedError("long audio takes the mel path; this checkpoint takes "
                                      "wav2vec2 features")
        sr = self.frontend.sample_rate
        chunk, overlap = int(chunk_seconds * sr), int(overlap_seconds * sr)
        plans = plan_chunks(wave.shape[0], chunk, overlap)
        windows = [wave[start: start + chunk] for start, _, _ in plans]
        log_probs, out_lens = self._forward_batch(*self.pad_batch(windows, n_max=chunk))
        log_probs, out_lens = log_probs.cpu().numpy(), out_lens.cpu().numpy()
        T_mel = mel_num_frames(chunk, self.frontend)
        pieces = []
        for i, (_, keep_lo, keep_hi) in enumerate(plans):
            frames = int(out_lens[i])
            f_lo = out_frame(keep_lo, frames, T_mel, self.frontend)
            f_hi = out_frame(keep_hi, frames, T_mel, self.frontend)
            pieces.append(log_probs[i, f_lo: max(f_hi, f_lo)])
        return np.concatenate(pieces, axis=0)

    def decode_stitched(self, log_probs: np.ndarray) -> str:
        """One greedy or beam pass over stitched (T, V+1) log-probs."""
        total = np.asarray([log_probs.shape[0]], np.int32)
        if self.beam_decoder is not None:
            return self.beam_decoder.forward(log_probs[None], total)[0]
        return greedy_decode_to_strings(np.argmax(log_probs, axis=-1)[None], total,
                                        self.vocab.labels, self.vocab.blank_id)[0]

    def translate_long(self, audio: Union[str, Path, bytes, io.BytesIO],
                       chunk_seconds: float = 20.0, overlap_seconds: float = 2.0) -> str:
        """Transcribe audio of any length by overlapped windows: every
        window in one batch of one shape, each window's log-probs trimmed to
        its keep-region, and ONE greedy or beam pass over the stitched
        sequence, so a character across a boundary collapses correctly."""
        wave = self._read(audio)
        sr = self.frontend.sample_rate
        if len(plan_chunks(wave.shape[0], int(chunk_seconds * sr), int(overlap_seconds * sr))) == 1:
            return self.transcribe_batch([wave])[0]
        return self.decode_stitched(self.long_log_probs(wave, chunk_seconds, overlap_seconds))

    def evaluate_manifest(self, manifest_path: Union[str, Path], batch_size: int = 16,
                          max_duration: float = 40.0,
                          csv_path: Optional[Union[str, Path]] = None) -> dict:
        """Evaluate a JSONL manifest in batches; returns the corpus WER (CER
        for a character vocabulary) and the utterance count.  With
        ``csv_path``, writes each utterance's path, reference, hypothesis,
        WER and confidence (empty without ``return_confidence``)."""
        entries = read_manifests(manifest_path, max_duration)
        metric = WER(self.vocab.labels, self.vocab.use_cer)
        rows = []

        def score(chunk, resolver):
            for e, res in zip(chunk, resolver()):
                text, conf = res if isinstance(res, tuple) else (res, None)
                utt_wer = metric.update([text], [e.text])
                rows.append((e.audio_filepath, e.text, text, utt_wer, conf))

        # double-buffered: batch i+1's reads and device work are queued
        # before batch i's results are fetched
        pending = None
        for i in range(0, len(entries), batch_size):
            chunk = entries[i: i + batch_size]
            resolver = self.transcribe_batch_submit(
                [read_audio(e.audio_filepath, mono=True)[0][0] for e in chunk])
            if pending is not None:
                score(*pending)
            pending = (chunk, resolver)
        if pending is not None:
            score(*pending)
        overall = metric.compute()
        if csv_path:
            with open(csv_path, "w", newline="", encoding="utf-8") as f:
                w = csv.writer(f)
                w.writerow(["audio_filepath", "reference", "hypothesis", "wer", "confidence"])
                w.writerows(rows)
        tag = "cer" if self.vocab.use_cer else "wer"
        logger.info("manifest %s: %s=%.4f over %d utts", manifest_path, tag, overall, len(rows))
        return {tag: overall, "n_utterances": len(rows)}
