"""wav2vec2 feature extraction for the SSL path (port of
``lightning_asr_tpu/ssl_codec/extractor.py``).

``Wav2Vec2Extractor`` wraps a HuggingFace wav2vec2 (by default
``facebook/wav2vec2-large-xlsr-53``) and returns its ``extract_features``,
(B, T, 512) float32 numpy, with the valid share of each row.  The
``transformers`` package is imported, and the model loaded with
``from_pretrained``, at the first call, on the device it is given (the card
unless asked for the CPU); without the package, or without the weights on
disk or a network, that first call raises.  The SSL training paths need no
extractor: they read offline feature pickles, one ``{stem}.pkl`` per
utterance holding (1, T, 512), which ``convert`` / ``convert_manifest``
write and ``load_feature_pkl`` reads.  Non-16 kHz audio is resampled with
scipy, as the reference does.

HuggingFace's ``extract_features`` come after the feature projection's
LayerNorm, where ``ssl_codec/wav2vec.py`` (the retrain encoder) stops at the
conv stack's GELU, as the JAX package's encoder does (ROADMAP C15).
"""

from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..data.audio import read_audio
from ..data.manifest import read_manifests
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "facebook/wav2vec2-large-xlsr-53"


class Wav2Vec2Extractor:
    """Lazy wrapper around a HuggingFace ``Wav2Vec2Model``."""

    def __init__(self, model_name: str = DEFAULT_MODEL, frozen: bool = True, device=None):
        self.model_name = model_name
        self.frozen = frozen
        self.device = device
        self._model = None
        self._processor = None

    def _ensure_loaded(self) -> None:
        if self._model is not None:
            return
        from transformers import Wav2Vec2FeatureExtractor, Wav2Vec2Model

        self.device = resolve_device(self.device)
        self._processor = Wav2Vec2FeatureExtractor.from_pretrained(self.model_name)
        self._model = Wav2Vec2Model.from_pretrained(self.model_name).to(self.device).eval()
        if self.frozen:
            self.freeze()

    def freeze(self) -> None:
        self._ensure_loaded()
        for p in self._model.parameters():
            p.requires_grad = False

    @staticmethod
    def _load_resampled(path, target_sr: int = 16000) -> np.ndarray:
        samples, sr = read_audio(path, mono=True)
        wave = samples[0]
        if sr != target_sr:
            from scipy import signal

            wave = signal.resample(wave, int(len(wave) * target_sr / sr)).astype(np.float32)
        return wave

    def __call__(self, audio: Sequence[Union[str, Path, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
        """Paths or 1-D waveforms -> (features (B, T, 512) float32, valid
        share of each row (B,))."""
        self._ensure_loaded()
        waves = [a if isinstance(a, np.ndarray) else self._load_resampled(a) for a in audio]
        lengths = np.asarray([len(w) for w in waves])
        batch = np.zeros((len(waves), int(lengths.max())), np.float32)
        for i, w in enumerate(waves):
            batch[i, : len(w)] = w
        inputs = self._processor(list(batch), sampling_rate=16000, return_tensors="pt",
                                 padding=False)
        values = inputs.input_values
        if values.ndim == 3:
            values = values.squeeze(0)
        dev = next(self._model.parameters()).device
        with torch.no_grad():
            out = self._model(values.to(dev))
        feats = out.extract_features.float().cpu().numpy()
        return feats, (lengths / lengths.max()).astype(np.float32)


def convert(extractor: Wav2Vec2Extractor, audio_path: Union[str, Path],
            out_dir: Union[str, Path]) -> Path:
    """Extract one utterance and pickle it as ``{out_dir}/{stem}.pkl``,
    (1, T, 512) as the reference dumps it."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    feats, _ = extractor([audio_path])
    out_path = out_dir / (Path(audio_path).stem + ".pkl")
    with open(out_path, "wb") as f:
        pickle.dump(feats[0][None], f)
    return out_path


def convert_manifest(manifest_path: Union[str, Path], out_dir: Union[str, Path],
                     model_name: str = DEFAULT_MODEL, max_duration: float = 1e9,
                     device=None) -> None:
    """Dump a whole manifest's features offline."""
    extractor = Wav2Vec2Extractor(model_name, device=device)
    entries = read_manifests(manifest_path, max_duration)
    for i, e in enumerate(entries):
        convert(extractor, e.audio_filepath, out_dir)
        if i % 100 == 0:
            logger.info("converted %d/%d", i, len(entries))


def load_feature_pkl(audio_path: Union[str, Path], ssl_folder: Union[str, Path]) -> np.ndarray:
    """The offline features of a wav path: ``{ssl_folder}/{stem}.pkl`` as
    (T, 512) float32.  The pickles are the ones ``convert`` writes: unpickling
    runs code, so read only files of a trusted dump."""
    with open(Path(ssl_folder) / (Path(audio_path).stem + ".pkl"), "rb") as f:
        feats = np.asarray(pickle.load(f), np.float32)
    return feats[0] if feats.ndim == 3 else feats
