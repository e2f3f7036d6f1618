"""Host-side WAV decode with zero dependencies (port of
``lightning_asr_tpu/data/audio.py``).

Returns float32 in [-1, 1) with torchaudio's scaling (int PCM / 2**(bits-1)).
"""

from __future__ import annotations

import io
import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.int16, 32: np.int32}


def read_wav(source: Union[str, Path, bytes, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file. Returns (samples (channels, n) float32, sample_rate).

    Supports PCM 8/16/32-bit and IEEE float32, any channel count.
    """
    if isinstance(source, (str, Path)):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, io.BytesIO):
        data = source.getvalue()
    else:
        data = source

    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt

    if audio_format == 3 or (audio_format == 0xFFFE and bits == 32):  # IEEE float
        samples = np.frombuffer(payload, dtype=np.float32).astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM
        dtype = _PCM_DTYPES.get(bits)
        if dtype is None:
            raise ValueError(f"unsupported PCM bit depth {bits}")
        raw = np.frombuffer(payload, dtype=dtype)
        if bits == 8:  # unsigned
            samples = (raw.astype(np.float32) - 128.0) / 128.0
        else:
            samples = raw.astype(np.float32) / float(2 ** (bits - 1))
    else:
        raise ValueError(f"unsupported WAVE format tag {audio_format}")

    n = (len(samples) // channels) * channels
    samples = samples[:n].reshape(-1, channels).T  # (channels, n)
    return np.ascontiguousarray(samples), sample_rate


def read_audio(source: Union[str, Path, bytes, io.BytesIO], mono: bool = False) -> Tuple[np.ndarray, int]:
    """Decode audio. Returns (samples (channels, n) float32, sample_rate)."""
    samples, sr = read_wav(source)
    if mono and samples.shape[0] > 1:
        samples = samples.mean(axis=0, keepdims=True)
    return samples, sr


def write_wav(path: Union[str, Path], samples: np.ndarray, sample_rate: int) -> None:
    """Write float32 (n,) or (channels, n) samples as a 16-bit PCM WAV."""
    Path(path).write_bytes(wav_bytes(samples, sample_rate))


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Encode float32 (n,) or (channels, n) samples as a 16-bit PCM WAV."""
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, _ = samples.shape
    pcm = np.clip(samples.T * 32768.0, -32768, 32767).astype("<i2").tobytes()
    byte_rate = sample_rate * channels * 2
    header = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, channels * 2, 16)
    header += b"data" + struct.pack("<I", len(pcm))
    return header + pcm


def duration_seconds(source: Union[str, Path]) -> float:
    """A WAV file's length in seconds."""
    samples, sr = read_wav(source)
    return samples.shape[1] / float(sr)
