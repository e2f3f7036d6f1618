"""The repository's native C++ library, built for the port and bound with
ctypes (the port's counterpart of ``lightning_asr_tpu/native/__init__.py``).

``native/ctc_decoder/ctc_beam_search.cpp`` holds the CTC prefix beam search
with its ARPA n-gram scorer and hot words, a Levenshtein distance, and a
threaded WAV parser for request bodies and for files (the data pipeline's
loader, ``load_wav_batch``).  At first use it is compiled by the host's ``g++``
(``-O3 -std=c++17 -shared -fPIC -pthread``) into
``build/torch_native/liblasr_native-<hash>.so`` under the repository root;
the hash covers the source and the flags, so an edited source is rebuilt
and an unchanged one reused.  A failed build raises with the compiler's
output: nothing falls back to Python.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
SOURCE = _REPO / "native" / "ctc_decoder" / "ctc_beam_search.cpp"
BUILD_DIR = _REPO / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_i32p = ctypes.POINTER(ctypes.c_int)
_f32p = ctypes.POINTER(ctypes.c_float)
_i16p = ctypes.POINTER(ctypes.c_int16)
# (name, restype, argtypes) of every entry point the port calls
_SIGNATURES = (
    ("lasr_lm_load", ctypes.c_void_p, [ctypes.c_char_p]),
    ("lasr_lm_free", None, [ctypes.c_void_p]),
    ("lasr_lm_order", ctypes.c_int, [ctypes.c_void_p]),
    ("lasr_decoder_create", ctypes.c_void_p,
     [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_double,
      ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_void_p]),
    ("lasr_decoder_free", None, [ctypes.c_void_p]),
    ("lasr_decoder_add_hotword", None, [ctypes.c_void_p, _i32p, ctypes.c_int, ctypes.c_float]),
    ("lasr_decode_batch", None,
     [ctypes.c_void_p, _f32p, _i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      _i32p, _i32p]),
    ("lasr_editdistance", ctypes.c_int, [_i32p, ctypes.c_int, _i32p, ctypes.c_int]),
    ("lasr_parse_wav_batch_mem", None,
     [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long), ctypes.c_int, _f32p,
      ctypes.c_int, ctypes.c_int, _i32p, _i32p]),
    ("lasr_load_wav_batch", None,
     [ctypes.POINTER(ctypes.c_char_p), _i32p, ctypes.c_int, _f32p, ctypes.c_int, ctypes.c_int,
      _i32p, _f32p, _i32p]),
    ("lasr_load_wav_batch_i16", None,
     [ctypes.POINTER(ctypes.c_char_p), _i32p, ctypes.c_int, _i16p, ctypes.c_int, ctypes.c_int,
      _i32p, _f32p, _i32p]),
)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"liblasr_native-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless it is already built.

    Returns ``{"seconds": wall time, "cached": True if nothing was built}``;
    raises ``RuntimeError`` with the compiler's output if the build fails."""
    t0 = time.perf_counter()
    with _LOCK:
        out = library_path()
        cached = out.exists()
        if not cached:
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the native library is built from "
                                   f"{SOURCE.relative_to(_REPO)} at first use")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {SOURCE.name} (rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic if two processes build
    return {"seconds": time.perf_counter() - t0, "cached": cached}


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use, with every entry point the
    port calls declared."""
    global _LIB
    if _LIB is None:
        build()
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(library_path()))
                for name, restype, argtypes in _SIGNATURES:
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _LIB = lib
    return _LIB


def editdistance_eval(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences, by the C++ kernel;
    tokens are mapped to ids first."""
    table: dict = {}

    def ids(seq):
        out = (ctypes.c_int * len(seq))()
        for i, tok in enumerate(seq):
            out[i] = table.setdefault(tok, len(table))
        return out

    return get_lib().lasr_editdistance(ids(a), len(a), ids(b), len(b))


def parse_wav_batch_mem(buffers: Sequence[bytes], max_samples: int, num_threads: int = 4):
    """Decode in-memory WAV images (HTTP request bodies) into a padded
    ``(B, max_samples)`` float32 array in one pass over the library's
    thread pool, without the interpreter lock.

    Returns ``(waves, lens, sample_rates)``; ``lens[i] == -1`` marks a
    malformed body."""
    lib = get_lib()
    B = len(buffers)
    lens = np.zeros(B, np.int32)
    srs = np.zeros(B, np.int32)
    sizes = np.asarray([len(b) for b in buffers], dtype=np.int_)
    bufs = (ctypes.c_char_p * B)(*buffers)
    out = np.zeros((B, max_samples), np.float32)
    lib.lasr_parse_wav_batch_mem(
        bufs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), B,
        out.ctypes.data_as(_f32p), max_samples, num_threads,
        lens.ctypes.data_as(_i32p), srs.ctypes.data_as(_i32p))
    return out, lens, srs


def load_wav_batch(paths: Sequence[str], offsets=None, max_samples: int = 0,
                   num_threads: int = 4, dtype: str = "float32"):
    """Decode WAV files into a padded ``(B, max_samples)`` array over the
    library's thread pool, without the interpreter lock: row i holds file
    i's mono samples from ``offsets[i]`` (0 without offsets), at most
    ``max_samples`` of them, zeros after.

    ``dtype="int16"`` keeps the PCM16 samples (a mono PCM16 file is a plain
    copy; others are mixed, scaled by 32768 and rounded), ``"float32"``
    scales them by 1/32768.  Returns ``(waves, lens, prev_samples,
    sample_rates)``: the samples each row got (-1 where the file could not
    be read or parsed), the float sample before each offset (0 at offset 0)
    and each file's rate.  Each call adds B to ``load_wav_batch.rows``."""
    if dtype not in ("int16", "float32"):
        raise ValueError(f"dtype must be 'int16' or 'float32', got {dtype!r}")
    lib = get_lib()
    B = len(paths)
    lens = np.zeros(B, np.int32)
    prevs = np.zeros(B, np.float32)
    srs = np.zeros(B, np.int32)
    offs = np.ascontiguousarray(np.zeros(B) if offsets is None else offsets, dtype=np.int32)
    c_paths = (ctypes.c_char_p * B)(*[str(p).encode() for p in paths])
    tail = (max_samples, num_threads, lens.ctypes.data_as(_i32p), prevs.ctypes.data_as(_f32p),
            srs.ctypes.data_as(_i32p))
    if dtype == "int16":
        out = np.zeros((B, max_samples), np.int16)
        lib.lasr_load_wav_batch_i16(c_paths, offs.ctypes.data_as(_i32p), B,
                                    out.ctypes.data_as(_i16p), *tail)
    else:
        out = np.zeros((B, max_samples), np.float32)
        lib.lasr_load_wav_batch(c_paths, offs.ctypes.data_as(_i32p), B,
                                out.ctypes.data_as(_f32p), *tail)
    with _LOCK:
        load_wav_batch.rows += B
    return out, lens, prevs, srs


load_wav_batch.rows = 0                      # files decoded, over every call
