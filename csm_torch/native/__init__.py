"""Native (C++) host-side kernels of the data pipeline.

ctypes bindings over a library built from ``audio_kernels.cpp`` with
``g++ -O3 -march=native -shared -fPIC``: WAV decode with mono mixdown
(8/16/24/32-bit PCM and float32), polyphase FIR resampling and
silence-trim bounds.  ``csm_torch/data/audio.py`` routes ``load_wav``,
``resample`` and ``load_audio`` through these; its numpy/scipy route stays
beside them as the plain version (``load_wav_plain``, ``resample_plain``).

The library builds at first use, as the CUDA kernels do
(``utils/cuda_build.py``): into ``build/native/`` at the repository root
(git-ignored), named by a hash of the source and the flags, through a
temporary file and ``os.replace``, so processes building at once each load
a whole library.  A library that cannot be built or loaded raises; there is
no quiet fallback to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audio_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("is_float", ctypes.c_int32),
        ("n_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
    ]


def library_path() -> Path:
    """Where the library lives: keyed by the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libcsm_audio-{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native audio loader needs a C++ compiler")
    return found


def build() -> Path:
    """Build the library unless it is there; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.csm_wav_info.restype = ctypes.c_int
        lib.csm_wav_info.argtypes = [ctypes.c_char_p, i64, ctypes.POINTER(_WavInfo)]
        lib.csm_wav_decode.restype = ctypes.c_int
        lib.csm_wav_decode.argtypes = [ctypes.c_char_p, i64, f32]
        lib.csm_resample_len.restype = i64
        lib.csm_resample_len.argtypes = [i64, ctypes.c_int32, ctypes.c_int32]
        lib.csm_resample.restype = ctypes.c_int
        lib.csm_resample.argtypes = [
            f32, i64, ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), ctypes.c_int32, f32,
        ]
        lib.csm_trim_bounds.restype = ctypes.c_int
        lib.csm_trim_bounds.argtypes = [
            f32, i64, ctypes.c_int32, ctypes.c_float,
            ctypes.POINTER(i64), ctypes.POINTER(i64),
        ]
        _lib = lib
        return lib


def wav_decode(raw: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes → (mono float32, sample_rate)."""
    lib = load_library()
    info = _WavInfo()
    rc = lib.csm_wav_info(raw, len(raw), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"bad WAV (rc={rc})")
    out = np.empty(info.n_frames, np.float32)
    rc = lib.csm_wav_decode(raw, len(raw), out)
    if rc != 0:
        raise ValueError(f"WAV decode failed (rc={rc})")
    return out, int(info.sample_rate)


def _kaiser_lowpass(up: int, down: int, taps_per_phase: int = 10) -> np.ndarray:
    """Kaiser-windowed sinc prototype (resample_poly's default design):
    cutoff at min(1/up, 1/down), beta 8.555, scaled by up."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate  # in half-cycles/sample of the upsampled stream
    half = taps_per_phase * max_rate
    n = 2 * half + 1
    t = np.arange(n) - half
    h = cutoff * np.sinc(cutoff * t)
    h *= np.kaiser(n, 8.555)
    return (h * up).astype(np.float64)


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample from ``sr`` to ``target_sr``."""
    if sr == target_sr:
        return np.asarray(audio, np.float32)
    lib = load_library()
    g = math.gcd(sr, target_sr)
    up, down = target_sr // g, sr // g
    x = np.ascontiguousarray(audio, np.float32)
    fir = _kaiser_lowpass(up, down)
    out = np.empty(lib.csm_resample_len(len(x), up, down), np.float32)
    rc = lib.csm_resample(x, len(x), up, down, fir, len(fir), out)
    if rc != 0:
        raise ValueError(f"resample failed (rc={rc})")
    return out


def trim_silence_bounds(audio: np.ndarray, win: int = 480,
                        threshold: float = 0.1) -> Tuple[int, int]:
    """[start, end) bounds of non-silence (energy gate against the global
    RMS)."""
    lib = load_library()
    x = np.ascontiguousarray(audio, np.float32)
    s, e = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.csm_trim_bounds(x, len(x), win, threshold, ctypes.byref(s), ctypes.byref(e))
    if rc != 0:
        raise ValueError(f"trim failed (rc={rc})")
    return int(s.value), int(e.value)
