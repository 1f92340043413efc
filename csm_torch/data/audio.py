"""Audio file I/O and resampling (host-side).

``load_wav``, ``resample`` and ``load_audio`` go through the native C++
loader (``csm_torch/native``: WAV decode with mono mixdown and a polyphase
FIR resampler, one pass each), as the JAX package's do; a loader that
cannot be built raises.  The stdlib-``wave`` + ``scipy.signal.resample_poly``
route stays beside it as the plain version, ``load_wav_plain`` and
``resample_plain``: the same contract, which the tests hold the native
route to.
"""

from __future__ import annotations

import io
import math
import wave
from typing import Tuple

import numpy as np
from scipy import signal

from csm_torch import native


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a WAV file → (mono float32 in [-1, 1], sample_rate) through the
    native decoder: 8/16/24/32-bit PCM and float32; multi-channel is
    averaged to mono."""
    with open(path, "rb") as f:
        return native.wav_decode(f.read())


def load_wav_plain(path: str) -> Tuple[np.ndarray, int]:
    """``load_wav`` in numpy (8/16/24/32-bit PCM; no float32 WAVs)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    if width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        i = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i = np.where(i >= 1 << 23, i - (1 << 24), i)
        x = i.astype(np.float32) / float(1 << 23)
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def save_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM WAV."""
    with open(path, "wb") as f:
        f.write(wav_bytes(audio, sample_rate))


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """Mono float32 [-1, 1] → in-memory 16-bit PCM WAV."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample through the native kernel."""
    return native.resample(audio, sr, target_sr)


def resample_plain(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample with scipy (matches torchaudio.functional.resample
    class)."""
    if sr == target_sr:
        return np.asarray(audio, np.float32)
    g = math.gcd(sr, target_sr)
    return signal.resample_poly(
        np.asarray(audio, np.float64), target_sr // g, sr // g
    ).astype(np.float32)


def load_audio(path: str, target_sr: int = 24_000) -> np.ndarray:
    """Load → mono → resample to ``target_sr`` (reference:
    src/csm/data/training_data.py:58-66)."""
    x, sr = load_wav(path)
    return resample(x, sr, target_sr)
