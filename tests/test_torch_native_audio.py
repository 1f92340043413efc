"""The port's native audio loader (``csm_torch/native``) on the CPU.

Held bit for bit against the JAX package's ``csm_tpu.native`` functions on
the same WAV bytes and sample rates, and against the port's plain numpy /
scipy route at ``tests/test_native.py``'s tolerances (decode 1e-3, stereo
2e-3, float32 1e-6, resample SNR > 40 dB, ``load_audio`` 5e-3).

The JAX package's library is not the one its own tests build in
``csm_tpu/native/``: this file compiles ``csm_tpu/native/audio_kernels.cpp``
with the same flags into a temporary directory and points
``csm_tpu.native`` at it for the module's tests (restored after), so
nothing here writes, deletes or waits on that directory.  The port builds
into ``build/native/`` through a temporary file and ``os.replace``; a test
starts several processes building into one empty directory at once.
"""

import shutil
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from csm_tpu import native as jnative
from csm_torch import native as tnative
from csm_torch.data import audio as taudio

REPO = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """csm_tpu.native bound to a private build of its own source."""
    d = tmp_path_factory.mktemp("jax_native")
    so = d / "libcsm_audio.so"
    subprocess.run(["g++", *tnative.CXX_FLAGS, "-o", str(so),
                    str(REPO / "csm_tpu" / "native" / "audio_kernels.cpp")],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", str(so))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.load_library() is not None
        yield jnative


def sine(seconds=1.0, sr=24_000, hz=440.0, amp=0.3):
    t = np.arange(int(seconds * sr)) / sr
    return (amp * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def pcm_wav(x, sr, width, channels=1) -> bytes:
    """A PCM WAV of ``width`` bytes per sample; channel c is x scaled by
    1/(c+1)."""
    x = np.stack([x / (c + 1) for c in range(channels)], axis=1).reshape(-1)
    if width == 1:
        raw = np.clip(x * 127 + 128, 0, 255).astype(np.uint8).tobytes()
    else:
        top = 2 ** (8 * width - 1)
        i = np.clip(np.round(x * (top - 1)), -top, top - 1).astype(np.int64)
        raw = (i[:, None] >> (8 * np.arange(width))[None, :] & 0xFF).astype(np.uint8).tobytes()
    import io

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)
    return buf.getvalue()


def float_wav(x, sr, channels=1) -> bytes:
    """IEEE float32 WAV (format 3), which the stdlib cannot write."""
    data = np.repeat(x[:, None], channels, axis=1).astype("<f4").tobytes()
    fmt = (b"fmt " + (16).to_bytes(4, "little") + (3).to_bytes(2, "little")
           + channels.to_bytes(2, "little") + sr.to_bytes(4, "little")
           + (sr * 4 * channels).to_bytes(4, "little") + (4 * channels).to_bytes(2, "little")
           + (32).to_bytes(2, "little"))
    return (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE" + fmt + b"data"
            + len(data).to_bytes(4, "little") + data)


WAVS = {
    "pcm8": lambda: pcm_wav(sine(0.2, 8_000, 300.0), 8_000, 1),
    "pcm16": lambda: pcm_wav(sine(0.3, 24_000), 24_000, 2),
    "pcm24": lambda: pcm_wav(sine(0.2, 22_050, 500.0), 22_050, 3),
    "pcm32": lambda: pcm_wav(sine(0.2, 44_100, 700.0), 44_100, 4),
    "float32": lambda: float_wav(sine(0.1, 16_000), 16_000),
    "stereo16": lambda: pcm_wav(sine(0.2, 16_000, 300.0), 16_000, 2, channels=2),
}


@pytest.mark.parametrize("kind", sorted(WAVS))
def test_decode_bit_equal_to_jax(jax_native, kind):
    raw = WAVS[kind]()
    got, sr = tnative.wav_decode(raw)
    want, want_sr = jax_native.wav_decode(raw)
    assert sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr", [44_100, 16_000])
def test_resample_bit_equal_to_jax(jax_native, sr):
    x = sine(0.5, sr) + 0.05 * np.random.default_rng(sr).standard_normal(sr // 2).astype(np.float32)
    np.testing.assert_array_equal(tnative.resample(x, sr, 24_000), jax_native.resample(x, sr, 24_000))


def test_trim_bounds_equal_to_jax(jax_native):
    x = np.zeros(24_000, np.float32)
    x[8000:16000] = sine(8000 / 24_000)[:8000]
    assert tnative.trim_silence_bounds(x) == jax_native.trim_silence_bounds(x)
    s, e = tnative.trim_silence_bounds(x, win=480, threshold=0.1)
    assert 7000 <= s <= 8500 and 15500 <= e <= 17000


@pytest.mark.parametrize("kind,atol", [("pcm16", 1e-3), ("pcm24", 1e-3), ("pcm8", 1e-2),
                                       ("stereo16", 2e-3)])
def test_decode_matches_plain(tmp_path, kind, atol):
    p = tmp_path / "a.wav"
    p.write_bytes(WAVS[kind]())
    got, sr = taudio.load_wav(str(p))
    want, want_sr = taudio.load_wav_plain(str(p))
    assert sr == want_sr and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)


def test_float32_wav_through_load_wav(tmp_path):
    """float32 WAVs, which only the native route reads."""
    x = sine(0.1, 16_000)
    p = tmp_path / "f.wav"
    p.write_bytes(float_wav(x, 16_000))
    got, sr = taudio.load_wav(str(p))
    assert sr == 16_000
    np.testing.assert_allclose(got, x, atol=1e-6)


@pytest.mark.parametrize("sr", [44_100, 16_000, 48_000])
def test_resample_matches_plain(sr):
    x = sine(1.0, sr)
    y, ref = taudio.resample(x, sr, 24_000), taudio.resample_plain(x, sr, 24_000)
    assert abs(len(y) - len(ref)) <= 1
    n = min(len(y), len(ref))
    core = slice(n // 10, -n // 10)
    err = y[:n][core] - ref[:n][core]
    snr = 10 * np.log10(np.mean(ref[:n][core] ** 2) / max(np.mean(err ** 2), 1e-20))
    assert snr > 40.0, snr


def test_load_audio_and_processor_take_the_native_route(tmp_path, monkeypatch):
    """``load_audio`` (and through it the processor) decodes and resamples
    natively, within 5e-3 of the plain route."""
    from csm_torch.data import processor as tproc

    p = str(tmp_path / "n.wav")
    taudio.save_wav(p, sine(0.5), 24_000)
    calls = []
    real = tnative.resample
    monkeypatch.setattr(tnative, "resample", lambda *a: calls.append(a[1:]) or real(*a))
    got = taudio.load_audio(p, 16_000)
    ref = taudio.resample_plain(taudio.load_wav_plain(p)[0], 24_000, 16_000)
    assert calls == [(24_000, 16_000)] and abs(len(got) - len(ref)) <= 1
    n = min(len(got), len(ref))
    np.testing.assert_allclose(got[:n], ref[:n], atol=5e-3)
    p3, txt = str(tmp_path / "long.wav"), tmp_path / "long.txt"
    taudio.save_wav(p3, sine(3.0), 24_000)
    txt.write_text("hello there, this is a test")
    segs = tproc.CSMDataProcessor(sample_rate=16_000).prepare_from_audio_file(p3, str(txt), 0)
    assert calls[1:] == [(24_000, 16_000)] and len(segs) >= 1


_BUILDER = """
import importlib.util, json, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("nat", sys.argv[1])
nat = importlib.util.module_from_spec(spec)
spec.loader.exec_module(nat)
nat.BUILD_DIR = Path(sys.argv[2])
nat.load_library()
x, sr = nat.wav_decode(bytes.fromhex(sys.argv[3]))
print(json.dumps([str(nat.library_path()), sr, float(x.sum())]))
"""


def test_concurrent_builds_load_whole_libraries(tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library (the same file) and decodes, and no temporary is left."""
    build = tmp_path / "build" / "native"
    raw = WAVS["pcm16"]()[:2048].hex()
    src = str(REPO / "csm_torch" / "native" / "__init__.py")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, src, str(build), raw],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    import json

    results = {tuple(json.loads(o[0])[:2]) for o in outs}
    assert len(results) == 1
    assert sorted(f.name for f in build.iterdir()) == [Path(next(iter(results))[0]).name]


def test_no_compiler_raises(tmp_path, monkeypatch):
    """Without a compiler the loader raises: no quiet numpy fallback."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.wav_decode(WAVS["pcm16"]())
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        taudio.resample(sine(0.1, 16_000), 16_000, 24_000)


def test_port_reads_no_jax_package_variable():
    """The loader's source names no variable or path of the JAX package."""
    for f in (REPO / "csm_torch" / "native" / "__init__.py", REPO / "csm_torch" / "data" / "audio.py"):
        text = f.read_text()
        assert "CSM_TPU" not in text and "csm_tpu" not in text, f
