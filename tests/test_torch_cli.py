"""``csm-torch-generate`` and ``csm-torch-verify`` on the CPU.

The parsers and their defaults (the watermark is on unless
``--no-watermark``), the ``--tiny-test`` path writing a wav with and
without the watermark, voice presets, the flags that wait for later slices,
and the user's path from files: a torchtune ``ckpt.pt``, a Hugging Face
Mimi ``model.safetensors`` and SilentCipher ``*.ckpt`` files written by the
tests.  There the port's codes equal the JAX package's at topk=1 (both in
float32: in bf16 the packages' codes part after a few frames), the port's
wav equals the JAX CLI's within one 16-bit step, and the verify CLIs give
the same exit code on the same wav.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csm_tpu.watermarking import watermarker as jw
from csm_torch import generator as tgen
from csm_torch.cli import common as tcommon
from csm_torch.cli import generate as tgenerate
from csm_torch.cli import serve as tserve
from csm_torch.cli import verify as tverify
from csm_torch.data.audio import load_wav, save_wav
from test_file_checkpoint_e2e import _write_csm_ckpt, _write_silentcipher_ckpts
from test_torch_generator import Recording

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _scipy_resample(monkeypatch):
    monkeypatch.setenv("CSM_TPU_NO_NATIVE", "1")


def test_generate_parser_defaults():
    a = tgenerate.build_parser().parse_args(["--text", "hi"])
    assert (a.device, a.no_watermark, a.watermark_ckpt, a.topk, a.temperature, a.seed) == (
        "cuda", False, None, 50, 0.9, 0)
    assert (a.max_audio_length_ms, a.flavor, a.output, a.speaker, a.voice) == (
        10_000, "1b", "audio.wav", 0, None)
    assert not (a.int8 or a.int8_decoder or a.int4 or a.kv_int8 or a.stream or a.tiny_test)
    with pytest.raises(SystemExit):  # --speaker and --voice exclude each other
        tgenerate.build_parser().parse_args(["--text", "hi", "--speaker", "1", "--voice", "deep"])
    v = tverify.build_parser().parse_args(["a.wav", "--watermark-ckpt", "d"])
    assert (v.audio_path, v.watermark_ckpt, v.device) == ("a.wav", "d", "cuda")


@pytest.mark.parametrize("voice,speaker", [("neutral", 0), ("deep", 2), ("authoritative", 9)])
def test_voice_presets(voice, speaker, capsys):
    from csm_tpu.cli.common import VOICE_PRESETS

    assert tcommon.VOICE_PRESETS == VOICE_PRESETS
    a = tgenerate.build_parser().parse_args(["--text", "hi", "--voice", voice])
    assert tcommon.resolve_speaker(a) == speaker
    assert f"speaker ID: {speaker}" in capsys.readouterr().out
    assert tcommon.resolve_speaker(
        tgenerate.build_parser().parse_args(["--text", "hi", "--speaker", "4"])) == 4


@pytest.mark.parametrize("flag,item", [(["--stream"], "A.9 and A.14"),
                                       (["--lora-path", "adapter"], "A.10b")])
def test_flags_of_later_slices_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        tgenerate.main(["--tiny-test", "--device", "cpu", "--text", "hi"] + flag)


@pytest.mark.parametrize("watermark", [True, False])
def test_tiny_test_writes_a_wav(tmp_path, monkeypatch, capsys, watermark):
    out = str(tmp_path / "o.wav")
    calls = []
    real = tgen.Generator.generate_batch

    def spy(self, *a, **kw):
        calls.append(self.watermarker is not None)
        return real(self, *a, **kw)

    monkeypatch.setattr(tgen.Generator, "generate_batch", spy)
    argv = ["--tiny-test", "--device", "cpu", "--text", "hello", "--voice", "calm",
            "--output", out, "--max-audio-length-ms", "400", "--topk", "1"]
    assert tgenerate.main(argv + ([] if watermark else ["--no-watermark"])) == 0
    assert calls == [watermark]
    audio, sr = load_wav(out)
    assert sr == 24_000 and 0 < len(audio) <= 5 * 1920 and np.isfinite(audio).all()
    printed = capsys.readouterr().out
    assert "speaker ID: 6" in printed and "RTF" in printed and "watermark" in printed


def test_profile_writes_a_trace(tmp_path):
    trace = tmp_path / "trace"
    assert tgenerate.main(["--tiny-test", "--device", "cpu", "--text", "hi", "--no-watermark",
                           "--output", str(tmp_path / "o.wav"), "--max-audio-length-ms", "160",
                           "--profile", str(trace)]) == 0
    assert list(trace.glob("*.json"))


def test_tiny_test_clamps_and_refuses(tmp_path, capsys):
    out = str(tmp_path / "o.wav")
    assert tgenerate.main(["--tiny-test", "--device", "cpu", "--text", "x" * 2000,
                           "--output", out]) == 1
    assert "fills the tiny context" in capsys.readouterr().err
    assert not os.path.exists(out)


# ---------------------------------------------------------------- csm-torch-serve


def _requests(tmp_path, lines):
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return str(path)


def test_serve_parser_defaults():
    a = tserve.build_parser().parse_args(["--requests", "r.jsonl"])
    assert (a.device, a.n_slots, a.max_seq_len, a.chunk_size, a.ramp_chunk, a.pipelined) == (
        "cuda", 8, 2048, 8, None, True)
    assert (a.weight_dtype, a.kv_dtype, a.topk, a.temperature, a.output_dir, a.no_watermark) == (
        "bf16", "bf16", 50, 0.9, "served", False)


@pytest.mark.parametrize("watermark", [False, True])
def test_serve_writes_one_wav_per_request(tmp_path, capsys, watermark):
    """--requests: one wav per servable request (budgets clamp to the tiny
    context), a duplicate id rejected, the stats line printed."""
    reqs = _requests(tmp_path, [
        {"id": "a", "text": "hello", "max_audio_length_ms": 400},
        {"id": "b", "text": "a second one", "speaker": 1, "max_audio_length_ms": 320},
        {"id": "a", "text": "the same id again"},
        {"text": "no id: its line number", "max_audio_length_ms": 160},
    ])
    out = tmp_path / "out"
    argv = ["--tiny-test", "--device", "cpu", "--requests", reqs, "--output-dir", str(out),
            "--n-slots", "2", "--topk", "1"] + ([] if watermark else ["--no-watermark"])
    assert tserve.main(argv) == 0
    assert sorted(os.listdir(out)) == ["3.wav", "a.wav", "b.wav"]
    for name, frames in (("a.wav", 5), ("b.wav", 4), ("3.wav", 2)):
        audio, sr = load_wav(str(out / name))
        assert sr == 24_000 and np.isfinite(audio).all() and len(audio)
        if not watermark:  # the watermark resamples to 44.1 kHz and back
            assert len(audio) == frames * 1920
    captured = capsys.readouterr()
    assert "duplicate id 'a' rejected" in captured.err
    assert "Served 3 requests" in captured.out and "aggregate RTF" in captured.out


@pytest.mark.parametrize("flag,item", [
    (["--http", "8080"], "A.9"), (["--follow"], "A.9"), (["--stream"], "A.9 and A.14"),
    (["--prefix", "voice=v.json"], "A.9"), (["--window", "512"], "A.9"),
    (["--adapter", "a=dir"], "A.10b"), (["--lora-path", "dir"], "A.10b")])
def test_serve_flags_of_later_slices_raise(tmp_path, flag, item):
    reqs = _requests(tmp_path, [{"id": 0, "text": "hi"}])
    with pytest.raises(NotImplementedError, match=item):
        tserve.main(["--tiny-test", "--device", "cpu", "--requests", reqs] + flag)


# ---------------------------------------------------------------- from files


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(ckpt.pt, model.safetensors, SilentCipher dir): the formats of the
    real files, CSM at ``tiny_file_args()``, Mimi at full size."""
    import transformers
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("files")
    ckpt, mimi, sc = str(d / "ckpt.pt"), str(d / "model.safetensors"), str(d / "silentcipher")
    _write_csm_ckpt(ckpt)
    torch.manual_seed(0)
    model = transformers.MimiModel(transformers.MimiConfig())
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, mimi)
    _write_silentcipher_ckpts(sc)
    return ckpt, mimi, sc


def _argv(files, out, *extra):
    ckpt, mimi, sc = files
    return ["--model-path", ckpt, "--mimi-path", mimi, "--flavor", "tiny", "--watermark-ckpt", sc,
            "--allow-byte-tokenizer", "--text", "file level end to end", "--output", out,
            "--max-audio-length-ms", "400", "--topk", "1", "--seed", "1", *extra]


def _float32_loads(monkeypatch):
    """Both packages' ``load_csm`` in float32 compute (the CLIs' bf16 would
    make their codes part after a few frames)."""
    import jax.numpy as jnp

    from csm_tpu import generator as jgen

    real_t, real_j = tgen.load_csm, jgen.load_csm_1b
    monkeypatch.setattr(tgen, "load_csm", lambda *a, **kw: real_t(
        *a, **dict(kw, compute_dtype=torch.float32)))
    monkeypatch.setattr(jgen, "load_csm_1b", lambda *a, **kw: real_j(
        *a, **dict(kw, compute_dtype=jnp.float32)))


def test_generate_from_files_codes_match_jax(files, tmp_path, monkeypatch):
    """The CLI from files, the watermark on: the codes it hands Mimi equal
    those of the JAX package's generator on the same files at topk=1, and
    the wav is the watermarked decode."""
    from csm_tpu.cli import common as jcommon
    from csm_tpu.cli import generate as jgenerate

    monkeypatch.setenv("CSM_TPU_ALLOW_BYTE_TOKENIZER", "1")
    _float32_loads(monkeypatch)
    seen = {}
    for name, mod in (("port", tcommon), ("jax", jcommon)):
        real = mod.build_generator

        def build(args, real=real, name=name, **kw):
            g = real(args, **kw)
            g.mimi = seen[name] = Recording(g.mimi)
            if name == "jax":  # its codes are all this test reads
                g.mimi.decode = lambda codes: g.mimi.decoded.append(np.array(codes)) or np.zeros(
                    np.shape(codes)[1] * 1920, np.float32)
            return g

        monkeypatch.setattr(mod, "build_generator", build)
    monkeypatch.setattr(tgenerate, "build_generator", tcommon.build_generator)
    out = str(tmp_path / "o.wav")
    assert tgenerate.main(_argv(files, out, "--device", "cpu")) == 0
    jargs = jgenerate.build_parser().parse_args(_argv(files, out))
    jgen_ = jcommon.build_generator(jargs)
    jgen_.generate(jargs.text, max_audio_length_ms=400, topk=1, seed=1)
    (got,), (want,) = seen["port"].decoded, seen["jax"].decoded
    np.testing.assert_array_equal(got, want)
    audio, sr = load_wav(out)
    assert sr == 24_000 and len(audio) == got.shape[1] * 1920


def test_generate_from_files_wav_matches_jax_cli(files, tmp_path, monkeypatch):
    """The two CLIs on the same files in float32 (the JAX CLI in its own
    process, its loader patched as here): the same 16-bit samples within
    one step."""
    _float32_loads(monkeypatch)
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    assert tgenerate.main(_argv(files, ours, "--device", "cpu")) == 0
    script = (
        "import sys, jax.numpy as jnp\n"
        "from csm_tpu import generator as g\n"
        "real = g.load_csm_1b\n"
        "g.load_csm_1b = lambda *a, **kw: real(*a, **dict(kw, compute_dtype=jnp.float32))\n"
        "from csm_tpu.cli.generate import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CSM_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", script] + _argv(files, theirs), cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        pa = np.frombuffer(a.read()[44:], "<i2").astype(np.int32)
        pb = np.frombuffer(b.read()[44:], "<i2").astype(np.int32)
    assert pa.shape == pb.shape and np.abs(pa - pb).max() <= 1


def test_verify_cli_matches_jax(files, tmp_path, capsys):
    """On the same wav (44.1 kHz, 0.25 s: 23 frames, the full 52-shift
    search) and SilentCipher files the exit code is the JAX CLI's."""
    wav = str(tmp_path / "probe.wav")
    save_wav(wav, (np.random.default_rng(0).standard_normal(11_025) * 0.1).astype(np.float32),
             44_100)
    code = tverify.main([wav, "--watermark-ckpt", files[2], "--device", "cpu"])
    assert code in (0, 1)
    assert code == (0 if jw.check_audio_from_file(wav, files[2]) else 1)
    assert capsys.readouterr().out.count("watermarked") == 2
