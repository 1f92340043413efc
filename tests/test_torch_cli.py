"""``csm-torch-generate``, ``csm-torch-serve`` and ``csm-torch-verify`` on the CPU.

The parsers and their defaults (the watermark is on unless
``--no-watermark``), the ``--tiny-test`` path writing a wav with and
without the watermark, voice presets, ``--lora-path`` (the codes of a
generator on the merged weights), ``--adapter`` and the stdin daemon's
adapter lines, the HTTP daemon's ``/adapters``;
``csm-torch-serve`` from a request file, with ``--prefix`` (a preset's
request equals the request with its context inlined) and ``--window``, the
``--follow`` stdin daemon and the ``--http`` daemon as subprocesses (port 0,
every wait bounded), the HTTP handler's 503 past its queue and the answer
to waiting clients when the drive loop dies; and the user's path from
files: a torchtune ``ckpt.pt``, a Hugging Face Mimi ``model.safetensors``
and SilentCipher ``*.ckpt`` files written by the tests.  There the port's codes equal the JAX package's at topk=1 (both in
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
    """Both packages on their stdlib-wave + scipy route: the JAX package by
    its switch, the port by putting its plain versions in place of the
    native loader."""
    from csm_torch.data import audio as taudio_io

    monkeypatch.setenv("CSM_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(taudio_io, "load_wav", taudio_io.load_wav_plain)
    monkeypatch.setattr(taudio_io, "resample", taudio_io.resample_plain)


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


@pytest.mark.parametrize("flag,item", [pytest.param(["--lora-path", "adapter"], "A.10b",
                                                    id="flag1-A.10b")])
def test_flags_of_later_slices_raise(flag, item):
    """``--lora-path`` (ported with A.10b) needs the model its adapter was
    trained for: the tiny-test model is refused with a pointer to
    ``--flavor tiny`` (the test of the merge follows)."""
    with pytest.raises(SystemExit, match="--flavor tiny"):
        tgenerate.main(["--tiny-test", "--device", "cpu", "--text", "hi"] + flag)


def _adapter_dir(path, args, seed=3, shift=0.05, **cfg):
    """A LoRA adapter directory for ``args`` with non-zero B."""
    from csm_torch.training import lora as tlora

    cfg = tlora.LoRAConfig(**{"r": 2, **cfg})
    lo = tlora.init_lora_params(torch.Generator().manual_seed(seed), args, cfg)
    for comp in lo.values():
        for ad in comp.values():
            ad["b"] += shift
    return tlora.save_lora(str(path), lo, cfg, args), lo, cfg


def test_generate_lora_path_codes_match_merged(tmp_path, monkeypatch):
    """``--flavor tiny --lora-path``: the codes the CLI hands Mimi equal a
    Generator's on the merged weights made in memory (float32, topk=1)."""
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.models.config import tiny_file_args
    from csm_torch.training import lora as tlora
    from csm_torch.utils.params import cast_params, random_csm_params

    args = tiny_file_args()
    path, lo, cfg = _adapter_dir(tmp_path / "adapter", args, target_modules=("q_proj", "v_proj",
                                                                              "down_proj"))
    _float32_loads(monkeypatch)
    seen = {}
    real = tcommon.build_generator

    def build(a):
        g = real(a)
        g.mimi = seen["cli"] = Recording(g.mimi)
        g.mimi.decode = lambda codes: g.mimi.decoded.append(np.array(codes)) or np.zeros(
            np.shape(codes)[1] * 1920, np.float32)
        return g

    monkeypatch.setattr(tgenerate, "build_generator", build)
    out = str(tmp_path / "o.wav")
    assert tgenerate.main(["--flavor", "tiny", "--lora-path", path, "--device", "cpu",
                           "--no-watermark", "--allow-byte-tokenizer", "--text", "lora merge",
                           "--output", out, "--max-audio-length-ms", "400", "--topk", "1",
                           "--seed", "1"]) == 0
    cli = seen["cli"]
    merged = tlora.merge_lora(cast_params(random_csm_params(args, seed=0), torch.float32), lo, cfg)
    g = tgen.Generator(merged, args, mimi=Recording(cli.inner), text_tokenizer=ByteTokenizer(),
                       compute_dtype=torch.float32, device="cpu")
    g.mimi.decode = lambda codes: g.mimi.decoded.append(np.array(codes)) or np.zeros(
        np.shape(codes)[1] * 1920, np.float32)
    g.generate("lora merge", max_audio_length_ms=400, topk=1, seed=1)
    (got,), (want,) = cli.decoded, g.mimi.decoded
    np.testing.assert_array_equal(got, want)


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


def _same_pcm(got, want):
    """Equal 16-bit samples, or one step apart: the streaming codec's float
    sums differ from the whole clip's in the last bits, and the conversion
    to 16 bits truncates."""
    assert got.shape == want.shape and len(got)
    assert np.abs(got - want).max() <= 1.0001 / 32767


@pytest.mark.parametrize("watermark", [False, True])
def test_generate_stream_writes_the_clip(tmp_path, monkeypatch, capsys, watermark):
    """--stream: the chunks' arrival lines, a wav equal to the one without
    --stream at topk=1, and the watermark (a stand-in here) applied once,
    to the whole clip."""
    import csm_torch.watermarking as twm

    marked = []

    def fake_watermark(w, audio, sr):
        marked.append(len(audio))
        return audio, sr

    monkeypatch.setattr(twm, "watermark", fake_watermark)
    monkeypatch.setattr(twm, "load_watermarker", lambda *a, **kw: None)
    argv = ["--tiny-test", "--device", "cpu", "--text", "stream this", "--topk", "1",
            "--max-audio-length-ms", "640", "--chunk-frames", "2"] + (
        [] if watermark else ["--no-watermark"])
    assert tgenerate.main(argv + ["--output", str(tmp_path / "s.wav"), "--stream"]) == 0
    printed = capsys.readouterr().out
    assert "first audio: +" in printed and "chunk 1: +" in printed and "RTF" in printed
    assert tgenerate.main(argv + ["--output", str(tmp_path / "n.wav")]) == 0
    got, sr = load_wav(str(tmp_path / "s.wav"))
    want, _ = load_wav(str(tmp_path / "n.wav"))
    assert sr == 24_000
    _same_pcm(got, want)
    assert marked == ([len(got)] * 2 if watermark else [])


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
    pytest.param(["--adapter", "a=dir"], "A.10b", id="flag5-A.10b"),
    pytest.param(["--lora-path", "dir"], "A.10b", id="flag6-A.10b")])
def test_serve_flags_of_later_slices_raise(tmp_path, flag, item):
    """Ported with A.10b.  ``--adapter a=DIR``: a request naming ``a``
    decodes under it (other codes than the same request without it), one
    naming an adapter not loaded is skipped, and a spec without '=' is
    refused.  ``--lora-path`` needs the model its adapter was trained for:
    the tiny-test model is refused."""
    from csm_torch.models.config import tiny_test_args

    if flag[0] == "--lora-path":
        reqs = _requests(tmp_path, [{"id": 0, "text": "hi"}])
        with pytest.raises(SystemExit, match="--flavor tiny"):
            tserve.main(["--tiny-test", "--device", "cpu", "--requests", reqs] + flag)
        return
    path, _, _ = _adapter_dir(tmp_path / "dir", tiny_test_args(), shift=0.3,
                              target_modules=("q_proj", "v_proj", "o_proj"))
    lines = [{"id": "base", "text": "hello", "max_audio_length_ms": 400},
             {"id": "tuned", "text": "hello", "max_audio_length_ms": 400, "adapter": "a"},
             {"id": "lost", "text": "hello", "adapter": "nobody"}]
    out = _served(tmp_path, "out", lines, "--adapter", f"a={path}")
    assert sorted(os.listdir(out)) == ["base.wav", "tuned.wav"]
    assert not np.array_equal(load_wav(str(out / "base.wav"))[0],
                              load_wav(str(out / "tuned.wav"))[0])
    reqs = _requests(tmp_path, lines[:1])
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", reqs,
                        "--adapter", "nameless"]) == 2


def _served(tmp_path, name, lines, *flags):
    out = tmp_path / name
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", _requests(tmp_path, lines),
                        "--output-dir", str(out), "--n-slots", "2", "--chunk-size", "4",
                        "--topk", "1", "--no-watermark", *flags]) == 0
    return out


STREAM_LINES = [{"id": "a", "text": "hello", "max_audio_length_ms": 400},
                {"id": "b", "text": "a second one", "speaker": 1, "max_audio_length_ms": 960},
                {"id": "c", "text": "third", "max_audio_length_ms": 720}]


def test_serve_stream_batch_matches_the_server(tmp_path, capsys):
    """--stream with --requests: each wav, written by its request's sink as
    it finishes, equals the non-streamed server's; first-audio lines."""
    plain = _served(tmp_path, "plain", STREAM_LINES)
    capsys.readouterr()
    streamed = _served(tmp_path, "streamed", STREAM_LINES, "--stream")
    printed = capsys.readouterr()
    for r in STREAM_LINES:
        _same_pcm(load_wav(str(streamed / f"{r['id']}.wav"))[0],
                  load_wav(str(plain / f"{r['id']}.wav"))[0])
        assert f"{r['id']}.wav: " in printed.out
    assert printed.out.count("first audio +") == 3 and "Served 3 requests" in printed.out


class _Lines:
    """A stand-in for the stdin poller: the given lines, then EOF."""

    def __init__(self, lines):
        self.batches = [[json.dumps(r) for r in lines]]

    def poll(self):
        return (self.batches.pop(0) if self.batches else []), True


def test_serve_stream_follow_matches_the_server(tmp_path, monkeypatch, capsys):
    """--stream with --follow (lines from a stand-in for stdin): each wav
    equals the non-streamed server's; a cancel of a request still waiting
    for a slot closes and releases its sink."""
    plain = _served(tmp_path, "plain", STREAM_LINES)
    lines = STREAM_LINES + [{"id": "d", "text": "never admitted"}, {"cancel": "d"}]
    monkeypatch.setattr(tserve, "_StdinPoller", lambda: _Lines(lines))
    out = tmp_path / "followed"
    capsys.readouterr()
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", "-", "--follow",
                        "--output-dir", str(out), "--n-slots", "2", "--chunk-size", "4",
                        "--topk", "1", "--no-watermark", "--stream"]) == 0
    printed = capsys.readouterr()
    for r in STREAM_LINES:
        _same_pcm(load_wav(str(out / f"{r['id']}.wav"))[0], load_wav(str(plain / f"{r['id']}.wav"))[0])
    assert printed.out.count("first audio +") == 3 and "Served 3 requests" in printed.out
    assert "cancelled 'd' (not yet admitted)" in printed.err
    assert len(load_wav(str(out / "d.wav"))[0]) == 0  # its sink closed, empty


class _Batches:
    """A stand-in for the stdin poller: one batch of lines a poll, EOF with
    the last."""

    def __init__(self, batches):
        self.batches = [[json.dumps(r) for r in b] for b in batches]

    def poll(self):
        b = self.batches.pop(0) if self.batches else []
        return b, not self.batches


def test_follow_adapter_lines(tmp_path, monkeypatch, capsys):
    """The stdin daemon's ``load_adapter`` / ``unload_adapter`` lines and a
    prefix registered under an adapter: a stream under the adapter is
    served, unloading is refused while the stream or the prefix uses it
    and done after, and a request naming it afterwards is skipped."""
    from csm_torch.models.config import tiny_test_args

    path, _, _ = _adapter_dir(tmp_path / "spk", tiny_test_args())
    preset, _ = _voice(tmp_path)
    batches = [
        [{"load_adapter": {"name": "spk", "path": path}},
         {"register_prefix": {"name": "v", "path": preset, "adapter": "spk"}},
         {"id": "x", "text": "hello", "adapter": "spk", "max_audio_length_ms": 960},
         {"id": "p", "text": "hi", "adapter": "spk", "prefix": "v", "max_audio_length_ms": 160}],
        [{"unload_adapter": "spk"}],  # x decodes: refused
        *[[]] * 12,
        [{"unregister_prefix": "v"}],
        [{"unload_adapter": "spk"}],
        [{"id": "y", "text": "late", "adapter": "spk"}],
    ]
    monkeypatch.setattr(tserve, "_StdinPoller", lambda: _Batches(batches))
    out = tmp_path / "followed"
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", "-", "--follow",
                        "--output-dir", str(out), "--n-slots", "2", "--chunk-size", "4",
                        "--topk", "1", "--no-watermark", "--max-seq-len", "128"]) == 0
    err = capsys.readouterr().err
    assert "adapter 'spk' loaded (id 1)" in err and "prefix 'v' loaded" in err
    assert "in use by an active stream" in err
    assert "adapter 'spk' unloaded" in err and "skipping y: unknown adapter 'spk'" in err
    assert sorted(os.listdir(out)) == ["p.wav", "x.wav"]


def test_http_adapters_route(tmp_path):
    """POST /adapters loads and unloads on the drive loop's thread, /health
    lists the adapters, a bad spec answers 400 and the daemon goes on."""
    import socket
    import threading
    import urllib.error
    import urllib.request

    class Server(_FakeServer):
        def __init__(self):
            self._adapter_id = {}
            self.threads = set()

        def add_adapter(self, name, path):
            self.threads.add(threading.get_ident())
            if not os.path.isdir(path):
                raise FileNotFoundError(path)
            self._adapter_id[name] = len(self._adapter_id) + 1
            return self._adapter_id[name]

        def remove_adapter(self, name):
            self.threads.add(threading.get_ident())
            del self._adapter_id[name]

        def step(self):
            return []

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    answers = []

    def post(path, body):
        for _ in range(200):
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url + path, data=json.dumps(body).encode()), timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
            except OSError:
                import time as _time

                _time.sleep(0.05)

    def client():
        answers.append(post("/adapters", {"name": "a", "path": str(tmp_path)}))
        answers.append(post("/adapters", {"name": "b", "path": str(tmp_path / "no")}))
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            answers.append(json.loads(r.read())["adapters"])
        answers.append(post("/adapters", {"name": "a", "unload": True}))
        post("/shutdown", {})

    server = Server()
    t = threading.Thread(target=client)
    t.start()
    tserve._serve_http(f"127.0.0.1:{port}", 4, server, None, None, None)
    t.join(timeout=60)
    assert answers[0] == (200, {"status": "loaded", "name": "a", "id": 1})
    assert answers[1][0] == 400 and "FileNotFoundError" in answers[1][1]["error"]
    assert answers[2] == ["a"] and answers[3] == (200, {"status": "unloaded", "name": "a"})
    assert server.threads == {threading.get_ident()}  # the drive loop's thread only


def test_follow_releases_the_sink_of_a_request_dropped_at_submit(monkeypatch):
    """A request refused at submit (e.g. its prefix went while it waited)
    has its sink closed (done, no frames) and released."""
    closed, released = [], []

    class Refusing:
        active = np.zeros(1, bool)

        def submit(self, sr):
            raise ValueError("unknown prefix 'gone'")

        def step(self):
            return []

    class Req:
        request_id = "x"

        def on_frames(self, rid, new, done):
            closed.append((rid, new.shape[0], done))

    monkeypatch.setattr(tserve, "_StdinPoller", lambda: _Lines([{"id": "x", "text": "hi"}]))
    served = tserve._serve_follow(Refusing(), lambda i, r: Req(), None, None,
                                  attach_sink=lambda sr, t: None, drop_sink=released.append)
    assert served[0] == 0 and closed == [("x", 0, True)] and released == ["x"]


# ---------------------------------------------------------------- LoRA fine-tuning


def _recordings(d, n=2, seconds=1.2):
    d.mkdir(parents=True, exist_ok=True)
    t = np.arange(int(seconds * 24_000)) / 24_000
    for i in range(n):
        save_wav(str(d / f"utt{i}.wav"), (0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t)).astype(
            np.float32), 24_000)
        (d / f"utt{i}.txt").write_text(f"synthetic utterance number {i}")
    return str(d)


def test_finetune_lora_tiny_test(tmp_path):
    """``csm-torch-finetune-lora --tiny-test`` over an int8 base with
    ``--save-mode both`` and ``--async-checkpointing``: an adapter directory
    of the requested targets, a merged checkpoint, and the run's
    checkpoints committed; ``--fsdp`` trains a float base on a mesh of
    one rank (many ranks: tests/test_torch_parallel.py) and refuses a
    quantized one, as the JAX package does."""
    from csm_torch.cli import finetune_lora as tft
    from csm_torch.training import lora as tlora

    data, out = _recordings(tmp_path / "data"), tmp_path / "out"
    argv = ["--audio-dir", data, "--tiny-test", "--device", "cpu", "--output-dir", str(out),
            "--val-split", "0", "--epochs", "2", "--lora-r", "4",
            "--target-modules", "q_proj", "v_proj", "down_proj", "--int8-base",
            "--save-mode", "both", "--async-checkpointing"]
    assert tft.main(argv) == 0
    lo, cfg, _ = tlora.load_lora(str(out / "adapter_lora"))
    assert cfg.r == 4 and cfg.projections == ("wq", "wv", "w2") and set(lo) == {"backbone",
                                                                                 "decoder"}
    meta = json.load(open(out / "adapter_full" / "meta.json"))
    assert meta["global_step"] == 2
    assert json.load(open(out / "checkpoints" / "latest.json")) == {"latest": "final"}
    fsdp = tmp_path / "fsdp"
    assert tft.main([a for a in argv if a != "--int8-base"] + ["--fsdp", "--output-dir",
                                                                 str(fsdp)]) == 0
    assert json.load(open(fsdp / "adapter_full" / "meta.json"))["global_step"] == 2
    with pytest.raises(ValueError, match="quantized base"):  # the JAX package's refusal
        tft.main(argv + ["--fsdp"])
    a = tft.build_parser().parse_args(["--audio-dir", "d"])
    assert (a.lora_r, a.lora_alpha, a.target_modules, a.save_mode, a.device, a.learning_rate) == (
        8, 16.0, ["q_proj", "v_proj"], "lora", "cuda", 1e-4)


def test_finetune_lora_multi_tiny_test(tmp_path):
    """``csm-torch-finetune-lora-multi --tiny-test``: two speakers from a
    speakers config (one overriding the rank), an adapter each and a
    summary; a config missing a field is refused."""
    from csm_torch.cli import finetune_lora_multi as tmulti
    from csm_torch.training import lora as tlora

    speakers = [{"name": f"s{i}", "speaker_id": i, "audio_dir": _recordings(tmp_path / f"d{i}"),
                 "transcript_dir": str(tmp_path / f"d{i}")} for i in range(2)]
    speakers[1]["lora_r"] = 2
    cfg_path = tmp_path / "speakers.json"
    cfg_path.write_text(json.dumps(speakers))
    out = tmp_path / "out"
    assert tmulti.main(["--speakers-config", str(cfg_path), "--tiny-test", "--device", "cpu",
                        "--output-dir", str(out), "--val-split", "0"]) == 0
    summary = json.load(open(out / "summary.json"))
    assert [e["name"] for e in summary] == ["s0", "s1"]
    assert all(np.isfinite(e["final_loss"]) for e in summary)
    assert [tlora.load_lora(str(out / f"s{i}" / "adapter"))[1].r for i in range(2)] == [8, 2]
    cfg_path.write_text(json.dumps([{"name": "x"}]))
    with pytest.raises(ValueError, match="missing field"):
        tmulti.main(["--speakers-config", str(cfg_path), "--tiny-test", "--device", "cpu"])


# ---------------------------------------------------------------- prefixes, windows, daemons


def _voice(tmp_path):
    """A one-second context wav and a preset file naming it."""
    t = np.arange(24_000) / 24_000
    wav = tmp_path / "ctx.wav"
    save_wav(str(wav), (0.1 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 24_000)
    ctx = [{"audio": str(wav), "text": "hi", "speaker": 1}]
    preset = tmp_path / "voice.json"
    preset.write_text(json.dumps({"context": ctx}))
    return str(preset), ctx


def test_serve_prefix_preset(tmp_path, capsys):
    """--prefix: the preset's context is Mimi-encoded and registered once;
    a request naming it gives the wav of the same request with the context
    inlined (topk=1, no watermark); an unknown prefix is skipped."""
    preset, ctx = _voice(tmp_path)
    reqs = _requests(tmp_path, [
        {"id": "p0", "text": "with preset", "max_audio_length_ms": 400, "prefix": "warm"},
        {"id": "inline", "text": "with preset", "max_audio_length_ms": 400, "context": ctx},
        {"id": "bad", "text": "x", "max_audio_length_ms": 400, "prefix": "nope"},
    ])
    out = tmp_path / "served"
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", reqs, "--output-dir", str(out),
                        "--prefix", f"warm={preset}", "--n-slots", "2", "--chunk-size", "2",
                        "--topk", "1", "--no-watermark"]) == 0
    assert sorted(os.listdir(out)) == ["inline.wav", "p0.wav"]
    got, sr = load_wav(str(out / "p0.wav"))
    want, _ = load_wav(str(out / "inline.wav"))
    assert sr == 24_000 and len(got) == 5 * 1920
    np.testing.assert_array_equal(got, want)
    err = capsys.readouterr().err
    assert "prefix 'warm': 21 frames (bucket 32)" in err and "unknown prefix 'nope'" in err
    assert tserve.main(["--tiny-test", "--device", "cpu", "--requests", reqs, "--prefix", "warm"]) == 2
    assert "--prefix must be NAME=FILE.json" in capsys.readouterr().err


@pytest.mark.parametrize("window", [None, 96])
def test_serve_window_lifts_the_cap(tmp_path, window):
    """--window: a request's frames are not capped by max_seq_len (the tiny
    model's 128 columns leave 64 after its 64-bucket prompt)."""
    reqs = _requests(tmp_path, [{"id": "long", "text": "a long one", "max_audio_length_ms": 16_000}])
    out = tmp_path / "out"
    argv = ["--tiny-test", "--device", "cpu", "--requests", reqs, "--output-dir", str(out),
            "--chunk-size", "4", "--no-watermark"] + (["--window", str(window)] if window else [])
    assert tserve.main(argv) == 0
    audio, _ = load_wav(str(out / "long.wav"))
    assert len(audio) == (200 if window else 64) * 1920


def test_stdin_poller_multi_line_and_partial():
    """Several lines in one write surface at once, a partial line waits
    without blocking, an unterminated last line comes at EOF."""
    r, w = os.pipe()
    try:
        p = tserve._StdinPoller(fd=r)
        os.write(w, b'{"id":"a"}\n{"id":"b"}\n{"id":"c"')
        assert p.poll() == (['{"id":"a"}', '{"id":"b"}'], False)
        assert p.poll() == ([], False)
        os.write(w, b'}\n')
        assert p.poll() == (['{"id":"c"}'], False)
        os.write(w, b'{"id":"d"}')
        os.close(w)
        w = None
        assert p.poll() == (['{"id":"d"}'], True)
    finally:
        os.close(r)
        if w is not None:
            os.close(w)


def _serve_proc(*argv, stdin=None):
    return subprocess.Popen(
        [sys.executable, "-m", "csm_torch.cli.serve", "--tiny-test", "--device", "cpu",
         "--no-watermark", "--n-slots", "2", "--chunk-size", "2", *argv],
        stdin=stdin, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=dict(os.environ, CSM_TPU_NO_NATIVE="1"))


def test_serve_follow_admits_incrementally(tmp_path):
    """--follow: lines piped to stdin are admitted as they arrive (a second
    line with an id in flight is refused), each wav is written when its
    request finishes, and the daemon exits 0 at EOF once drained."""
    import time as _time

    out = tmp_path / "followed"
    proc = _serve_proc("--requests", "-", "--follow", "--output-dir", str(out), stdin=subprocess.PIPE)
    try:
        proc.stdin.write(json.dumps({"id": "fa", "text": "first", "max_audio_length_ms": 400}) + "\n"
                         + json.dumps({"id": "fa", "text": "the same id"}) + "\n"
                         + json.dumps({"cancel": "nobody"}) + "\n")
        proc.stdin.flush()
        _time.sleep(1.0)
        proc.stdin.write(json.dumps({"id": "fb", "text": "later", "max_audio_length_ms": 320}) + "\n")
        stdout = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stdout
    for rid, frames in (("fa", 5), ("fb", 4)):
        audio, sr = load_wav(str(out / f"{rid}.wav"))
        assert sr == 24_000 and len(audio) == frames * 1920
    assert "duplicate in-flight id 'fa' rejected" in stdout, stdout
    assert "cancel 'nobody': not in flight" in stdout, stdout
    assert "Served 2 requests" in stdout, stdout


def _port_of(proc, timeout=300):
    """The port a daemon's "Serving on" line names (it binds port 0)."""
    import re
    import threading

    found = {}

    def read():
        for line in proc.stdout:
            m = re.search(r"Serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                found["port"] = int(m.group(1))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    assert "port" in found, "the daemon never said where it serves"
    return found["port"]


def test_serve_http_endpoint(tmp_path):
    """--http: concurrent POST /generate requests, one of them naming a
    prefix registered at startup, each answered with a wav; a malformed one
    answers 400 and the daemon stays up; GET /health and /metrics report;
    POST /prefixes drops a preset; POST /shutdown drains and exits 0."""
    import io
    import threading
    import urllib.error
    import urllib.request
    import wave

    preset, _ = _voice(tmp_path)
    proc = _serve_proc("--http", "127.0.0.1:0", "--warmup", "--prefix", f"warm={preset}")
    try:
        base = f"http://127.0.0.1:{_port_of(proc)}"
        results = {}

        def post(name, body):
            req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                results[name] = (r.status, r.headers["Content-Type"], int(r.headers["X-Frames"]),
                                 r.read())

        bodies = {"a": {"text": "request a", "max_audio_length_ms": 400},
                  "b": {"text": "request b", "max_audio_length_ms": 320, "prefix": "warm"},
                  "c": {"text": "request c", "max_audio_length_ms": 240}}
        threads = [threading.Thread(target=post, args=kv) for kv in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert set(results) == set(bodies)
        for name, frames in (("a", 5), ("b", 4), ("c", 3)):
            status, ctype, n, wav = results[name]
            assert (status, ctype, n) == (200, "audio/wav", frames)
            with wave.open(io.BytesIO(wav)) as w:
                assert w.getframerate() == 24_000 and w.getnframes() == frames * 1920
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(base + "/generate", data=b'{"no_text": 1}'),
                                   timeout=60)
        assert e.value.code == 400
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
        assert health["status"] == "ok" and health["served"] == 3 and health["prefixes"] == ["warm"]
        metrics = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
        assert "csm_serve_requests_total 3" in metrics and "csm_serve_frames_total 12" in metrics
        dropped = urllib.request.urlopen(urllib.request.Request(
            base + "/prefixes", data=json.dumps({"name": "warm", "unload": True}).encode()), timeout=60)
        assert json.loads(dropped.read())["status"] == "unloaded"
        assert json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())["prefixes"] == []
        urllib.request.urlopen(urllib.request.Request(base + "/shutdown", data=b""), timeout=60)
        stdout = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, stdout
        assert "HTTP served 3 requests" in stdout, stdout
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_http_stream_answers_pcm(tmp_path):
    """--http --stream: each POST /generate is answered with s16le PCM
    (audio/L16, close-delimited) whose samples equal the wav of the same
    request served without streaming; /health counts them."""
    import threading
    import urllib.request

    plain = _served(tmp_path, "plain", STREAM_LINES)
    proc = _serve_proc("--http", "127.0.0.1:0", "--topk", "1", "--chunk-size", "4", "--stream")
    try:
        base = f"http://127.0.0.1:{_port_of(proc)}"
        results = {}

        def post(r):
            body = {k: v for k, v in r.items() if k != "id"}
            req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=300) as resp:
                results[r["id"]] = (resp.headers["Content-Type"], resp.read())

        threads = [threading.Thread(target=post, args=(r,)) for r in STREAM_LINES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for r in STREAM_LINES:
            ctype, pcm = results[r["id"]]
            assert ctype == "audio/L16;rate=24000;channels=1"
            got = np.frombuffer(pcm, "<i2").astype(np.int64)
            want = np.round(load_wav(str(plain / f"{r['id']}.wav"))[0] * 32768).astype(np.int64)
            assert got.shape == want.shape and np.abs(got - want).max() <= 1  # one 16-bit step
        health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
        assert health["served"] == 3
        urllib.request.urlopen(urllib.request.Request(base + "/shutdown", data=b""), timeout=60)
        stdout = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0 and "HTTP served 3 requests" in stdout, stdout
        assert "skipping the watermark" not in stdout  # --no-watermark: nothing to skip
    finally:
        if proc.poll() is None:
            proc.kill()


class _FakeServer:
    n_slots = 2
    active = np.zeros(2, bool)
    _prefixes = {}
    _adapter_id = {}


def _drive(handler, method, path, body=b""):
    import io

    h = handler.__new__(handler)
    h.path, h.request_version = path, "HTTP/1.1"
    h.requestline = f"{method} {path} HTTP/1.1"
    h.client_address = ("127.0.0.1", 0)
    h.headers = {"Content-Length": str(len(body))}
    h.rfile, h.wfile = io.BytesIO(body), io.BytesIO()
    getattr(h, f"do_{method}")()
    return h.wfile.getvalue().decode("latin-1")


def test_http_handler_overload_503():
    """A full admission queue (--http-queue) answers 503 at once; /health,
    /metrics and errors keep answering; a freed place admits again."""
    import queue
    import threading

    inbox = queue.Queue(maxsize=1)
    inbox.put_nowait(("occupied", None, None))
    H = tserve._make_http_handler(_FakeServer(), inbox, threading.Event(), {"served": 0, "frames": 0})
    out = _drive(H, "POST", "/generate", b'{"text": "hi"}')
    assert " 503 " in out.splitlines()[0] and "overloaded" in out
    assert " 200 " in _drive(H, "GET", "/health").splitlines()[0]
    metrics = _drive(H, "GET", "/metrics")
    assert "csm_serve_slots 2" in metrics and "csm_serve_queue_depth 1" in metrics
    assert " 404 " in _drive(H, "POST", "/nope").splitlines()[0]
    assert " 400 " in _drive(H, "POST", "/generate", b"not json").splitlines()[0]
    inbox.get_nowait()

    def fulfil():
        _, done, holder = inbox.get(timeout=10)
        holder.update(wav=b"RIFFfake", frames=1)
        done.set()

    t = threading.Thread(target=fulfil)
    t.start()
    out = _drive(H, "POST", "/generate", b'{"text": "hi"}')
    t.join(timeout=10)
    assert not t.is_alive()
    assert " 200 " in out.splitlines()[0] and out.endswith("RIFFfake")


def test_http_drive_loop_death_answers_waiters():
    """If the drive loop dies (here: the server's step raises), the client
    waiting on its request is answered with an error and the exception
    reaches the caller."""
    import socket
    import threading
    import time as _time
    import urllib.error
    import urllib.request

    class Dying(_FakeServer):
        active = np.zeros(2, bool)

        def submit(self, sr):
            self.active[0] = True
            return 0

        def step(self):
            raise RuntimeError("the card fell over")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    answer = {}

    def client():
        for _ in range(200):
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{port}/generate", data=b'{"text": "hi"}'), timeout=30)
            except urllib.error.HTTPError as e:
                answer["code"], answer["body"] = e.code, e.read().decode()
                return
            except OSError:
                _time.sleep(0.05)

    class Req:
        request_id = 0

    t = threading.Thread(target=client)
    t.start()
    with pytest.raises(RuntimeError, match="fell over"):
        tserve._serve_http(f"127.0.0.1:{port}", 4, Dying(), lambda i, r: Req(), None, None)
    t.join(timeout=60)
    assert not t.is_alive()
    assert answer["code"] == 400 and "server loop terminated" in answer["body"]


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
