"""The port's data path, trainer and training CLI on the CPU at tiny width.

The data path is held against the JAX package on the same inputs: WAV
loading and resampling (its stdlib-``wave`` + scipy route, with its native
loader switched off), the processor's segments, and ``CSMDataset`` items
and ``collate`` batches, front truncation included; all equal exactly.  The
trainer runs its epoch loop, checkpoints, resume, non-finite abort and
sample generation as tests/test_trainer.py runs the JAX package's, and the
``csm-torch-train`` CLI runs to its end on two synthetic recordings.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

from csm_tpu.data import audio as jaudio
from csm_tpu.data import dataset as jdataset
from csm_tpu.data import processor as jproc
from csm_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from csm_tpu.models.config import tiny_test_args
from csm_torch.cli import train as tcli
from csm_torch.cli.common import tiny_mimi
from csm_torch.data import audio as taudio
from csm_torch.data import dataset as tdataset
from csm_torch.data import processor as tproc
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models import config as tconfig
from csm_torch.training import checkpoint as tckpt
from csm_torch.training.losses import Batch
from csm_torch.training.trainer import CSMTrainer
from csm_torch.utils.params import random_csm_params
from test_torch_training import make_batch


class FakeAudioTokenizer:
    """12.5 Hz fake Mimi: codes are a function of the audio's length."""

    def __init__(self, K=4):
        self.K = K

    def encode(self, audio):
        F = max(1, int(len(audio) / 24_000 * 12.5))
        return np.random.default_rng(len(audio) % 7919).integers(1, 60, (self.K, F)).astype(np.int32)


def sine(seconds, sr=24_000, hz=440.0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.4 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def write_pcm(path, x, sr, width, channels):
    """A PCM WAV of ``width`` bytes per sample from float x in [-1, 1]."""
    x = np.repeat(x[:, None], channels, axis=1).reshape(-1)
    if width == 1:
        raw = np.clip(x * 127 + 128, 0, 255).astype(np.uint8).tobytes()
    else:
        i = np.clip(x * (2 ** (8 * width - 1) - 1), -(2 ** (8 * width - 1)),
                    2 ** (8 * width - 1) - 1).astype(np.int64)
        raw = b"".join(int(v).to_bytes(width, "little", signed=True) for v in i)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.mark.parametrize("width,channels,sr", [(2, 1, 24_000), (2, 2, 16_000), (3, 1, 22_050),
                                               (1, 2, 8_000), (4, 1, 44_100)])
def test_audio_io_matches_jax(tmp_path, monkeypatch, width, channels, sr):
    monkeypatch.setenv("CSM_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(taudio, "load_wav", taudio.load_wav_plain)  # the port's plain route
    monkeypatch.setattr(taudio, "resample", taudio.resample_plain)
    p = str(tmp_path / "a.wav")
    write_pcm(p, sine(0.2, sr, 300.0), sr, width, channels)
    got, want = taudio.load_wav(p), jaudio.load_wav(p)
    assert got[1] == want[1] == sr
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(taudio.resample(got[0], sr, 24_000),
                                  jaudio.resample(want[0], sr, 24_000))
    np.testing.assert_array_equal(taudio.load_audio(p), jaudio.load_audio(p))
    assert taudio.wav_bytes(got[0], sr) == jaudio.wav_bytes(want[0], sr)


def test_processor_segments_match_jax(tmp_path, monkeypatch):
    """Char-proportional segments of a 25 s recording and alignment-driven
    segments, through prepare_from_audio_file."""
    monkeypatch.setenv("CSM_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(taudio, "load_wav", taudio.load_wav_plain)  # the port's plain route
    monkeypatch.setattr(taudio, "resample", taudio.resample_plain)
    wav, txt, align = (str(tmp_path / n) for n in ("a.wav", "a.txt", "a.json"))
    taudio.save_wav(wav, sine(25.0, hz=220.0), 24_000)
    words = [f"word{i}" for i in range(60)]
    with open(txt, "w") as f:
        f.write(" ".join(words))
    with open(align, "w") as f:
        json.dump({"words": [{"word": w, "start": 0.4 * i, "end": 0.4 * i + 0.3}
                             for i, w in enumerate(words)]}, f)
    for alignment in (None, align):
        got = tproc.CSMDataProcessor().prepare_from_audio_file(wav, txt, 3, alignment)
        want = jproc.CSMDataProcessor().prepare_from_audio_file(wav, txt, 3, alignment)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            assert (a.text, a.speaker_id, a.metadata) == (b.text, b.speaker_id, b.metadata)
            np.testing.assert_array_equal(a.audio, b.audio)


def _examples(mod, long):
    if long:  # text and audio longer than the window: both truncation branches
        return [mod.TrainingExample("long " * 100, sine(30.0), 0),
                mod.TrainingExample("short", sine(1.0), 1)]
    conv = [mod.TrainingExample(f"hello there {i}", sine(1.0 + i * 0.2), i % 2) for i in range(3)]
    return mod.ContextualExampleGenerator(2).create_contextual_examples(conv)


@pytest.mark.parametrize("long", [False, True])
def test_dataset_items_and_collate_match_jax(long):
    kw = dict(max_seq_len=128) if long else {}
    tds = tdataset.CSMDataset(_examples(tproc, long), ByteTokenizer(), FakeAudioTokenizer(),
                              args=tconfig.tiny_test_args(), **kw)
    jds = jdataset.CSMDataset(_examples(jproc, long), JByteTokenizer(), FakeAudioTokenizer(),
                              args=tiny_test_args(), **kw)
    assert len(tds) == len(jds)
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = tdataset.collate([tds[i] for i in range(len(tds))])
    want = jdataset.collate([jds[i] for i in range(len(jds))])
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sum(b.tokens.shape[0] for b in tdataset.batch_iterator(tds, 2, seed=1)) == len(tds)


def tiny_batches(n, B=2, T=8):
    return [Batch(*map(torch.from_numpy, make_batch(tconfig.tiny_test_args(), B, T, seed=i)))
            for i in range(n)]


def make_trainer(out, **kw):
    args = tconfig.tiny_test_args()
    return CSMTrainer(output_dir=out, args=args, params=random_csm_params(args, seed=0),
                      learning_rate=1e-3, compute_dtype=torch.float32, remat=False,
                      device="cpu", **kw)


def test_trainer_runs_checkpoints_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    tr = make_trainer(out)
    data = tiny_batches(3)
    loss = tr.train(data, val_dataset=data[:1], batch_size=2, epochs=2, val_every=2,
                    save_every=100)
    assert np.isfinite(loss) and tr.global_step == 6
    ckpt_dir = os.path.join(out, "checkpoints")
    assert tckpt.latest_checkpoint(ckpt_dir).endswith("final")
    for name in ("final", "epoch_0", "epoch_1", "best"):
        assert os.path.exists(os.path.join(ckpt_dir, name, "meta.json")), name
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4, 5, 6]

    tr2 = make_trainer(out)
    tr2.prepare_optimizer()
    tr2.load_checkpoint("latest")
    assert (tr2.global_step, tr2.epoch, tr2.state.step) == (6, 1, 6)
    assert tr2.state.opt_state["count"] == 6
    torch.testing.assert_close(tr2.state.params["decoder"]["wq"], tr.state.params["decoder"]["wq"])
    params, args = tckpt.load_params(os.path.join(ckpt_dir, "final"))
    assert args == tr.args and params["backbone"]["wq"].shape == tr.params["backbone"]["wq"].shape
    audio = tr2.generate_sample("hi", mimi=tiny_mimi(args, "cpu"), text_tokenizer=ByteTokenizer(),
                                max_audio_length_ms=400)
    assert audio.dtype == np.float32 and np.isfinite(audio).all()


def test_nonfinite_abort_saves_recoverable_state(tmp_path):
    """The abort checkpoint is written before FloatingPointError propagates,
    and a fresh trainer reloads it and trains on past the bad batch."""
    out = str(tmp_path / "run")
    tr = make_trainer(out)
    tr.prepare_optimizer()
    orig, calls = tr._step_fn, {"n": 0}

    def poisoned(state, generator, batch):
        state, m = orig(state, generator, batch)
        calls["n"] += 1
        if calls["n"] == 2:  # step 2's metrics go non-finite
            m = dict(m, loss=torch.tensor(float("inf")))
        return state, m

    tr._step_fn = poisoned
    data = tiny_batches(4)
    with pytest.raises(FloatingPointError):
        tr.train(data, batch_size=2, epochs=2)
    ckpt_path = os.path.join(out, "checkpoints", "nonfinite_abort")
    assert os.path.exists(os.path.join(ckpt_path, "meta.json"))
    assert tckpt.latest_checkpoint(os.path.join(out, "checkpoints")).endswith("nonfinite_abort")

    tr2 = make_trainer(out)
    tr2.prepare_optimizer()
    tr2.load_checkpoint(ckpt_path)
    assert tr2.global_step >= 1
    assert np.isfinite(tr2.train(data[2:], batch_size=2, epochs=1))


def test_unported_options_raise(tmp_path):
    """Checkpoints written in the background (``async_checkpointing``): a
    run's checkpoints are all committed once ``train`` returns, and resume
    from them.  Device meshes are ported: in a single process a
    ``ParallelConfig`` gives a mesh of one rank that trains as the trainer
    without one (multi-rank runs: tests/test_torch_parallel.py); a
    conflicting layout is refused."""
    out = str(tmp_path / "async")
    tr = make_trainer(out, async_checkpointing=True)
    data = tiny_batches(2)
    assert np.isfinite(tr.train(data, batch_size=2, epochs=2, save_every=1))
    ckpt_dir = os.path.join(out, "checkpoints")
    assert tckpt.latest_checkpoint(ckpt_dir).endswith("final")
    for name in ("step_1", "step_2", "epoch_0", "epoch_1", "final"):
        assert os.path.exists(os.path.join(ckpt_dir, name, "meta.json")), name
    tr2 = make_trainer(out, async_checkpointing=True)
    tr2.prepare_optimizer()
    tr2.load_checkpoint("latest")
    assert tr2.global_step == tr.global_step > 0
    from csm_torch.parallel.mesh import ParallelConfig

    one = make_trainer(str(tmp_path / "mesh1"), parallel=ParallelConfig(fsdp=True))
    none = make_trainer(str(tmp_path / "nomesh"))
    assert one.mesh.shape == {"data": 1, "model": 1}
    np.testing.assert_allclose(one.train(data, batch_size=2, epochs=1),
                               none.train(data, batch_size=2, epochs=1), rtol=1e-6)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_trainer(str(tmp_path), parallel=ParallelConfig(pipeline_parallel=2, seq_parallel=2))


def test_cli_tiny_test_trains_to_the_end(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        taudio.save_wav(str(data / f"utt{i}.wav"), sine(1.2 + 0.3 * i, hz=200.0 + 50 * i), 24_000)
        (data / f"utt{i}.txt").write_text(f"synthetic utterance number {i}")
    out = str(tmp_path / "out")
    assert tcli.main(["--audio-dir", str(data), "--tiny-test", "--device", "cpu",
                      "--output-dir", out, "--val-split", "0", "--epochs", "2",
                      "--learning-rate", "1e-3"]) == 0
    meta = json.load(open(os.path.join(out, "checkpoints", "final", "meta.json")))
    assert meta["global_step"] == 2 and meta["epoch"] == 1
