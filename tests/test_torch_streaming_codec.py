"""The port's streaming Mimi codec (``csm_torch/codec/streaming.py``) on
the CPU: against the JAX package's streaming codec chunk by chunk, and
against the port's own whole-clip ``mimi_decode`` / ``mimi_encode``.

The counterparts of ``tests/test_mimi_streaming.py``, at the codec's full
widths with 2 transformer layers and a sliding window of 8 latent frames
(4 codec frames), so the transformer's K/V ring wraps within a few frames.
Float32 throughout.  The port's step and the JAX step, on the same bridged
parameters, agree chunk by chunk to a relative error of 1e-5 in the audio
and in every carried state (float32 sums in other orders).  Chunked decode
equals whole-clip decode to 1e-4 of the waveform's largest magnitude, the
JAX tests' tolerance; chunked encode gives the whole-clip codes (at least
99.9 % of them: an RVQ argmax on a tie may go either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.codec import mimi as jmimi
from csm_tpu.codec import streaming as jst
from csm_tpu.codec.transformer import MimiTransformerConfig as JTransformerConfig
from csm_torch.codec import mimi as tmimi
from csm_torch.codec import streaming as tst
from csm_torch.codec.transformer import MimiTransformerConfig as TTransformerConfig
from csm_torch.data.tokenizers import MimiAudioTokenizer
from csm_torch.utils.params import params_from_jax

WINDOW = 8  # latent frames at 25 Hz: 4 codec frames


@pytest.fixture(scope="module")
def codec():
    cfg_j = jmimi.MimiConfig(transformer=JTransformerConfig(num_layers=2, sliding_window=WINDOW))
    cfg_t = tmimi.MimiConfig(transformer=TTransformerConfig(num_layers=2, sliding_window=WINDOW))
    pj = jax.jit(lambda: jmimi.mimi_init(jax.random.key(7), cfg_j))()
    return cfg_j, cfg_t, pj, params_from_jax(jax.tree.map(np.asarray, pj))


def _codes(B, T, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2048, (B, 32, T)))


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:  # a k=1 conv carries no history
        return 0.0
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-9))


def _stream_decode(pt, cfg_t, codes, chunks):
    state = tst.mimi_decode_stream_init(pt, codes.shape[0], cfg_t)
    out, t = [], 0
    for n in chunks:
        audio, state = tst.mimi_decode_stream_step(pt, state, codes[:, :, t : t + n], cfg_t)
        out.append(audio)
        t += n
    assert t == codes.shape[2]
    return torch.cat(out, dim=1).numpy()


def _leaves(state):
    """A state's tensors in a fixed order, as numpy (the host int too)."""
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for s in state for x in _leaves(s)]
    return [np.asarray(state)]


def test_decode_step_matches_jax_with_its_state(codec):
    """Chunk by chunk, across the window's wrap: the port's audio and every
    carried state against the JAX step's, on the same parameters."""
    cfg_j, cfg_t, pj, pt = codec
    codes = _codes(2, 15, seed=0)
    step_j = jax.jit(lambda p, s, c: jst.mimi_decode_stream_step(p, s, c, cfg_j))
    sj = jst.mimi_decode_stream_init(pj, 2, cfg_j)
    st = tst.mimi_decode_stream_init(pt, 2, cfg_t)
    assert len(_leaves(sj)) == len(_leaves(st))
    for t in range(0, 15, 5):
        aj, sj = step_j(pj, sj, jnp.asarray(codes[:, :, t : t + 5].numpy()))
        at, st = tst.mimi_decode_stream_step(pt, st, codes[:, :, t : t + 5], cfg_t)
        assert at.shape == (2, 5 * 1920)
        assert _rel_err(at.numpy(), aj) <= 1e-5
        for a, b in zip(_leaves(st), _leaves(sj)):
            assert a.shape == b.shape
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b)
            else:
                assert _rel_err(a, b) <= 1e-5
    assert st["transformer"]["next"] == 30 and int(sj["transformer"]["next"]) == 30


def test_encode_step_matches_jax_with_its_state(codec):
    cfg_j, cfg_t, pj, pt = codec
    audio = np.random.default_rng(1).standard_normal((1, 8 * 1920)).astype(np.float32) * 0.1
    step_j = jax.jit(lambda p, s, a: jst.mimi_encode_stream_step(p, s, a, cfg_j))
    sj = jst.mimi_encode_stream_init(pj, 1, cfg_j)
    st = tst.mimi_encode_stream_init(pt, 1, cfg_t)
    for t in range(0, 8 * 1920, 4 * 1920):
        cj, sj = step_j(pj, sj, jnp.asarray(audio[:, t : t + 4 * 1920]))
        ct, st = tst.mimi_encode_stream_step(pt, st, torch.from_numpy(audio[:, t : t + 4 * 1920]),
                                             cfg_t)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        for a, b in zip(_leaves(st), _leaves(sj)):
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(a, b)
            else:
                assert _rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("B,chunks", [
    pytest.param(1, [13, 13, 13, 1], id="13-frame-chunks"),
    pytest.param(2, [1, 7, 2, 25, 3, 13, 1, 1, 9], id="irregular-B2"),
    pytest.param(1, [5] * 6, id="crosses-the-window"),
])
def test_chunked_decode_matches_whole_clip(codec, B, chunks):
    _, cfg_t, _, pt = codec
    codes = _codes(B, sum(chunks), seed=sum(chunks))
    full = tmimi.mimi_decode(pt, codes, cfg_t).numpy()
    stream = _stream_decode(pt, cfg_t, codes, chunks)
    assert stream.shape == full.shape
    assert _rel_err(stream, full) < 1e-4


def test_position_rebase_is_exact(codec, monkeypatch):
    """Positions rebase before the RoPE table ends: with the threshold at
    12 latent frames (above the window of 8) a 30-frame decode rebases many
    times and still equals the whole-clip decode."""
    _, cfg_t, _, pt = codec
    monkeypatch.setattr(tst, "_REBASE_AT", 12)
    codes = _codes(1, 30, seed=4)
    full = tmimi.mimi_decode(pt, codes, cfg_t).numpy()
    state = tst.mimi_decode_stream_init(pt, 1, cfg_t)
    out, nexts = [], []
    for t in range(0, 30, 3):
        audio, state = tst.mimi_decode_stream_step(pt, state, codes[:, :, t : t + 3], cfg_t)
        out.append(audio)
        nexts.append(state["transformer"]["next"])
    assert max(nexts) < 12 + 6 and nexts.count(WINDOW + 6) >= 3  # rebased to the window
    assert _rel_err(torch.cat(out, dim=1).numpy(), full) < 1e-4


def test_stream_decoder_wrapper_and_reset(codec):
    """The tokenizer's stream decoder: two chunks equal the whole-clip
    decode; codes past the codebook clamp; ``reset`` gives the same bytes
    again; ``decode_chunk_async`` returns the samples as a tensor."""
    _, cfg_t, _, pt = codec
    dec = MimiAudioTokenizer(pt, cfg_t).stream_decoder()
    codes = _codes(1, 10, seed=3)[0].numpy()
    codes[0, 2] = 2050  # an audio-vocab id past the codebook
    a = np.concatenate([dec.decode_chunk(codes[:, :6]), dec.decode_chunk(codes[:, 6:])])
    full = tmimi.mimi_decode(pt, torch.from_numpy(np.minimum(codes, 2047))[None], cfg_t)[0].numpy()
    assert a.dtype == np.float32 and a.shape == full.shape and _rel_err(a, full) < 1e-4
    dec.reset()
    b = dec.decode_chunk_async(codes[:, :6])
    assert isinstance(b, torch.Tensor) and b.shape == (6 * 1920,)
    np.testing.assert_array_equal(b.numpy(), a[: 6 * 1920])


def _speechlike(seed, T):
    """Band-limited noise: RVQ argmax ties stay rare."""
    x = np.random.default_rng(seed).standard_normal(T).astype(np.float32)
    k = np.hanning(65).astype(np.float32)
    return np.convolve(x, k / k.sum(), mode="same")[None]


@pytest.mark.parametrize("chunk_frames", [1, 5])
def test_chunked_encode_matches_whole_clip(codec, chunk_frames):
    _, cfg_t, _, pt = codec
    audio = torch.from_numpy(_speechlike(5, 10 * 1920))
    want = tmimi.mimi_encode(pt, audio, cfg_t).numpy()
    state = tst.mimi_encode_stream_init(pt, 1, cfg_t)
    got = []
    for t in range(0, audio.shape[1], chunk_frames * 1920):
        codes, state = tst.mimi_encode_stream_step(pt, state, audio[:, t : t + chunk_frames * 1920],
                                                   cfg_t)
        got.append(codes.numpy())
    got = np.concatenate(got, axis=2)
    assert got.shape == want.shape and np.mean(got == want) >= 0.999


def test_stream_encoder_feeds_the_decoder(codec):
    """Encoder to decoder, 2 frames at a time: codes of the full depth, the
    round trip's samples finite, a misaligned chunk refused."""
    _, cfg_t, _, pt = codec
    tok = MimiAudioTokenizer(pt, cfg_t)
    enc, dec = tok.stream_encoder(), tok.stream_decoder()
    audio = _speechlike(9, 6 * 1920)[0]
    out = []
    for t in range(0, len(audio), 2 * 1920):
        codes = enc.encode_chunk(audio[t : t + 2 * 1920])
        assert codes.shape == (32, 2) and codes.dtype == np.int32
        out.append(dec.decode_chunk(codes))
    out = np.concatenate(out)
    assert out.shape == (6 * 1920,) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="multiple of 1920"):
        enc.encode_chunk(audio[: 1920 + 1])
