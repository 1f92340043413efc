"""The port's Mimi codec held against the JAX package's on the same
random parameters (``mimi_init`` bridged with ``params_from_jax``), at the
full codec widths with 2 transformer layers (the configuration of
tests/test_mimi_parity.py).  Float32 on the CPU: waveforms agree to 1e-5
absolute (measured 9e-7 on outputs of magnitude ~0.7); codes, being argmax
decisions, agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.codec import mimi as jmimi
from csm_tpu.codec.transformer import MimiTransformerConfig as JTransformerConfig
from csm_torch.codec import mimi as tmimi
from csm_torch.codec.transformer import MimiTransformerConfig as TTransformerConfig
from csm_torch.utils.params import params_from_jax


@pytest.fixture(scope="module")
def codec():
    cfg_j = jmimi.MimiConfig(transformer=JTransformerConfig(num_layers=2))
    cfg_t = tmimi.MimiConfig(transformer=TTransformerConfig(num_layers=2))
    pj = jax.jit(lambda: jmimi.mimi_init(jax.random.key(1), cfg_j))()
    return cfg_j, cfg_t, pj, params_from_jax(jax.tree.map(np.asarray, pj))


def test_decode(codec):
    cfg_j, cfg_t, pj, pt = codec
    codes = np.random.default_rng(1).integers(0, 2048, (2, 32, 13))
    want = jax.jit(jmimi.mimi_decode, static_argnames=("cfg",))(pj, jnp.asarray(codes), cfg_j)
    got = tmimi.mimi_decode(pt, torch.from_numpy(codes), cfg_t)
    assert got.shape == (2, 13 * cfg_t.samples_per_frame)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("num_quantizers", [None, 4])
def test_encode(codec, num_quantizers):
    cfg_j, cfg_t, pj, pt = codec
    audio = np.random.default_rng(0).standard_normal((1, 24000)).astype(np.float32) * 0.1
    want = jax.jit(jmimi.mimi_encode, static_argnames=("cfg", "num_quantizers"))(
        pj, jnp.asarray(audio), cfg_j, num_quantizers)
    got = tmimi.mimi_encode(pt, torch.from_numpy(audio), cfg_t, num_quantizers)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_num_frames():
    for n in (1920, 24000, 24001, 48000):
        assert tmimi.mimi_num_frames(n) == jmimi.mimi_num_frames(n)


def test_audio_tokenizer_pads_to_buckets(codec):
    """The tokenizer pads to 25-frame buckets and trims back; codes beyond
    the codebook clamp to its last entry."""
    from csm_torch.data.tokenizers import MimiAudioTokenizer

    _, cfg_t, _, pt = codec
    tok = MimiAudioTokenizer(pt, cfg_t, num_quantizers=4)
    audio = np.random.default_rng(2).standard_normal(5000).astype(np.float32) * 0.1
    codes = tok.encode(audio)
    assert codes.shape == (4, 3)
    full = tmimi.mimi_encode(pt, torch.from_numpy(audio[None]), cfg_t, 4)
    np.testing.assert_array_equal(codes, full[0, :, :3].numpy())
    codes[0, 0] = 2050  # an audio-vocab id past the 2048-entry codebook
    wave = tok.decode(codes)
    assert wave.shape == (3 * cfg_t.samples_per_frame,) and wave.dtype == np.float32
    clamped = np.pad(np.minimum(codes, 2047), ((0, 0), (0, 22)))
    ref = tmimi.mimi_decode(pt, torch.from_numpy(clamped[None]), cfg_t)[0]
    np.testing.assert_array_equal(wave, ref[: wave.shape[0]].numpy())
