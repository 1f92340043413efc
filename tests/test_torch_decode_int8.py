"""The int8 form of decode attention on the CPU: its plain version, the
JAX package's attention over its own dequantized cache, and the routing
that sends every S=1 step over an int8 (QuantKV) cache to it.

``decode_attention_int8_plain`` is ``decode_attention_plain`` over the
cache dequantized to q's dtype, bit for bit.  Against the JAX package's
``gqa_attention`` over ``dequantize_kv`` of the same codes it agrees to the
decode tests' 2e-5 (float32 sums in other orders); a row with no live key
gives zeros, where ``gqa_attention`` gives the mean of V.  A step over an
int8 cache, eager in generation and in a ``BatchedServer`` step, never
dequantizes: only a prefill (S > 1) does, one layer at a time.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.ops import attention as jattn
from csm_tpu.ops import kvcache as jkv
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.models import generation as tgen
from csm_torch.models import llama as tllama
from csm_torch.ops import decode_attention as tdec
from csm_torch.ops import kvcache as tkv
from csm_torch.utils.params import random_csm_params
from test_torch_cuda import _decode_inputs, int8_decode_mask


def _int8_inputs(B, Hq, Hkv, D, T, pattern, seed=0):
    q, k, v, _ = _decode_inputs(B, Hq, Hkv, D, T, seed)
    return q, k, v, int8_decode_mask(pattern, B, T, seed)


CASES = [(1, 32, 8, 64, 89, "full"), (8, 32, 8, 64, 1024, "serving"),
         (8, 32, 8, 64, 1280, "ring"), (2, 8, 2, 128, 32, "causal")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,T,pattern", CASES)
def test_int8_plain_is_plain_over_dequantized(dtype, B, Hq, Hkv, D, T, pattern):
    q, k, v, mask = _int8_inputs(B, Hq, Hkv, D, T, pattern)
    q, mask = torch.from_numpy(q).to(dtype), torch.from_numpy(mask)
    kq, vq = tkv.quantize_kv_rows(torch.from_numpy(k)), tkv.quantize_kv_rows(torch.from_numpy(v))
    want = tdec.decode_attention_plain(q, tkv.dequantize_kv(kq, dtype), tkv.dequantize_kv(vq, dtype),
                                       mask)
    n = (tdec.launches, tdec.int8_launches)
    got = tdec.decode_gqa_attention(q, kq, vq, mask)  # CPU: the plain int8 version
    assert (tdec.launches, tdec.int8_launches) == n
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(got, tdec.decode_attention_int8_plain(q, kq.q, kq.s, vq.q, vq.s, mask))


@pytest.mark.parametrize("B,Hq,Hkv,D,T,pattern", CASES)
def test_int8_plain_matches_jax_over_its_dequantized_cache(B, Hq, Hkv, D, T, pattern):
    q, k, v, mask = _int8_inputs(B, Hq, Hkv, D, T, pattern, seed=T)
    jk, jv = (jkv.dequantize_kv(jkv.quantize_kv_rows(jnp.asarray(x)), jnp.float32) for x in (k, v))
    want = np.asarray(jattn.gqa_attention(jnp.asarray(q), jk, jv, jnp.asarray(mask)))
    kq, vq = tkv.quantize_kv_rows(torch.from_numpy(k)), tkv.quantize_kv_rows(torch.from_numpy(v))
    got = tdec.decode_gqa_attention(torch.from_numpy(q), kq, vq, torch.from_numpy(mask)).numpy()
    live = np.broadcast_to(mask, (B, 1, T))[:, 0].any(-1)
    np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=2e-5)
    assert not got[~live].any()


def test_int8_checks_its_inputs():
    q, k, v, mask = map(torch.from_numpy, _int8_inputs(1, 4, 2, 16, 8, "full"))
    kq, vq = tkv.quantize_kv_rows(k), tkv.quantize_kv_rows(v)
    with pytest.raises(ValueError, match="both"):
        tdec.decode_gqa_attention(q, kq, v, mask)
    with pytest.raises(ValueError, match="int8"):
        tdec.decode_gqa_attention(q, tkv.QuantKV(kq.q.short(), kq.s), vq, mask)
    with pytest.raises(ValueError, match="k.s"):
        tdec.decode_gqa_attention(q, tkv.QuantKV(kq.q, kq.s.double()), vq, mask)


@pytest.fixture
def count_int8_dequantize(monkeypatch):
    """Counts the calls of the model's ``dequantize_kv`` on a QuantKV half."""
    calls = []
    real = tllama.dequantize_kv

    def counting(c, dtype):
        if isinstance(c, tkv.QuantKV):
            calls.append(tuple(c.q.shape))
        return real(c, dtype)

    monkeypatch.setattr(tllama, "dequantize_kv", counting)
    return calls


def test_generation_steps_never_dequantize(count_int8_dequantize):
    """An int8-KV generate: the prefill dequantizes each backbone layer's
    halves once; its S=1 steps go to the decode kernel's int8 form."""
    args = tconfig.tiny_test_args()
    params = tcsm.fuse_csm_params(random_csm_params(args, seed=0, device="cpu"))
    K = args.audio_num_codebooks
    tokens = np.zeros((1, 16, K + 1), np.int32)
    mask = np.zeros((1, 16, K + 1), bool)
    tokens[0, :10, -1], mask[0, :10, -1] = np.arange(1, 11), True
    res = tgen.generate_audio_tokens_jit(params, args, tokens, mask, np.array([10], np.int32),
                                         max_frames=6, temperature=1.0, topk=1,
                                         compute_dtype=torch.float32, device="cpu",
                                         kv_dtype=torch.int8)
    assert res.steps >= 5
    assert len(count_int8_dequantize) == 2 * args.backbone.num_layers  # the prefill only


def test_server_steps_never_dequantize(count_int8_dequantize):
    from csm_torch.serving import BatchedServer, StreamRequest

    args = tconfig.tiny_test_args()
    params = random_csm_params(args, seed=0, device="cpu")
    server = BatchedServer(params, args, n_slots=2, max_seq_len=128, topk=1, chunk_size=2,
                           compute_dtype=torch.float32, kv_dtype="int8", device="cpu")
    K = args.audio_num_codebooks
    tokens = np.zeros((10, K + 1), np.int32)
    mask = np.zeros((10, K + 1), bool)
    tokens[:, -1], mask[:, -1] = np.arange(1, 11), True
    server.submit(StreamRequest(tokens, mask, max_frames=8))
    assert len(count_int8_dequantize) == 2 * args.backbone.num_layers  # its prefill
    count_int8_dequantize.clear()
    for _ in range(3):
        server.step()
    assert sum(server.step_calls.values()) == 6 and count_int8_dequantize == []
