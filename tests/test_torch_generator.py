"""``Generator`` end to end, the port against the JAX package, and the
port's package rules.

Tiny CSM in float32 on the CPU, the real Mimi codec widths with 2
transformer layers, both packages on the same weights.  The codes each
Generator hands to its codec are recorded: at topk=1 they are equal, and
the waveforms agree to 1e-5 absolute (float32 codec, measured ~1e-6).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu import generator as jgen
from csm_tpu.codec import mimi as jmimi
from csm_tpu.codec.transformer import MimiTransformerConfig as JTransformerConfig
from csm_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from csm_tpu.data.tokenizers import MimiAudioTokenizer as JMimiTokenizer
from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_torch import generator as tgen
from csm_torch.codec import mimi as tmimi
from csm_torch.codec.transformer import MimiTransformerConfig as TTransformerConfig
from csm_torch.data.tokenizers import ByteTokenizer, MimiAudioTokenizer
from csm_torch.models import config as tconfig
from csm_torch.utils.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recording:
    """Wraps a codec and keeps every code array it is asked to decode, by
    the whole clip or (``stream_decoded``) by its stream decoders."""

    def __init__(self, inner):
        self.inner, self.decoded, self.stream_decoded = inner, [], []

    def encode(self, audio):
        return self.inner.encode(audio)

    def decode(self, codes):
        self.decoded.append(np.array(codes))
        return self.inner.decode(codes)

    def stream_decoder(self):
        dec, seen = self.inner.stream_decoder(), self.stream_decoded

        class Stream:
            cfg = dec.cfg

            def decode_chunk(self, codes):
                seen.append(np.array(codes))
                return dec.decode_chunk(codes)

        return Stream()


@pytest.fixture(scope="module")
def pair():
    """(JAX Generator, port Generator) on the same weights and codec."""
    # the audio vocab holds every Mimi code, as CSM's 2051 does
    jargs = tiny_test_args(audio_vocab_size=2051)
    K = jargs.audio_num_codebooks
    cfg_j = jmimi.MimiConfig(transformer=JTransformerConfig(num_layers=2))
    cfg_t = tmimi.MimiConfig(transformer=TTransformerConfig(num_layers=2))
    jparams = jcsm.init_csm_params(jax.random.key(0), jargs)
    mj = jax.jit(lambda: jmimi.mimi_init(jax.random.key(1), cfg_j))()
    gj = jgen.Generator(jparams, jargs, mimi=Recording(JMimiTokenizer(mj, cfg_j, K)),
                        text_tokenizer=JByteTokenizer(), compute_dtype=jnp.float32)
    mt = params_from_jax(jax.tree.map(np.asarray, mj))
    gt = tgen.Generator(params_from_jax(jax.tree.map(np.asarray, jparams)),
                        tconfig.tiny_test_args(audio_vocab_size=2051),
                        mimi=Recording(MimiAudioTokenizer(mt, cfg_t, K)),
                        text_tokenizer=ByteTokenizer(), compute_dtype=torch.float32,
                        device="cpu")
    return gj, gt


def _check_same(gj, gt, outs_j, outs_t):
    assert len(gj.mimi.decoded) == len(gt.mimi.decoded) > 0
    for a, b in zip(gj.mimi.decoded, gt.mimi.decoded):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(outs_j, outs_t):
        assert b.shape == a.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-4)
    for key in ("frames", "audio_s"):
        assert gt.last_stats[key] == gj.last_stats[key]


def test_generate_with_context(pair):
    """A context segment goes through Mimi encode, the reply through the
    frame loop and Mimi decode."""
    gj, gt = pair
    audio = np.random.default_rng(0).standard_normal(6000).astype(np.float32) * 0.1
    ctx_j = [jgen.Segment(0, "hey", audio)]
    ctx_t = [tgen.Segment(0, "hey", audio)]
    kw = dict(speaker=1, max_audio_length_ms=480, temperature=1.0, topk=1)
    a_j = gj.generate("hello there", context=ctx_j, **kw)
    a_t = gt.generate("hello there", context=ctx_t, **kw)
    _check_same(gj, gt, [a_j], [a_t])
    assert gt.last_stats["steps"] == 5 and gt.last_stats["prompt_bucket"] == 64
    packed = gt.precompute_context(ctx_t)
    gt.mimi.decoded.clear()
    np.testing.assert_array_equal(gt.generate("hello there", context=packed, **kw), a_t)


def test_generate_batch(pair):
    gj, gt = pair
    gj.mimi.decoded.clear()
    gt.mimi.decoded.clear()
    texts, speakers = ["short", "a rather longer line of text"], [0, 1]
    kw = dict(max_audio_length_ms=320, temperature=1.0, topk=1)
    _check_same(gj, gt, gj.generate_batch(texts, speakers, **kw),
                gt.generate_batch(texts, speakers, **kw))


def test_prompt_length_contract(pair):
    _, gt = pair
    with pytest.raises(ValueError, match="prompt too long"):
        gt.generate("x" * 200, max_audio_length_ms=400)


def test_unported_branches_raise(tmp_path):
    """Meshes wait and name their ROADMAP item (A.11).  ``lora_path`` is
    ported: the adapter merges into the cast weights before the
    quantization (int4: the merged weights quantized), and an adapter of
    another model shape is refused.  The quantized modes and the 8B
    flavor's loader have their tests in tests/test_torch_quantize.py."""
    from csm_torch.models.csm import fuse_csm_params
    from csm_torch.training import lora as tlora
    from csm_torch.utils import quantize as tq
    from csm_torch.utils.params import random_csm_params

    args = tconfig.tiny_test_args()
    cfg = tlora.LoRAConfig(r=2, target_modules=("q_proj", "down_proj"))
    lo = tlora.init_lora_params(torch.Generator().manual_seed(3), args, cfg)
    for comp in lo.values():
        for ad in comp.values():
            ad["b"] += 0.05
    path = tlora.save_lora(str(tmp_path / "adapter"), lo, cfg, args)
    merged = tlora.merge_lora(random_csm_params(args, seed=0), lo, cfg)
    for qmode, want in (("none", merged), ("int4", tq.quantize_csm_params_int4(merged))):
        g = tgen.load_csm(args=args, device="cpu", lora_path=path, quantize=qmode,
                          compute_dtype=torch.float32, text_tokenizer=ByteTokenizer())
        got, want_f = g.params["backbone"]["wqkv"], fuse_csm_params(want)["backbone"]["wqkv"]
        for k in (got if isinstance(got, dict) else {"w": got}):
            a = got[k] if isinstance(got, dict) else got
            b = want_f[k] if isinstance(want_f, dict) else want_f
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"{qmode} {k}")
    tlora.save_lora(str(tmp_path / "other"), lo, cfg, tconfig.tiny_file_args())
    with pytest.raises(ValueError, match="different model shape"):
        tgen.load_csm(args=args, device="cpu", lora_path=str(tmp_path / "other"))
    with pytest.raises(ValueError, match="quantize='int8' or 'int4'"):
        tgen.load_csm(args=tconfig.csm_8b_args(), device="cpu")
    g = tgen.load_csm(args=args, device="cpu", text_tokenizer=ByteTokenizer())
    with pytest.raises(NotImplementedError, match="A.11"):
        tgen.Generator(g.params, args, device="cpu", mesh=object())


def _stream(g, text, **kw):
    chunks = list(g.generate_streaming(text, **kw))
    assert chunks and chunks[-1][1] is True  # the last item is the done one
    assert sum(1 for _, done in chunks if done) == 1  # and the only one
    assert all(c.dtype == np.float32 for c, _ in chunks)
    return chunks


def test_streaming_matches_generate(pair):
    """At topk=1 the streamed chunks concatenate to ``generate``'s waveform
    (the JAX package's test_streaming_matches_batch contract: atol 1e-6 in
    float32; the streaming codec carries exact state), in at least two
    non-empty chunks for a 6-frame budget at chunk_frames=2; the one-slot
    server is kept for the next call, and ``close`` frees it."""
    _, gt = pair
    kw = dict(speaker=1, max_audio_length_ms=480, temperature=1.0, topk=1, seed=0)
    full = gt.generate("stream me", **kw)
    chunks = _stream(gt, "stream me", chunk_frames=2, **kw)
    audio = np.concatenate([c for c, _ in chunks])
    np.testing.assert_allclose(audio, full, atol=1e-6)
    assert len([c for c, _ in chunks if len(c)]) >= 2
    again = _stream(gt, "stream me", chunk_frames=2, **kw)
    np.testing.assert_array_equal(np.concatenate([c for c, _ in again]), audio)
    assert list(gt._stream_servers) == [(2, 1, None)]


def test_streaming_matches_jax_streaming(pair):
    """The port's stream against the JAX package's ``generate_streaming`` on
    the same weights at topk=1: every chunk's codes equal, the audio to
    1e-5."""
    gj, gt = pair
    gj.mimi.stream_decoded.clear()
    gt.mimi.stream_decoded.clear()
    kw = dict(speaker=0, max_audio_length_ms=640, temperature=1.0, topk=1, seed=0, chunk_frames=3)
    cj = list(gj.generate_streaming("the same words", **kw))
    ct = _stream(gt, "the same words", **kw)
    assert len(gt.mimi.stream_decoded) == len(gj.mimi.stream_decoded) >= 3
    for a, b in zip(gj.mimi.stream_decoded, gt.mimi.stream_decoded):
        np.testing.assert_array_equal(b, a)
    assert [d for _, d in ct] == [d for _, d in cj]
    np.testing.assert_allclose(np.concatenate([c for c, _ in ct]),
                               np.concatenate([np.asarray(c) for c, _ in cj]), atol=1e-5)


def test_streaming_window_waives_the_prompt_contract(pair):
    """``window=``: a stream longer than the cache (64-frame bucket + 72
    frames > 128 columns) runs on a sliding-window server; without the
    window the same budget is refused (by the server: the prompt itself
    is short)."""
    _, gt = pair
    kw = dict(max_audio_length_ms=72 * 80, temperature=1.0, topk=1, chunk_frames=8)
    with pytest.raises(ValueError, match="exceeds max_seq_len 128"):
        next(gt.generate_streaming("a long stream", **kw))
    chunks = _stream(gt, "a long stream", window=96, **kw)
    n = sum(len(c) for c, _ in chunks)
    assert n % 1920 == 0 and 0 < n <= 72 * 1920
    assert (8, 1, 96) in gt._stream_servers


ISOLATION = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["csm_tpu"] = None
sys.modules["safetensors"] = None
import torch
import csm_torch
names = [m.name for m in pkgutil.walk_packages(csm_torch.__path__, "csm_torch.")]
for name in names:
    importlib.import_module(name)
assert not torch.cuda.is_available()
from csm_torch import load_csm
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models.config import tiny_test_args
from csm_torch.models.generation import generate_audio_tokens
args = tiny_test_args()
for call in (lambda: load_csm(args=args, text_tokenizer=ByteTokenizer()),
             lambda: generate_audio_tokens({}, args, None, None, None, 1)):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("an entry point ran without a card")
g = load_csm(args=args, text_tokenizer=ByteTokenizer(), device="cpu")
from csm_torch.ops.int4_matmul import int4_matmul
from csm_torch.utils.quantize import quantize_weight, quantize_weight_int4
w = torch.randn(64, 32)
y = int4_matmul(torch.randn(3, 64), quantize_weight_int4(w, 32))
assert y.shape == (3, 32) and quantize_weight(w)["w8"].dtype == torch.int8
g4 = load_csm(args=args, text_tokenizer=ByteTokenizer(), device="cpu", quantize="int4", kv_int8=True)
assert "w4p" in g4.params["backbone"]["w13"]
try:
    csm_torch.Generator(g.params, args, text_tokenizer=ByteTokenizer())
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("Generator ran without a card")
from csm_torch.training.trainer import CSMTrainer
try:
    CSMTrainer(args=args, output_dir="never-made")
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("CSMTrainer ran without a card")
from csm_torch.watermarking import load_watermarker
try:
    load_watermarker()
except RuntimeError as e:
    assert "device='cpu'" in str(e), e
else:
    raise SystemExit("load_watermarker ran without a card")
from csm_torch.cli import generate, verify
import contextlib, io
for main, argv in ((generate.main, ["--tiny-test", "--text", "hi"]), (verify.main, ["x.wav"])):
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(argv)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("a CLI ran without a card")
import os, tempfile
from csm_torch.utils import safetensors_io
from csm_torch.utils.params import random_csm_params
p = random_csm_params(args, seed=0)
with tempfile.TemporaryDirectory() as d:
    path = safetensors_io.save_params_safetensors(os.path.join(d, "p.safetensors"), p, args)
    got, got_args = safetensors_io.load_params_safetensors(path, device="cpu")
    assert got_args == args and torch.equal(got["decoder"]["w2"], p["decoder"]["w2"])
assert {"csm_torch.training.trainer", "csm_torch.cli.train", "csm_torch.data.dataset",
        "csm_torch.cli.generate", "csm_torch.cli.verify", "csm_torch.watermarking.watermarker",
        "csm_torch.utils.safetensors", "csm_torch.utils.safetensors_io",
        "csm_torch.utils.checkpoint_compat", "csm_torch.codec.convert"} <= set(names)
print("OK", len(names))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of csm_torch imports with JAX and csm_tpu blocked, and
    no entry point runs on the CPU unless it is asked to."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", ISOLATION], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[0] == "OK" and int(res.stdout.split()[1]) >= 20
