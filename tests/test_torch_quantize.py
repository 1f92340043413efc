"""Quantized inference in the port, held against the JAX package on the CPU.

The formats are the JAX package's byte for byte: int8 and grouped-int4
quantization, their fused layouts and the streaming quantizer give equal
bytes and bf16 scales.  ``int4_matmul`` on the CPU runs the kernel's plain
version (per-group float32 dots, scaled, summed) where the JAX package runs
dequant + matmul, so the two agree to 1e-5 of max|y| in float32 (measured
~1e-6) and to 2e-2 in bf16 (the JAX package's own kernel-vs-reference bound;
the JAX side rounds the dequantized weights to bf16 before its matmul).
Quantized generation at ``tiny_test_args()`` in float32 at topk=1 gives the
JAX package's tokens in every mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models import generation as jgen
from csm_tpu.models.config import tiny_test_args
from csm_tpu.models.llama import fuse_projections as j_fuse
from csm_tpu.ops import int4_matmul as jint4
from csm_tpu.ops import kvcache as jkv
from csm_tpu.utils import quantize as jq
from csm_torch import generator as tgenr
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.models import generation as tgen
from csm_torch.models.llama import fuse_projections as t_fuse
from csm_torch.ops import int4_matmul as tint4
from csm_torch.ops import kvcache as tkv
from csm_torch.scripts.bench_int4_cuda_cores import cuda_core_source
from csm_torch.utils import quantize as tq
from csm_torch.utils.cuda_build import CSRC
from csm_torch.utils.params import params_from_jax, tree_map


def _np(x):
    """A JAX or torch array → numpy, bf16 compared through its bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_tree(t, j):
    """Equal structure, dtypes and bytes."""
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _same_tree(t[k], j[k])
        return
    a, b = _np(t), _np(j)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _weights(shape, seed, dtype=np.float32):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    return jnp.asarray(w, dtype), params_from_jax(np.asarray(jnp.asarray(w, dtype)))


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams


# ---------------------------------------------------------------- formats


@pytest.mark.parametrize("shape,dtype", [((64, 48), jnp.float32), ((3, 128, 40), jnp.bfloat16)])
def test_int8_quantize_matches_jax(shape, dtype):
    wj, wt = _weights(shape, 0, dtype)
    qj, qt = jq.quantize_weight(wj), tq.quantize_weight(wt)
    _same_tree(qt, qj)
    _same_tree(tq.dequantize_weight(qt), jq.dequantize_weight(qj))
    assert tq.is_quantized(qt) and not tq.is_quantized_int4(qt)


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("shape,dtype", [((256, 96), jnp.float32), ((2, 512, 384), jnp.bfloat16),
                                         ((64, 16), jnp.float32)])
def test_int4_quantize_matches_jax(shape, dtype, gs):
    """Equal bytes and scales, layer-stacked weights included; a group
    larger than K becomes one group per column, as in the JAX package."""
    wj, wt = _weights(shape, gs, dtype)
    qj, qt = jq.quantize_weight_int4(wj, gs), tq.quantize_weight_int4(wt, gs)
    _same_tree(qt, qj)
    assert qt["scale4"].shape[-2] == shape[-2] // min(gs, shape[-2])
    for out in (jnp.float32, jnp.bfloat16):
        tdt = torch.float32 if out == jnp.float32 else torch.bfloat16
        _same_tree(tq.dequantize_weight_int4(qt, tdt), jq.dequantize_weight_int4(qj, out))
    with pytest.raises(ValueError, match="even group_size"):
        tq.quantize_weight_int4(wt, 3)


@pytest.mark.parametrize("M", [1, 2, 64, 65])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)])
def test_int4_matmul_matches_jax(M, dtype, tol):
    K, N = 512, 384
    rng = np.random.default_rng(M)
    wj, _ = _weights((K, N), 7)
    qj = jq.quantize_weight_int4(wj, 128)
    qt = params_from_jax(jax.tree.map(np.asarray, qj))
    x = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x, dtype), qj), np.float32)
    xt = params_from_jax(np.asarray(jnp.asarray(x, dtype)))
    n_dequant = tint4.dequant_calls
    got = tint4.int4_matmul(xt, qt)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    assert tint4.dequant_calls == n_dequant + (M > tint4.MAX_KERNEL_ROWS)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < tol, err
    # leading dims flatten to rows
    got3 = tint4.int4_matmul(xt.reshape(1, M, K), qt)
    np.testing.assert_array_equal(got3.reshape(M, N).float().numpy(), got.float().numpy())


def test_int4_plain_is_the_kernel_arithmetic():
    """Per-group float32 dots times float32 scales, summed in float32, equal
    a float64 evaluation of the same sum to float32 rounding; dropping one
    group moves the output far more."""
    rng = np.random.default_rng(5)
    wj, wt = _weights((256, 64), 3)
    qt = tq.quantize_weight_int4(wt, 32)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    got = tint4.int4_matmul_plain(x, qt)
    w64 = tq.dequantize_weight_int4(qt, torch.float64)
    want = x.double() @ w64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * want.abs().max().item())
    dropped = dict(qt, scale4=qt["scale4"].clone())
    dropped["scale4"][3] = 0
    assert (tint4.int4_matmul_plain(x, dropped) - got).abs().max() > 1e-2 * got.abs().max()


def test_int4_cuda_core_probe_edits_the_kernel_source():
    """The CUDA-core probe's edits each find their text once in
    csrc/int4_matmul.cu and route M <= 8 to the CUDA-core compute; a source
    without one of those texts is refused, not half edited."""
    src = (CSRC / tint4.SOURCE).read_text()
    out = cuda_core_source(src)
    assert "launch<1, 4, 1, 1>" in out and "launch<1, 4, 1>(" not in out
    assert out.count("int4_mma_kernel<MB, NTL, WN, CCR>") == 3
    with pytest.raises(ValueError, match="changed"):
        cuda_core_source(src.replace("unpack<C::W>(w0, w1, lo, hi);", ""))


def test_int4_matmul_grad_matches_jax():
    """dx through the custom backward equals jax.grad through the JAX
    package's custom VJP; the int4 weight gets no gradient."""
    K, N, M = 256, 96, 4
    rng = np.random.default_rng(9)
    wj, _ = _weights((K, N), 11)
    qj = jq.quantize_weight_int4(wj, 64)
    qt = params_from_jax(jax.tree.map(np.asarray, qj))
    x = rng.standard_normal((2, M, K)).astype(np.float32)
    g = rng.standard_normal((2, M, N)).astype(np.float32)
    want = jax.grad(lambda xx: jnp.sum(jint4.int4_matmul(xx, qj) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tint4.int4_matmul(xt, qt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not qt["w4p"].requires_grad


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_fused_quantized_layouts_match_jax(tiny, mode):
    """Fusing quantized projections equals the JAX package's fusion bit for
    bit, and fuse and quantize commute in the port."""
    _, _, jparams = tiny
    jquant = (jq.quantize_transformer if mode == "int8"
              else lambda t: jq.quantize_transformer_int4(t, 32))
    tquant = (tq.quantize_transformer if mode == "int8"
              else lambda t: tq.quantize_transformer_int4(t, 32))
    for comp in ("backbone", "decoder"):
        tp = params_from_jax(jparams[comp])
        fused_t = t_fuse(tquant(tp))
        _same_tree(fused_t, j_fuse(jquant(jax.tree.map(jnp.asarray, jparams[comp]))))
        _same_tree(tquant(t_fuse(tp)), fused_t)
        _same_tree(tquant(fused_t), fused_t)  # idempotent


def test_int4_refuses_int8_weights():
    _, wt = _weights((2, 64, 32), 1)
    with pytest.raises(ValueError, match="already int8"):
        tq.quantize_transformer_int4({"wq": tq.quantize_weight(wt)})


# ---------------------------------------------------------------- int8 KV


def test_quantkv_rows_and_update_layer_match_jax(tiny):
    jargs, targs, _ = tiny
    cfg = targs.backbone
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    x[0, 0, 0] = 0  # an all-zero row keeps the 1e-8 floor
    qt, qj = tkv.quantize_kv_rows(torch.from_numpy(x)), jkv.quantize_kv_rows(jnp.asarray(x))
    _same_tree({"q": qt.q, "s": qt.s}, {"q": qj.q, "s": qj.s})
    for dt in (jnp.float32, jnp.bfloat16):
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        _same_tree(tkv.dequantize_kv(qt, tdt), jkv.dequantize_kv(qj, dt))

    c_t = tkv.init_kv_cache(cfg, 2, torch.int8, max_seq_len=12)
    c_j = jkv.init_kv_cache(jargs.backbone, 2, jnp.int8, max_seq_len=12)
    assert isinstance(c_t.k, tkv.QuantKV) and c_t.max_seq_len == 12
    assert tuple(c_t.k.q.shape) == c_j.k.q.shape and tuple(c_t.k.s.shape) == c_j.k.s.shape
    vn = rng.standard_normal(x.shape).astype(np.float32)
    layer = tkv.layer_half(c_t.k, 1), tkv.layer_half(c_t.v, 1)
    kt, vt = tkv.update_layer(*layer, torch.from_numpy(x), torch.from_numpy(vn), 4)
    kj, vj = jkv.update_layer(jkv.QuantKV(c_j.k.q[1], c_j.k.s[1]), jkv.QuantKV(c_j.v.q[1], c_j.v.s[1]),
                              jnp.asarray(x), jnp.asarray(vn), jnp.int32(4))
    for a, b in ((kt, kj), (vt, vj)):
        _same_tree({"q": a.q, "s": a.s}, {"q": b.q, "s": b.s})
    # written in place: the layer-stacked cache holds the new rows
    _same_tree(c_t.k.q[1], kj.q)
    _same_tree(c_t.v.s[1], vj.s)


# ---------------------------------------------------------------- generation


def _quantized_pair(jparams, mode):
    """(JAX tree, port tree, kv_int8) for a mode, quantized on the JAX side
    and bridged."""
    jp = jax.tree.map(jnp.asarray, jparams)
    if mode == "int8":
        jp = jq.quantize_csm_params(jp)
    elif mode == "int8-decoder":
        jp = jq.quantize_csm_params(jp, components=("decoder",))
    elif mode == "int4":
        jp = jq.quantize_csm_params_int4(jp, group_size=32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), mode == "kv_int8"


def _prompts(args, lens, S_pad, seed=3):
    rng = np.random.default_rng(seed)
    K, B = args.audio_num_codebooks, len(lens)
    tokens = np.zeros((B, S_pad, K + 1), np.int32)
    mask = np.zeros((B, S_pad, K + 1), bool)
    for b, n in enumerate(lens):
        tokens[b, :n, -1] = rng.integers(1, args.text_vocab_size, n)
        mask[b, :n, -1] = True
    return tokens, mask, np.asarray(lens, np.int32)


@pytest.mark.parametrize("mode", ["int8", "int8-decoder", "int4", "kv_int8"])
def test_generate_audio_tokens_quantized_matches_jax(tiny, mode):
    jargs, targs, jparams = tiny
    jp, tp, kv8 = _quantized_pair(jparams, mode)
    tokens, mask, plen = _prompts(targs, (20, 33), 64)
    max_frames = 5
    want = jgen.generate_audio_tokens_jit(
        jcsm.fuse_csm_params(jp), jargs, jax.random.key(0), jnp.asarray(tokens),
        jnp.asarray(mask), jnp.asarray(plen), max_frames=max_frames, temperature=1.0, topk=1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8 if kv8 else None)
    n_dequant = tint4.dequant_calls
    got = tgen.generate_audio_tokens(
        tcsm.fuse_csm_params(tp), targs, tokens, mask, plen, max_frames=max_frames,
        temperature=1.0, topk=1, compute_dtype=torch.float32, device="cpu",
        kv_dtype=torch.int8 if kv8 else None)
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(got.num_frames.numpy(), np.asarray(want.num_frames))
    # the int4 prefill (B·S = 128 rows) takes the dequant route, the rest the kernel's
    L_bb = targs.backbone.num_layers
    assert tint4.dequant_calls - n_dequant == (4 * L_bb if mode == "int4" else 0)


def test_int4_tokens_match_dequantized_dense(tiny):
    """int4 is a storage format: the same tokens as its dequantized weights
    run densely."""
    _, targs, jparams = tiny
    qp = tq.quantize_csm_params_int4(params_from_jax(jparams), group_size=32)
    dense = tree_map(lambda w: tq.dequantize_weight_int4(w) if tq.is_quantized_int4(w) else w,
                     qp, is_leaf=tq.is_quantized_int4)
    tokens, mask, plen = _prompts(targs, (6, 6), 8)
    kw = dict(max_frames=4, temperature=1.0, topk=1, compute_dtype=torch.float32, device="cpu")
    r_q = tgen.generate_audio_tokens(tcsm.fuse_csm_params(qp), targs, tokens, mask, plen, **kw)
    r_d = tgen.generate_audio_tokens(tcsm.fuse_csm_params(dense), targs, tokens, mask, plen, **kw)
    np.testing.assert_array_equal(r_q.frames.numpy(), r_d.frames.numpy())


# ---------------------------------------------------------------- loading


@pytest.mark.parametrize("mode,kv8", [("none", True), (True, False), ("int8-decoder", False),
                                      ("int4", False)])
def test_load_csm_quantized_modes(mode, kv8):
    args = tconfig.tiny_test_args()
    g = tgenr.load_csm(args=args, device="cpu", quantize=mode, kv_int8=kv8,
                       text_tokenizer=ByteTokenizer())
    bb, dec = g.params["backbone"], g.params["decoder"]
    want_bb = {"none": torch.Tensor, True: dict, "int8-decoder": torch.Tensor, "int4": dict}[mode]
    assert isinstance(bb["wqkv"], want_bb) and isinstance(bb["w13"], want_bb)
    if mode != "none":
        assert (tq.is_quantized_int4 if mode == "int4" else tq.is_quantized)(dec["w2"])
        scale = dec["w2"]["scale4" if mode == "int4" else "scale"]
        assert scale.dtype == torch.bfloat16  # cast first, quantize after
    assert g.kv_dtype == (torch.int8 if kv8 else None)
    audio = g.generate("hi", max_audio_length_ms=160, topk=1)
    assert audio.dtype == np.float32 and np.isfinite(audio).all()


def test_load_csm_refuses_what_it_cannot_load():
    args = tconfig.tiny_test_args()
    with pytest.raises(ValueError, match="none|int8|int8-decoder|int4"):
        tgenr.load_csm(args=args, device="cpu", quantize="int3")
    big = tconfig.csm_8b_args()
    # the check comes before anything is made: a meta device would fail later
    with pytest.raises(ValueError, match="quantize='int8' or 'int4'"):
        tgenr.load_csm(args=big, device="meta", quantize="none")
    with pytest.raises(ValueError, match="float base"):
        tgenr.load_csm(args=big, device="meta", quantize="int4", lora_path="adapter")


def test_streaming_loader_at_tiny_size():
    """The loader the 8B flavor takes, driven at tiny width: a fused
    quantized tree that generates."""
    args = tconfig.tiny_test_args()
    g = tgenr._load_csm_streaming(None, torch.float32, "int4", True, args, None, "cpu",
                                  ByteTokenizer(), 0)
    assert tq.is_quantized_int4(g.params["backbone"]["wqkv"]) and "wq" not in g.params["backbone"]
    assert g.kv_dtype == torch.int8
    assert np.isfinite(g.generate("hi", max_audio_length_ms=160, topk=1)).all()


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_csm_params_quantized_tree_matches_jax(mode):
    jargs, targs = tiny_test_args(), tconfig.tiny_test_args()
    want = jq.init_csm_params_quantized(jax.random.key(0), jargs, mode)
    got = tq.init_csm_params_quantized(torch.Generator().manual_seed(0), targs, mode)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), _np(tree).dtype

    assert spec(got) == spec(want)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_streaming_quantizer_matches_whole(tiny, mode):
    """Per-layer-chunk quantization equals quantizing whole leaves (the
    scales never span layers); the JAX package's quantizer gives the same
    bytes."""
    _, _, jparams = tiny
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    got = tq.quantize_csm_params_streaming(host, mode, layers_per_chunk=1)
    whole = (tq.quantize_csm_params if mode == "int8" else tq.quantize_csm_params_int4)(
        params_from_jax(host))
    _same_tree(got, whole)
    _same_tree(got, jq.quantize_csm_params_streaming(host, mode, layers_per_chunk=1))
    bad = dict(host, backbone=dict(host["backbone"], wq=host["backbone"]["wq"][0]))
    with pytest.raises(ValueError, match="layer-stacked"):
        tq.quantize_csm_params_streaming(bad, mode)


def test_params_from_jax_keeps_quantized_bytes(tiny):
    """A JAX-quantized tree bridges to the same integer codes and bf16
    scales, even when float leaves are cast."""
    _, _, jparams = tiny
    jp = jq.quantize_csm_params_int4(jax.tree.map(jnp.asarray, jparams), group_size=32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    _same_tree(tp["backbone"]["wq"], jp["backbone"]["wq"])
    assert tp["text_embeddings"].dtype == torch.bfloat16
    j8 = jq.quantize_weight(jnp.asarray(jparams["decoder"]["w2"]))
    t8 = params_from_jax(jax.tree.map(np.asarray, j8), dtype=torch.float32)
    _same_tree(t8, j8)
