"""Streaming Mimi decode and encode with carried state: O(chunk) work a
chunk.

The counterpart of the JAX package's ``codec/streaming.py``.  Mimi is
causal throughout, so every layer carries exact state across chunks:

  * causal Conv1d: the whole-clip path left-pads ``k_eff - stride`` zeros;
    streaming carries that many trailing *inputs* instead (zeros at the
    start): the same receptive field, the same outputs;
  * causal ConvTranspose1d (stride s, kernel k): input u reaches outputs
    [u·s, u·s + k − 1], so a chunk's last inputs reach ``k − s`` samples
    past its end.  A chunk emits its first ``T·s`` outputs with the carried
    tail added and keeps the new ``k − s``-sample tail; the bias is added
    once, on emit (the conv runs without it), or the overlapped samples
    would get it twice.  The depthwise upsample (``groups=hidden_size``)
    carries a tail a channel;
  * the codec transformer (sliding window 250, causal): a per-layer K/V
    ring of the last ``window`` positions with their absolute positions;
    RoPE at absolute positions, so attention sees the window the
    whole-clip mask selects.  Positions rebase before the RoPE table ends:
    cached K is counter-rotated and every position shifted down, which
    leaves the scores (they depend on differences) unchanged.  The counter
    ``next`` lives on the host, so the rebase is a host branch taken
    before a chunk, never inside one.

State is a dict of tensors on the parameters' device (and the host int
``next``).  The convs stay cuDNN calls, as the whole-clip codec's do; the
JAX codec has no Pallas kernel.  ``MimiStreamDecoder`` and
``MimiStreamEncoder`` wrap one stream each.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csm_torch.codec.convs import ConvParams, conv_transpose_weight, conv_weight
from csm_torch.codec.mimi import CSM_MIMI_CONFIG, MimiConfig
from csm_torch.codec.rvq import split_rvq_decode, split_rvq_encode
from csm_torch.codec.seanet import DECODER_RATIOS, ENCODER_RATIOS
from csm_torch.codec.transformer import (
    MimiTransformerConfig,
    _apply_rope,
    _layer_norm,
    _rope_tables,
)

# Far enough below any real position that (kpos > qpos - window) is false.
_EMPTY_POS = -(2**30)
# RoPE table length; positions rebase before reaching it, so a stream runs
# forever on a fixed table.
_MAX_STREAM_POS = 8192
_REBASE_AT = _MAX_STREAM_POS // 2


def _device(params: dict) -> torch.device:
    return params["quantizer"].semantic.embed_sum.device


# ---------------------------------------------------------------- convs


def conv_stream_init(batch: int, p: ConvParams, dilation: int = 1, stride: int = 1,
                     dtype=torch.float32) -> torch.Tensor:
    """Zero input history of a causal conv: (B, k_eff - stride, C_in).
    Chunk lengths must be multiples of ``stride``."""
    k, c_in = p.w.shape[0], p.w.shape[1]
    k_eff = (k - 1) * dilation + 1
    return torch.zeros((batch, k_eff - stride, c_in), dtype=dtype, device=p.w.device)


def conv_stream(x: torch.Tensor, p: ConvParams, state: torch.Tensor, dilation: int = 1,
                stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal conv. x: (B, Tc, C_in) → (B, Tc/stride, C_out), and
    the new history."""
    hist = state.shape[1]
    xin = torch.cat([state.to(x.dtype), x], dim=1)
    out = F.conv1d(xin.transpose(1, 2), conv_weight(p, x.dtype), stride=stride,
                   dilation=dilation).transpose(1, 2)
    if p.b is not None:
        out = out + p.b.to(out.dtype)
    return out, (xin[:, xin.shape[1] - hist:] if hist else state)


def convt_stream_init(batch: int, p: ConvParams, stride: int, dtype=torch.float32) -> torch.Tensor:
    """Zero output tail of a causal transposed conv: (B, k - s, C_out)."""
    k, _, c_out = p.w.shape
    return torch.zeros((batch, k - stride, c_out), dtype=dtype, device=p.w.device)


def convt_stream(x: torch.Tensor, p: ConvParams, stride: int, state: torch.Tensor,
                 groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal transposed conv. x: (B, Tc, C_in) → (B, Tc·s, C_out).

    The bias-free transposed conv of the chunk is Tc·s + (k − s) long: the
    first Tc·s samples are emitted with the previous tail added, the last
    k − s are the new tail; the bias is added on emit only."""
    k = p.w.shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2), conv_transpose_weight(p, x.dtype, groups),
                           stride=stride, groups=groups).transpose(1, 2)
    t_out = x.shape[1] * stride
    emit = y[:, :t_out]
    carry = k - stride
    if carry:
        emit = torch.cat([emit[:, :carry] + state.to(emit.dtype), emit[:, carry:]], dim=1)
        state = y[:, t_out:]
    if p.b is not None:
        emit = emit + p.b.to(emit.dtype)
    return emit, state


# ---------------------------------------------------------------- transformer


def transformer_stream_init(params: dict, cfg: MimiTransformerConfig, batch: int) -> dict:
    L, W, H, D = cfg.num_layers, cfg.sliding_window, cfg.num_heads, cfg.head_dim
    dev = params["layers"]["wq"].device
    return {
        "k": torch.zeros((L, batch, W, H, D), dtype=torch.float32, device=dev),
        "v": torch.zeros((L, batch, W, H, D), dtype=torch.float32, device=dev),
        "pos": torch.full((W,), _EMPTY_POS, dtype=torch.int32, device=dev),
        "next": 0,  # the next position, on the host
    }


def _maybe_rebase(state: dict, cfg: MimiTransformerConfig) -> dict:
    """Shift every position down by ``next - window`` once ``next`` reaches
    ``_REBASE_AT``, counter-rotating cached K by the same amount (V carries
    no rotation).  A cached slot is rotated at most once in its
    ``window``-frame life (the threshold is far above the window)."""
    if state["next"] < _REBASE_AT:
        return state
    W, D = cfg.sliding_window, cfg.head_dim
    delta = state["next"] - W
    k = state["k"]
    dev = k.device
    theta = torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev)
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=dev) / float(D))
    ang = -float(delta) * inv  # (D/2,), float32 as the JAX package
    L, B, W_, H, _ = k.shape
    cos = torch.cos(ang)[None].expand(W_, D // 2)
    sin = torch.sin(ang)[None].expand(W_, D // 2)
    k = _apply_rope(k.reshape(L * B, W_, H, D), cos, sin).reshape(L, B, W_, H, D)
    pos = state["pos"]
    return {"k": k, "v": state["v"],
            "pos": torch.where(pos > _EMPTY_POS // 2, pos - delta, pos), "next": W}


def transformer_stream(params: dict, cfg: MimiTransformerConfig, state: dict,
                       h: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """A chunk through the transformer with the carried window K/V.
    h: (B, Sc, E) → (B, Sc, E).  The query at absolute position i attends
    keys j with i - window < j <= i, as ``mimi_transformer_apply``'s mask:
    cached slots carry their positions (empty ones sit at -2^30)."""
    B, S, E = h.shape
    H, D, W = cfg.num_heads, cfg.head_dim, cfg.sliding_window
    state = _maybe_rebase(state, cfg)
    dev = h.device
    cos_np, sin_np = _rope_tables(D, cfg.rope_theta, _MAX_STREAM_POS)
    nxt = state["next"]
    cos = torch.from_numpy(cos_np[nxt : nxt + S]).to(dev)
    sin = torch.from_numpy(sin_np[nxt : nxt + S]).to(dev)
    positions = torch.arange(nxt, nxt + S, dtype=torch.int32, device=dev)
    key_pos = torch.cat([state["pos"], positions])  # (W + S,)
    qpos = positions[:, None]
    mask = (key_pos[None, :] <= qpos) & (key_pos[None, :] > qpos - W)  # (S, W + S)
    scale = 1.0 / float(np.sqrt(np.float32(D)))

    layers = params["layers"]
    new_k, new_v = [], []
    for layer in range(cfg.num_layers):
        lp = {name: t[layer] for name, t in layers.items()}
        x = _layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
        q = _apply_rope((x @ lp["wq"]).reshape(B, S, H, D), cos, sin)
        k = _apply_rope((x @ lp["wk"]).reshape(B, S, H, D), cos, sin)
        v = (x @ lp["wv"]).reshape(B, S, H, D)
        k_all = torch.cat([state["k"][layer], k.float()], dim=1)  # (B, W + S, H, D)
        v_all = torch.cat([state["v"][layer], v.float()], dim=1)
        scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, k_all)
        scores = scores.masked_fill(~mask, -1e30)
        attn = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v_all)
        h = h + lp["attn_scale"] * (attn.reshape(B, S, E).to(h.dtype) @ lp["wo"])
        x = _layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
        h = h + lp["mlp_scale"] * (F.gelu(x @ lp["fc1"]) @ lp["fc2"])
        new_k.append(k_all[:, -W:])
        new_v.append(v_all[:, -W:])
    return h, {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": key_pos[-W:],
               "next": nxt + S}


# ---------------------------------------------------------------- decode


def mimi_decode_stream_init(params: dict, batch: int = 1, cfg: MimiConfig = CSM_MIMI_CONFIG) -> dict:
    """A fresh streaming-decoder state for ``batch`` streams."""
    dec = params["decoder"]
    return {
        "upsample": convt_stream_init(batch, params["upsample"], 2),
        "transformer": transformer_stream_init(params["decoder_transformer"], cfg.transformer,
                                               batch),
        "seanet": {
            "init": conv_stream_init(batch, dec["init"]),
            "blocks": [{"up": convt_stream_init(batch, blk["up"], stride),
                        "res1": conv_stream_init(batch, blk["res_conv1"]),
                        "res2": conv_stream_init(batch, blk["res_conv2"])}
                       for blk, stride in zip(dec["blocks"], DECODER_RATIOS)],
            "final": conv_stream_init(batch, dec["final"]),
        },
    }


def mimi_decode_stream_step(params: dict, state: dict, codes: torch.Tensor,
                            cfg: MimiConfig = CSM_MIMI_CONFIG) -> Tuple[torch.Tensor, dict]:
    """Decode a chunk of codes (B, K, Tc), carrying the codec state.
    Returns (audio (B, Tc·1920), new state): the samples the whole-clip
    decode gives at these frames."""
    latents = split_rvq_decode(params["quantizer"], codes)  # (B, Tc, 512)
    latents, s_up = convt_stream(latents, params["upsample"], 2, state["upsample"],
                                 groups=cfg.hidden_size)  # (B, 2·Tc, 512)
    latents, s_tr = transformer_stream(params["decoder_transformer"], cfg.transformer,
                                       state["transformer"], latents)
    sn, dec = state["seanet"], params["decoder"]
    x, s_init = conv_stream(latents, dec["init"], sn["init"])
    blocks = []
    for blk, bs, stride in zip(dec["blocks"], sn["blocks"], DECODER_RATIOS):
        x, s_blk_up = convt_stream(F.elu(x), blk["up"], stride, bs["up"])
        y, s_r1 = conv_stream(F.elu(x), blk["res_conv1"], bs["res1"])
        y, s_r2 = conv_stream(F.elu(y), blk["res_conv2"], bs["res2"])
        x = x + y
        blocks.append({"up": s_blk_up, "res1": s_r1, "res2": s_r2})
    x, s_final = conv_stream(F.elu(x), dec["final"], sn["final"])
    return x[..., 0], {"upsample": s_up, "transformer": s_tr,
                       "seanet": {"init": s_init, "blocks": blocks, "final": s_final}}


# ---------------------------------------------------------------- encode


def mimi_encode_stream_init(params: dict, batch: int = 1, cfg: MimiConfig = CSM_MIMI_CONFIG) -> dict:
    """A fresh streaming-encoder state (live audio in): every encoder stage
    is causal, strided convs included."""
    enc = params["encoder"]
    return {
        "seanet": {
            "init": conv_stream_init(batch, enc["init"]),
            "blocks": [{"res1": conv_stream_init(batch, blk["res_conv1"]),
                        "res2": conv_stream_init(batch, blk["res_conv2"]),
                        "down": conv_stream_init(batch, blk["down"], stride=stride)}
                       for blk, stride in zip(enc["blocks"], ENCODER_RATIOS)],
            "final": conv_stream_init(batch, enc["final"]),
        },
        "transformer": transformer_stream_init(params["encoder_transformer"], cfg.transformer,
                                               batch),
        "downsample": conv_stream_init(batch, params["downsample"], stride=2),
    }


def mimi_encode_stream_step(params: dict, state: dict, audio: torch.Tensor,
                            cfg: MimiConfig = CSM_MIMI_CONFIG,
                            num_quantizers: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Encode an audio chunk (B, Tc) at 24 kHz, Tc a multiple of
    ``cfg.samples_per_frame`` (1920) so that every strided stage sees whole
    strides.  Returns (codes (B, K, Tc/1920), new state): the codes the
    whole-clip encode gives at these frames."""
    if audio.shape[-1] % cfg.samples_per_frame:
        raise ValueError(f"stream chunk length {audio.shape[-1]} must be a multiple of "
                         f"{cfg.samples_per_frame}")
    enc, sn = params["encoder"], state["seanet"]
    x, s_init = conv_stream(audio[..., None], enc["init"], sn["init"])
    blocks = []
    for blk, bs, stride in zip(enc["blocks"], sn["blocks"], ENCODER_RATIOS):
        y, s_r1 = conv_stream(F.elu(x), blk["res_conv1"], bs["res1"])
        y, s_r2 = conv_stream(F.elu(y), blk["res_conv2"], bs["res2"])
        x, s_down = conv_stream(F.elu(x + y), blk["down"], bs["down"], stride=stride)
        blocks.append({"res1": s_r1, "res2": s_r2, "down": s_down})
    x, s_final = conv_stream(F.elu(x), enc["final"], sn["final"])  # (B, 2·Tf, 512)
    x, s_tr = transformer_stream(params["encoder_transformer"], cfg.transformer,
                                 state["transformer"], x)
    x, s_ds = conv_stream(x, params["downsample"], state["downsample"], stride=2)
    codes = split_rvq_encode(params["quantizer"], x, num_quantizers)
    return codes, {"seanet": {"init": s_init, "blocks": blocks, "final": s_final},
                   "transformer": s_tr, "downsample": s_ds}


# ---------------------------------------------------------------- wrappers


class MimiStreamEncoder:
    """One stream of live audio in: feed (Tc,) chunks, get codes."""

    def __init__(self, params: dict, cfg: MimiConfig = CSM_MIMI_CONFIG, batch: int = 1,
                 num_quantizers: Optional[int] = None):
        self.params, self.cfg, self.batch = params, cfg, batch
        self.num_quantizers = num_quantizers
        self.device = _device(params)
        self.reset()

    def reset(self) -> None:
        self.state = mimi_encode_stream_init(self.params, self.batch, self.cfg)

    @torch.inference_mode()
    def encode_chunk(self, audio: np.ndarray) -> np.ndarray:
        """(Tc,) float samples → (K, Tc/1920) int32 codes (one stream)."""
        a = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        codes, self.state = mimi_encode_stream_step(self.params, self.state, a, self.cfg,
                                                    self.num_quantizers)
        return codes[0].cpu().numpy().astype(np.int32)


class MimiStreamDecoder:
    """One stream of codes in: feed (K, Tc) chunks, get audio.  A stream
    that pads its last chunk to a fixed length decodes chunks of one
    shape."""

    def __init__(self, params: dict, cfg: MimiConfig = CSM_MIMI_CONFIG, batch: int = 1):
        self.params, self.cfg, self.batch = params, cfg, batch
        self.device = _device(params)
        self.reset()

    def reset(self) -> None:
        self.state = mimi_decode_stream_init(self.params, self.batch, self.cfg)

    def decode_chunk(self, codes) -> np.ndarray:
        """(K, Tc) int codes → (Tc·1920,) float32 samples (one stream)."""
        return self.decode_chunk_async(codes).float().cpu().numpy()

    @torch.inference_mode()
    def decode_chunk_async(self, codes) -> torch.Tensor:
        """``decode_chunk``'s samples as the device tensor, without waiting
        for the card: the work is queued on the current stream, and the
        caller reads the tensor when it needs the samples (a synchronize,
        or a copy to the host).  Codes clamp to the codebook (the CSM
        audio vocab has 3 more ids)."""
        c = torch.as_tensor(np.asarray(codes), device=self.device).long()[None]
        c = c.clamp(max=self.cfg.codebook_size - 1)
        audio, self.state = mimi_decode_stream_step(self.params, self.state, c, self.cfg)
        return audio[0]
