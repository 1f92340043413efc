"""End-to-end text-to-speech: prompt assembly in the (T, 33) frame format,
autoregressive frame generation, Mimi decode to a 24 kHz waveform.

The counterpart of the JAX package's ``generator.py``: random weights or a
checkpoint (a torchtune ``ckpt.pt`` or ``.safetensors``, a training
checkpoint directory, a Mimi file), the quantized modes and the 8B flavor.
``lora_path`` merges a LoRA adapter into the weights at load.  Device
meshes wait for a later slice and raise ``NotImplementedError`` naming
their ROADMAP.md item (A.11b).  A ``watermarker`` callable is applied to each
waveform when one is given; ``load_csm`` gives none by default, and
``csm-torch-generate`` gives one unless told not to.  ``generate_streaming``
yields audio chunk by chunk through a one-slot ``BatchedServer`` and the
streaming codec (codec/streaming.py), without the watermark.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from csm_torch.codec.convert import load_mimi_checkpoint
from csm_torch.codec.mimi import CSM_MIMI_CONFIG, mimi_init
from csm_torch.data import frames as fr
from csm_torch.data.tokenizers import MimiAudioTokenizer, load_text_tokenizer
from csm_torch.models.config import ModelArgs, csm_1b_args, csm_param_count
from csm_torch.models.csm import fuse_csm_params
from csm_torch.models.generation import (
    PROMPT_BUCKETS,
    GraphCache,
    bucket_length,
    generate_audio_tokens_jit,
)
from csm_torch.models.llama import fuse_weights
from csm_torch.utils import quantize as qz
from csm_torch.utils.checkpoint_compat import load_torch_checkpoint
from csm_torch.utils.device import resolve_device
from csm_torch.utils.params import cast_params, random_csm_params, tree_map

SAMPLE_RATE = 24_000
FRAME_RATE = 12.5
MS_PER_FRAME = 80.0

# bf16 trees above this size are made quantized, a few layers at a time, and
# never exist in float on the device (the 8B flavor)
_STREAMING_LOAD_BYTES = 8 << 30


def _waits(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


@dataclasses.dataclass
class Segment:
    """One conversational turn."""

    speaker: int
    text: str
    audio: np.ndarray  # float32 mono at 24 kHz


@dataclasses.dataclass
class PackedContext:
    """A conversation context Mimi-encoded and frame-packed once, accepted
    wherever a list of context segments is."""

    tokens: np.ndarray  # (T, K+1) int32
    mask: np.ndarray  # (T, K+1) bool


class Generator:
    """Contextual speech generator.

    Args:
        params: CSM parameter tree (models/csm layout) on ``device``.
        mimi: MimiAudioTokenizer (encode for context audio, decode for
            output); tests may pass a fake with the same two methods.
        text_tokenizer: ``.encode(str) -> list[int]``; defaults to
            ``load_text_tokenizer()``.
        watermarker: optional ``(audio, sr) -> (audio, sr)``.
        device: where generation runs; ``"cuda"`` unless the caller asks
            for the CPU.
        kv_dtype: backbone KV-cache dtype; ``torch.int8`` quantizes K/V as
            they are written (ops/kvcache.py), None keeps ``compute_dtype``.
    """

    def __init__(
        self,
        params: dict,
        args: Optional[ModelArgs] = None,
        mimi=None,
        text_tokenizer=None,
        watermarker=None,
        compute_dtype=torch.bfloat16,
        device="cuda",
        mesh=None,
        kv_dtype=None,
    ):
        if mesh is not None:
            raise _waits("sharded inference over a device mesh", "A.11b")
        # generation runs through generate_audio_tokens_jit: on a card the
        # prefill frame and the frame step as CUDA-graph replays, captured
        # once per key and kept here
        self.graphs = GraphCache()
        # generate_streaming's one-slot servers, by (chunk_frames, topk, window)
        self._stream_servers: dict = {}
        self.kv_dtype = kv_dtype
        self.device = resolve_device(device)
        self.params = fuse_csm_params(params)
        self.args = args or csm_1b_args()
        self.mimi = mimi
        self.text_tokenizer = text_tokenizer or load_text_tokenizer()
        self.watermarker = watermarker
        self.compute_dtype = compute_dtype
        self.sample_rate = SAMPLE_RATE
        self.max_seq_len = self.args.backbone.max_seq_len
        self.last_stats: dict = {}

    def close(self) -> None:
        """Free the captured graphs, their pools and static buffers, the
        streaming servers, and the weights: the card's memory for the next
        model."""
        self.graphs.clear()
        for server in self._stream_servers.values():
            server.close()
        self._stream_servers.clear()
        self.params = None

    # ---- prompt assembly ----

    def _segment_frames(self, seg: Segment):
        ids = self.text_tokenizer.encode(f"[{seg.speaker}]{seg.text}")
        if self.mimi is None:
            raise ValueError("context audio requires a Mimi tokenizer")
        codes = self.mimi.encode(np.asarray(seg.audio, np.float32))
        return fr.segment_frames(self.args, ids, codes)

    def precompute_context(self, segments: List[Segment]) -> PackedContext:
        """Encode and pack a context once, for reuse across calls."""
        return PackedContext(*fr.concat_frames([self._segment_frames(s) for s in segments]))

    def _build_prompt(self, text: str, speaker: int, context):
        if isinstance(context, PackedContext):
            parts = [(context.tokens, context.mask)]
        else:
            parts = [self._segment_frames(s) for s in context]
        parts.append(fr.text_frames(self.args, self.text_tokenizer.encode(f"[{speaker}]{text}")))
        return fr.concat_frames(parts)

    # ---- generation ----

    def generate(
        self,
        text: str,
        speaker: int = 0,
        context: Optional[List[Segment]] = None,
        max_audio_length_ms: float = 90_000,
        temperature: float = 0.9,
        topk: int = 50,
        seed: int = 0,
    ) -> np.ndarray:
        """One 24 kHz waveform for ``text``."""
        return self.generate_batch(
            [text], [speaker], [context or []], max_audio_length_ms=max_audio_length_ms,
            temperature=temperature, topk=topk, seed=seed,
        )[0]

    def _streaming_server(self, chunk_frames: int, topk: int, window: Optional[int]):
        """The one-slot server of ``generate_streaming``, made on first use
        per (chunk_frames, topk, window) and kept: its graphs are captured
        once.  Its KV cache takes the Generator's dtype."""
        key = (chunk_frames, topk, window)
        if key not in self._stream_servers:
            from csm_torch.serving import BatchedServer  # serving imports this module

            self._stream_servers[key] = BatchedServer(
                self.params, self.args, n_slots=1, max_seq_len=self.max_seq_len, topk=topk,
                compute_dtype=self.compute_dtype, chunk_size=chunk_frames,
                kv_dtype="int8" if self.kv_dtype == torch.int8 else "bf16", window=window,
                device=self.device)
        return self._stream_servers[key]

    @torch.inference_mode()
    def generate_streaming(
        self,
        text: str,
        speaker: int = 0,
        context: Optional[List[Segment]] = None,
        max_audio_length_ms: float = 90_000,
        temperature: float = 0.9,
        topk: int = 50,
        seed: int = 0,
        chunk_frames: int = 13,
        window: Optional[int] = None,
    ) -> Iterator[Tuple[np.ndarray, bool]]:
        """Yield (float32 audio at 24 kHz, done) about every ``chunk_frames``
        frames (80 ms each) of audio; exactly one item has done=True, the
        last, possibly empty.

        The frames come from a one-slot ``BatchedServer`` (its CUDA graphs
        on a card) in chunks of ``chunk_frames``; each chunk's new frames go
        through the streaming codec, which carries its state, so a chunk
        costs the same however long the stream runs.  The last chunk's
        frames are padded to ``chunk_frames`` (one codec shape) and its
        samples cut back.  First audio ≈ the prefill + ``chunk_frames``
        frames + one codec step.  ``window``: a sliding-window cache of that
        many columns, for streams of any length (the prompt-length contract
        is waived).  The watermark is not applied (it works on whole
        utterances): watermark the concatenation."""
        from csm_torch.serving import StreamRequest

        tokens, mask = self._build_prompt(text, speaker, context or [])
        max_frames = int(max_audio_length_ms / MS_PER_FRAME)
        if window is None:
            limit = self.max_seq_len - max_frames
            if tokens.shape[0] >= limit:
                raise ValueError(f"prompt too long: {tokens.shape[0]} >= {limit} "
                                 f"({self.max_seq_len} - {max_frames} audio frames)")
        if self.mimi is None:
            raise ValueError("streaming decode requires a Mimi tokenizer")
        server = self._streaming_server(chunk_frames, topk, window)
        server.reset(seed)
        server.temperature = temperature
        server.submit(StreamRequest(tokens, mask, max_frames=max_frames))
        decoder = self.mimi.stream_decoder()
        spf = decoder.cfg.samples_per_frame

        def decode(new: np.ndarray, pad_to: Optional[int] = None) -> np.ndarray:
            n = new.shape[0]
            if pad_to is not None and n < pad_to:  # the last chunk only: its state is dropped
                new = np.concatenate([new, np.zeros((pad_to - n, new.shape[1]), new.dtype)])
            return decoder.decode_chunk(new.T)[: n * spf]

        decoded = 0  # frames through the codec
        result = None
        done_yielded = False
        while result is None:
            finished = server.step()
            if finished:
                result = finished[0]
            done = result is not None
            new = result.frames[decoded:] if done else server.slot_frames[0][decoded:]
            if len(new) == 0:
                continue  # EOS can land on a step that adds no frame
            decoded += len(new)
            done_yielded = done
            yield decode(np.stack(new), pad_to=chunk_frames if done else None), done
        if not done_yielded:
            yield np.zeros(0, np.float32), True

    @torch.inference_mode()
    def generate_batch(
        self,
        texts: List[str],
        speakers: List[int],
        contexts: Optional[List[list]] = None,
        max_audio_length_ms: float = 90_000,
        temperature: float = 0.9,
        topk: int = 50,
        seed: int = 0,
    ) -> List[np.ndarray]:
        """N utterances through one batched frame loop."""
        t_start = time.perf_counter()
        contexts = contexts or [[] for _ in texts]
        max_frames = int(max_audio_length_ms / MS_PER_FRAME)
        K = self.args.audio_num_codebooks

        prompts = [self._build_prompt(t, s, c) for t, s, c in zip(texts, speakers, contexts)]
        lens = np.array([p[0].shape[0] for p in prompts], np.int32)
        limit = self.max_seq_len - max_frames
        if int(lens.max()) >= limit:
            # the prompt must leave room for the whole audio budget
            raise ValueError(
                f"prompt too long: {int(lens.max())} >= {limit} "
                f"({self.max_seq_len} - {max_frames} audio frames)"
            )
        S_pad = bucket_length(
            int(lens.max()), tuple(b for b in PROMPT_BUCKETS if b <= self.max_seq_len)
        )
        B = len(prompts)
        tokens = np.zeros((B, S_pad, K + 1), np.int32)
        mask = np.zeros((B, S_pad, K + 1), bool)
        for b, (tk, mk) in enumerate(prompts):
            tokens[b, : tk.shape[0]] = tk
            mask[b, : mk.shape[0]] = mk

        gen = torch.Generator(device=self.device).manual_seed(seed)
        t_tok = time.perf_counter()
        res = generate_audio_tokens_jit(
            self.params, self.args, tokens, mask, lens, max_frames=max_frames,
            temperature=temperature, topk=topk, compute_dtype=self.compute_dtype,
            generator=gen, device=self.device, kv_dtype=self.kv_dtype, graphs=self.graphs,
        )
        frames = res.frames.cpu().numpy()  # (B, max_frames, K)
        nf = res.num_frames.cpu().numpy()
        t_gen = time.perf_counter()

        outs: List[np.ndarray] = []
        watermark_s = 0.0
        for b in range(B):
            n = int(nf[b])
            if n == 0:
                outs.append(np.zeros(0, np.float32))
                continue
            if self.mimi is None:
                raise ValueError("decoding audio requires a Mimi tokenizer")
            audio = np.asarray(self.mimi.decode(frames[b, :n].T))
            audio = audio[: int(n / FRAME_RATE * self.sample_rate)]
            if not np.all(np.isfinite(audio)):
                bad = int(np.sum(~np.isfinite(audio)))
                print(f"WARNING: repaired {bad} non-finite audio samples")
                audio = np.nan_to_num(audio, nan=0.0, posinf=0.0, neginf=0.0)
            if self.watermarker is not None:
                t_wm = time.perf_counter()
                audio, _ = self.watermarker(audio, self.sample_rate)
                watermark_s += time.perf_counter() - t_wm
            outs.append(np.asarray(audio, np.float32))

        wall = time.perf_counter() - t_start
        total_audio = sum(len(o) for o in outs) / self.sample_rate
        self.last_stats = {
            "wall_s": wall,
            "tokenize_s": t_tok - t_start,
            "prefill_s": res.prefill_s,
            "capture_s": res.capture_s,
            "generate_s": t_gen - t_tok,
            "decode_s": time.perf_counter() - t_gen,  # Mimi and the watermark
            "watermark_s": watermark_s,
            "audio_s": total_audio,
            "prompt_bucket": S_pad,
            "steps": res.steps,
            "frames": int(nf.sum()),
            "frames_per_s": float(nf.sum()) / max(t_gen - t_tok, 1e-9),
            "rtf": total_audio / max(wall, 1e-9),
        }
        return outs


def load_csm(
    ckpt_path: Optional[str] = None,
    mimi_path: Optional[str] = None,
    watermarker=None,
    compute_dtype=torch.bfloat16,
    quantize="none",
    kv_int8: bool = False,
    args: Optional[ModelArgs] = None,
    lora_path: Optional[str] = None,
    device="cuda",
    text_tokenizer=None,
    seed: int = 0,
) -> Generator:
    """A CSM Generator (CSM-1B unless ``args`` says otherwise, e.g.
    ``csm_8b_args()`` or ``tiny_file_args()``).

    ``ckpt_path`` — a reference ``ckpt.pt`` or a ``.safetensors`` file
    under torchtune names (read with ``args``), or a ``csm-torch-train``
    checkpoint directory (its own args); None draws random weights from
    ``seed``.  ``mimi_path`` — a Mimi ``.safetensors`` (HF layout) or
    ``.pt``/``.bin`` file; None draws a random codec from ``seed + 1``.

    ``quantize`` — weight-only quantization of the transformer stacks, after
    the cast to ``compute_dtype`` (so scales are bf16): False/None/"none",
    True/"int8" (per out-channel), "int8-decoder" (the acoustic decoder
    only: the backbone and codebook-0 head stay float), or "int4" (grouped
    4-bit through the fused-dequant kernel, ops/int4_matmul.py).
    ``kv_int8`` — int8 backbone KV cache, quantized as it is written.

    ``lora_path`` — an adapter directory (training/lora.save_lora) trained
    for ``args``, merged into the weights after the cast to
    ``compute_dtype`` and before ``quantize``.

    Models whose bf16 tree exceeds 8 GiB (the 8B flavor) are made or loaded
    quantized a few layers at a time and need quantize="int8" or "int4";
    they cannot merge an adapter (serve it unmerged: ``BatchedServer``'s
    ``adapters``)."""
    args = args or csm_1b_args()
    qmode = {False: "none", True: "int8", None: "none"}.get(quantize, quantize)
    if qmode not in ("none", "int8", "int8-decoder", "int4"):
        raise ValueError(f"quantize must be none|int8|int8-decoder|int4, got {quantize!r}")
    if 2 * csm_param_count(args) > _STREAMING_LOAD_BYTES:
        return _load_csm_streaming(
            watermarker, compute_dtype, qmode, kv_int8, args, lora_path, device,
            text_tokenizer, seed, ckpt_path=ckpt_path, mimi_path=mimi_path,
        )
    device = resolve_device(device)
    if ckpt_path is None:
        params = cast_params(random_csm_params(args, seed, device=device), compute_dtype)
    elif ckpt_path.endswith((".pt", ".safetensors")):
        params = tree_map(lambda t: t.to(device, compute_dtype),
                          load_torch_checkpoint(ckpt_path, args))
    else:
        # a local import: the training package imports this module
        from csm_torch.training.checkpoint import load_params

        params, args = load_params(ckpt_path, device)
        params = cast_params(params, compute_dtype)
    if lora_path is not None:
        from csm_torch.training.lora import load_lora, merge_lora

        lora, lcfg, largs = load_lora(lora_path, device)
        if largs != args:
            raise ValueError(f"adapter at {lora_path} was trained for a different model shape "
                             f"(adapter args != loaded args)")
        params = cast_params(merge_lora(params, lora, lcfg), compute_dtype)
    if qmode == "int8":
        params = qz.quantize_csm_params(params)
    elif qmode == "int8-decoder":
        # the backbone and codebook-0 head stay float: for the same token
        # history the c0 logits equal the unquantized model's
        params = qz.quantize_csm_params(params, components=("decoder",))
    elif qmode == "int4":
        params = qz.quantize_csm_params_int4(params)
    return _generator(params, args, watermarker, compute_dtype, kv_int8, device,
                      text_tokenizer, seed, mimi_path)


def _generator(params, args, watermarker, compute_dtype, kv_int8, device, text_tokenizer, seed,
               mimi_path=None):
    if mimi_path is None:
        mimi_gen = torch.Generator(device=device).manual_seed(seed + 1)
        mimi_params = mimi_init(mimi_gen, CSM_MIMI_CONFIG, device=device)
    else:
        mimi_params = tree_map(lambda t: t.to(device), load_mimi_checkpoint(mimi_path))
    return Generator(
        params, args, mimi=MimiAudioTokenizer(mimi_params), text_tokenizer=text_tokenizer,
        watermarker=watermarker, compute_dtype=compute_dtype, device=device,
        kv_dtype=torch.int8 if kv_int8 else None,
    )


def _load_csm_streaming(
    watermarker, compute_dtype, qmode, kv_int8, args, lora_path, device, text_tokenizer, seed,
    ckpt_path=None, mimi_path=None,
) -> Generator:
    """Weights made, or read from a torchtune file into host memory, and
    quantized a few layers at a time on the device, so only the quantized
    tree ever exists there (the 8B flavor's bf16 tree is over 16 GB)."""
    if qmode not in ("int8", "int4"):
        raise ValueError(
            f"this model's bf16 tree is over {_STREAMING_LOAD_BYTES >> 30} GiB: pass "
            f"quantize='int8' or 'int4', got {qmode!r}"
        )
    if lora_path is not None:
        raise ValueError(
            "lora_path merges adapters into a float base, which this "
            "flavor cannot materialize"
        )
    device = resolve_device(device)
    if ckpt_path is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = qz.init_csm_params_quantized(gen, args, qmode, device=device)
    elif ckpt_path.endswith((".pt", ".safetensors")):
        host = load_torch_checkpoint(ckpt_path, args)
        params = qz.quantize_csm_params_streaming(host, mode=qmode, device=device)
        del host
    else:
        raise ValueError(
            "a training checkpoint directory loads whole in float, which this "
            "flavor cannot hold on the device: export it to .safetensors "
            "(csm_torch.utils.safetensors_io) or pass a torchtune .pt"
        )
    return _generator(_fuse_owned(params), args, watermarker, compute_dtype, kv_int8, device,
                      text_tokenizer, seed, mimi_path)


def _fuse_owned(params: dict) -> dict:
    """qkv / gate-up fusion that frees each source projection as soon as its
    fused leaf exists, so the transient is one fused leaf, not a second
    tree.  The caller hands over its only reference; ``fuse_csm_params``
    later sees ``wqkv`` and leaves the tree as it is."""
    for comp in ("backbone", "decoder"):
        tp = params[comp]
        if "wqkv" in tp:
            continue
        for names, fused_name in ((("wq", "wk", "wv"), "wqkv"), (("w1", "w3"), "w13")):
            ws = [tp.pop(n) for n in names]
            tp[fused_name] = fuse_weights(ws)
            del ws  # the last reference: the separate projections are freed
    return params


load_csm_1b = load_csm
