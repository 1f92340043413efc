"""Autoregressive audio-token generation: bucketed prefill, then one frame
step per 80 ms frame until every row has emitted the all-zero EOS frame or
``max_frames`` is reached.

Same contract as the JAX package's ``models/generation.py``: prompts are
right-padded to a bucket with PAD_POS positions, EOS is tracked per row,
frames after a row's EOS are zero-filled, and frame i-1 is consumed at
position ``prompt_len + i - 1``.  Two entries:

  * ``generate_audio_tokens_jit``, the counterpart of the JAX package's one
    compiled program per (bucket, max_frames, topk): the prefill frame and
    the S=1 frame step are functions of static buffers alone
    (``FrameGraphs``).  On a CUDA device each is captured once into a CUDA
    graph and replayed; the host enqueues ``CHUNK`` step replays, each after
    its uniform draw, then reads ``done`` once, which is the JAX
    ``while_loop``'s condition.  On the CPU the same two functions run
    without capture.
  * ``generate_audio_tokens``, the eager loop with one host read a frame:
    the reference the graphed entry is held against, and a second way to
    run on the card.

Both draw the same uniforms in the same order from ``generator`` (one
(K, B, 1) draw a frame, the eager loop's call), so on one seed they give
the same codes.  Frames that a chunk runs after every row is done write
zeros and leave ``num_frames`` alone, so the results equal the eager
loop's.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple, Optional

import torch

from csm_torch.models import csm
from csm_torch.models.config import ModelArgs
from csm_torch.ops import decode_attention, flash_attention, int4_matmul
from csm_torch.utils.device import resolve_device

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# frame-step replays between two host reads of ``done``: a read costs ~1.5 %
# of frames/s at 1 and ~0.3 % at 4 against 16 on the H100, and a chunk runs
# up to CHUNK - 1 frames after the last EOS (PERF.md §6)
CHUNK = 4
GRAPH_CACHE_SIZE = 8  # keys whose graphs and buffers a GraphCache keeps

# the wrappers' counters that the frame's kernels move: a replay adds the
# counts its capture recorded
_COUNTERS = ((decode_attention, "launches"), (flash_attention, "launches"),
             (int4_matmul, "launches"), (int4_matmul, "dequant_calls"),
             (decode_attention, "int8_launches"))


def bucket_length(n: int, buckets=PROMPT_BUCKETS) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class GenerationResult(NamedTuple):
    frames: torch.Tensor  # (B, max_frames, K) int32; zero-filled after EOS
    num_frames: torch.Tensor  # (B,) int32 valid frame count per row
    steps: int  # frame steps run after the prefill frame
    prefill_s: float  # host time of the prefill frame, device work included
    capture_s: float = 0.0  # warm-up and capture of this call's graphs (0: none)


def _counts() -> list:
    return [getattr(m, name) for m, name in _COUNTERS]


def _add_counts(delta) -> None:
    for (m, name), d in zip(_COUNTERS, delta):
        setattr(m, name, getattr(m, name) + d)


def _prompt_tensors(params, prompt_tokens, prompt_mask, prompt_len, device):
    if params["text_embeddings"].device.type != device.type:
        raise ValueError(f"params are on {params['text_embeddings'].device}, not {device}")
    return (torch.as_tensor(prompt_tokens, device=device),
            torch.as_tensor(prompt_mask, device=device),
            torch.as_tensor(prompt_len, device=device).to(torch.int32))


def capture_graphs(fns, device: torch.device, pool=None) -> list:
    """Run each function once eagerly, then capture each into a CUDA graph;
    the graphs share one memory pool (``pool``, or a new one).  Returns
    [(graph, the launch counts its capture recorded)], for ``replay``.

    The eager pass, on the capture stream, builds the kernels, sets their
    shared-memory and cluster attributes, fills the launch plans and RoPE
    tables and gives cuBLAS its workspace on that stream, so nothing is
    built, set or first allocated under capture: the caller makes that
    pass harmless to its buffers.  Its launches ran and stay counted; the
    capture's ran nothing, so the counters are put back after it, and each
    replay adds the counts it recorded.  A capture that fails raises."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    graphs = []
    # the outer stream context puts the caller's stream back when a
    # capture fails: torch.cuda.graph's exit then raises before it does
    with torch.cuda.stream(torch.cuda.current_stream(device)):
        for fn in fns:
            before = _counts()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    fn()
                delta = [a - b for a, b in zip(_counts(), before)]
            finally:
                _add_counts([b - a for a, b in zip(_counts(), before)])
            graphs.append((graph, delta))
    return graphs


def replay(entry) -> None:
    """Replay one ``capture_graphs`` graph and add its launch counts."""
    graph, delta = entry
    graph.replay()
    _add_counts(delta)


class GraphKey(NamedTuple):
    """What a capture depends on, as the JAX jit's static arguments (the
    weights by identity: a graph holds their addresses)."""

    params_id: int
    args: ModelArgs
    batch: int
    bucket: int
    max_frames: int
    topk: int
    compute_dtype: torch.dtype
    kv_dtype: Optional[torch.dtype]
    device: torch.device


class FrameGraphs:
    """One key's generation on static buffers.

    ``prefill`` and ``step`` read and write only the buffers allocated here,
    so each can be captured once and replayed: the prompt, its lengths, the
    temperature and the uniforms are copied in before a replay, the cache
    column, the position and the frame index come from the device counter
    ``i`` that ``step`` advances itself, and ``done``, ``num_frames`` and the
    frame buffer are updated on the device.  The backbone cache is never
    cleared: every read is masked by ``kv_pos``, which ``prefill`` resets."""

    def __init__(self, params: dict, args: ModelArgs, key: GraphKey):
        B, S_pad, F = key.batch, key.bucket, key.max_frames
        K = args.audio_num_codebooks
        dev = key.device
        self.params, self.args, self.key = params, args, key
        self.tokens = torch.zeros((B, S_pad, K + 1), dtype=torch.int32, device=dev)
        self.mask = torch.zeros((B, S_pad, K + 1), dtype=torch.bool, device=dev)
        self.prompt_len = torch.ones((B,), dtype=torch.int32, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.uniforms = torch.zeros((K, B, 1), dtype=torch.float32, device=dev)
        self.state = csm.init_frame_state(args, B, key.compute_dtype, S_pad + F, dev, key.kv_dtype)
        self.dec_bufs = csm.init_decoder_buffers(args, B, key.compute_dtype, dev)
        self.col = torch.arange(S_pad, dtype=torch.int32, device=dev)
        # frame i-1 is consumed as one token: audio columns live, text dead
        self.step_tokens = torch.zeros((B, 1, K + 1), dtype=torch.int32, device=dev)
        self.step_mask = torch.zeros((B, 1, K + 1), dtype=torch.bool, device=dev)
        self.step_mask[:, :, :K] = True
        self.frame = torch.zeros((B, K), dtype=torch.int32, device=dev)
        self.frames = torch.zeros((B, F, K), dtype=torch.int32, device=dev)
        self.done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.num_frames = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.i = torch.ones((1,), dtype=torch.int64, device=dev)  # buffer index of the next frame
        # [(prefill graph, its launch counts), (step graph, ...)]; no step at max_frames 1
        self.graphs = None

    def load(self, tokens, mask, prompt_len, temperature) -> None:
        self.tokens.copy_(tokens)
        self.mask.copy_(mask)
        self.prompt_len.copy_(prompt_len)
        self.temperature.fill_(temperature)

    def draw(self, generator: Optional[torch.Generator]) -> None:
        """One frame's uniforms, drawn outside any graph by the eager loop's
        own call, so both take the same stream from ``generator``."""
        torch.rand(tuple(self.uniforms.shape), generator=generator, out=self.uniforms)

    def _frame(self, tokens, mask, input_pos, state, last_idx=None) -> torch.Tensor:
        k = self.key
        frame, _ = csm.generate_frame(
            self.params, self.args, None, tokens, mask, input_pos, state, self.temperature,
            k.topk, k.compute_dtype, last_idx=last_idx, uniforms=self.uniforms,
            dec_bufs=self.dec_bufs,
        )
        self.frame.copy_(frame)
        return frame

    def prefill(self) -> None:
        """The prefill frame: reset the generation state, run the bucketed
        prompt and sample frame 0."""
        st = self.state
        st.kv_pos.fill_(csm.PAD_POS)
        col = self.col[None, :]
        input_pos = torch.where(col < self.prompt_len[:, None], col, csm.PAD_POS)
        frame = self._frame(self.tokens, self.mask, input_pos, csm.FrameState(st.cache, 0, st.kv_pos),
                            last_idx=self.prompt_len - 1)
        self.done.copy_((frame == 0).all(dim=1))
        self.frames.zero_()
        self.frames[:, 0] = torch.where(self.done[:, None], 0, frame)
        self.num_frames.copy_((~self.done).to(torch.int32))
        self.i.fill_(1)

    def step(self) -> None:
        """One S=1 frame step: frame i-1 in at position prompt_len + i - 1
        (cache column bucket + i - 1), frame i out at buffer index i."""
        K = self.args.audio_num_codebooks
        st = self.state
        self.step_tokens[:, 0, :K] = self.frame
        pos = (self.prompt_len[:, None] + (self.i - 1)).to(torch.int32)
        cols = self.i + (self.key.bucket - 1)
        frame = self._frame(self.step_tokens, self.step_mask, pos,
                            csm.FrameState(st.cache, cols, st.kv_pos))
        self.done |= (frame == 0).all(dim=1)
        self.frames.index_copy_(1, self.i, torch.where(self.done[:, None], 0, frame)[:, None])
        self.num_frames += (~self.done).to(torch.int32)
        self.i += 1

    def capture(self) -> None:
        """Capture the prefill and the step into CUDA graphs that share one
        memory pool (``capture_graphs``).  At ``max_frames`` 1 the step
        never runs (its frame index would be past ``frames``), so only the
        prefill is warmed up and captured."""
        fns = (self.prefill, self.step) if self.key.max_frames > 1 else (self.prefill,)
        self.graphs = capture_graphs(fns, self.key.device)

    def _run(self, which: int, fn) -> None:
        if self.graphs is None:
            fn()
        else:
            replay(self.graphs[which])

    def run_prefill(self) -> None:
        self._run(0, self.prefill)

    def run_step(self) -> None:
        self._run(1, self.step)

    def all_done(self) -> bool:
        """The one host read of a chunk: has every row emitted EOS?"""
        return bool(self.done.all())

    def release(self) -> None:
        """Free the graphs and their pool; the buffers go with this object."""
        for graph, _ in self.graphs or ():
            graph.reset()
        self.graphs = None


class GraphCache:
    """A small LRU of ``FrameGraphs`` by key.  Evicting or clearing a key
    releases its graphs, their pool and its static buffers."""

    def __init__(self, size: int = GRAPH_CACHE_SIZE):
        self.size = size
        self._items: collections.OrderedDict = collections.OrderedDict()

    def get(self, key: GraphKey, build) -> FrameGraphs:
        fg = self._items.pop(key, None)
        if fg is None:
            fg = build()
        self._items[key] = fg
        while len(self._items) > self.size:
            self._items.popitem(last=False)[1].release()
        return fg

    def clear(self) -> None:
        for fg in self._items.values():
            fg.release()
        self._items.clear()

    def __len__(self) -> int:
        return len(self._items)


@torch.inference_mode()
def generate_audio_tokens_jit(
    params: dict,
    args: ModelArgs,
    prompt_tokens,
    prompt_mask,
    prompt_len,
    max_frames: int,
    temperature: float = 0.9,
    topk: int = 50,
    compute_dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    kv_dtype=None,
    graphs: Optional[GraphCache] = None,
) -> GenerationResult:
    """``generate_audio_tokens`` as replays of two CUDA graphs a key
    (batch, bucket, max_frames, topk, compute dtype, KV dtype): the prefill
    frame once, then the frame step in chunks of ``CHUNK`` with one host
    read of ``done`` after each chunk (and one after the prefill, which
    ends ``prefill_s``).  ``graphs`` keeps the captures for later calls;
    without it they are made for this call and dropped.  On the CPU the
    same functions run without capture.  The arguments are
    ``generate_audio_tokens``'s."""
    device = resolve_device(device)
    tokens, mask, lens = _prompt_tensors(params, prompt_tokens, prompt_mask, prompt_len, device)
    B, S_pad, _ = tokens.shape
    key = GraphKey(id(params), args, B, S_pad, max_frames, topk, compute_dtype, kv_dtype, device)
    t0 = time.perf_counter()

    def build():
        return FrameGraphs(params, args, key)

    fg = graphs.get(key, build) if graphs is not None else build()
    fg.load(tokens, mask, lens, temperature)
    capture_s = 0.0
    if device.type == "cuda" and fg.graphs is None:
        fg.capture()
        capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fg.draw(generator)
    fg.run_prefill()
    all_done = fg.all_done()  # host read: also ends the prefill's device work
    prefill_s = time.perf_counter() - t0

    i = 1
    while i < max_frames and not all_done:
        for _ in range(min(CHUNK, max_frames - i)):
            fg.draw(generator)
            fg.run_step()
            i += 1
        all_done = fg.all_done()
    return GenerationResult(fg.frames.clone(), fg.num_frames.clone(), i - 1, prefill_s, capture_s)


def generate_audio_tokens(
    params: dict,
    args: ModelArgs,
    prompt_tokens: torch.Tensor,
    prompt_mask: torch.Tensor,
    prompt_len: torch.Tensor,
    max_frames: int,
    temperature: float = 0.9,
    topk: int = 50,
    compute_dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    kv_dtype=None,
) -> GenerationResult:
    """Generate up to ``max_frames`` frames after the prompt, eagerly: one
    ``generate_frame`` call and one host read of ``done`` a frame.

    Args:
        params: CSM parameters on ``device``.
        prompt_tokens / prompt_mask: (B, S_pad, K+1) right-padded frames and
            column liveness (False on padding rows).
        prompt_len: (B,) real prompt lengths.
        (the three prompt arrays may be tensors or numpy arrays)
        temperature: divides the logits as a float32 device scalar, as in
            the graphed entry, so both round alike.
        generator: torch.Generator on ``device`` for the sampling draws.
        kv_dtype: backbone cache dtype (``torch.int8``: quantized KV cache;
            None: ``compute_dtype``).
    """
    device = resolve_device(device)
    prompt_tokens, prompt_mask, prompt_len = _prompt_tensors(
        params, prompt_tokens, prompt_mask, prompt_len, device)
    K = args.audio_num_codebooks
    B, S_pad, _ = prompt_tokens.shape
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=device)
    t0 = time.perf_counter()

    state = csm.init_frame_state(args, B, compute_dtype, S_pad + max_frames, device, kv_dtype)
    col = torch.arange(S_pad, dtype=torch.int32, device=device)
    input_pos = torch.where(
        col[None, :] < prompt_len[:, None], col[None, :], torch.full_like(col, csm.PAD_POS)
    )

    frame, state = csm.generate_frame(
        params, args, generator, prompt_tokens, prompt_mask, input_pos, state,
        temperature, topk, compute_dtype, last_idx=prompt_len - 1,
    )
    frames_buf = torch.zeros((B, max_frames, K), dtype=torch.int32, device=device)
    done = (frame == 0).all(dim=1)
    frames_buf[:, 0] = torch.where(done[:, None], 0, frame)
    num_frames = (~done).to(torch.int32)
    all_done = bool(done.all())  # host read: also ends the prefill's device work
    prefill_s = time.perf_counter() - t0

    # frame i-1 is consumed as one token: audio columns live, text dead
    step_mask = torch.zeros((B, 1, K + 1), dtype=torch.bool, device=device)
    step_mask[:, :, :K] = True
    i = 1
    while i < max_frames and not all_done:
        step_tokens = torch.zeros((B, 1, K + 1), dtype=torch.int32, device=device)
        step_tokens[:, 0, :K] = frame
        pos = (prompt_len[:, None] + (i - 1)).to(torch.int32)
        frame, state = csm.generate_frame(
            params, args, generator, step_tokens, step_mask, pos, state,
            temperature, topk, compute_dtype,
        )
        done = done | (frame == 0).all(dim=1)
        frames_buf[:, i] = torch.where(done[:, None], 0, frame)
        num_frames += (~done).to(torch.int32)
        all_done = bool(done.all())
        i += 1
    return GenerationResult(frames_buf, num_frames, i - 1, prefill_s)
