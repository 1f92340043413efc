"""Continuous-batching serving: up to ``n_slots`` generation streams decode
together, one frame of every live stream a step.

The counterpart of the JAX package's ``serving.py`` on one device.  One
resident ``FrameState`` of ``n_slots`` rows holds every stream's backbone
cache; each row writes its own column (``RowOffsets``) and starts over when
a request is admitted to it.  The control plane lives on the device, as in
the JAX ``SlotState``: per-slot fed-back frame, position, liveness and frame
budget, updated by the step itself, so the host only reads results.

On a card every function of the server is a CUDA graph over static buffers,
captured on first use (``warmup`` captures them all before traffic), the
graphs of one server sharing one memory pool:

  * ``DecodeStep``, one S=1 step per capacity c (1, 2, 4, ... up to
    n_slots/2, and n_slots).  A dispatch gathers the live rows into the
    capacity's buffers (idle-slot compaction; capacity n_slots works on the
    resident state itself), enqueues ``chunk_size`` replays, each after its
    uniform draw, scatters the rows back and copies frames, counts,
    liveness and the pending frame 0s to the host in one transfer: the JAX
    chunk's ``while_loop`` and its one gather.  A step in which no row is
    live changes nothing the host reads, so the chunk runs to its end
    where the JAX loop exits early.
  * ``Prefill``, one per prompt bucket, over a one-row scratch state of the
    full cache length; the same graph copies the row into the admitted
    slot and sets the slot's control state (the JAX ``_prefill_fn`` and
    ``_admit``).  The slot is a device index, so one capture serves every
    slot.  A prefill in place in the slot's row would need a capture per
    slot; the copy is one row of the cache (~34 MB at CSM-1B, 1024
    columns).

  * ``Prefill`` also runs a registered prefix's admission, one per
    (prefix bucket, prompt bucket): the prefix's K/V blocks are copied into
    the scratch row's first columns before the replay (the graph reads
    them at a fixed address), the request's own frames follow at positions
    continuing the prefix; and a prefix's registration, one per prefix
    bucket, over a scratch state of the bucket's columns.

Shared prefixes (``register_prefix``, a request's ``prefix``): a voice
preset's context runs through the backbone once; a request naming it
starts from a copy of its K/V, so removing or replacing a prefix leaves
admitted streams alone.

Sliding window (``window=``): the cache holds ``window`` columns; a row
keeps its prompt (and prefix) in columns [0, anchor) and its decode frames
wrap over [anchor, window), positions staying absolute, so a stream
attends its prompt and its latest frames and runs past ``max_seq_len``.
Before a row's position reaches the RoPE horizon, a re-anchor shifts its
positions down and rotates its cached keys by the same amount (RoPE is
relative: the scores are unchanged).

Multi-LoRA serving (``adapters=``, ``add_adapter``, a request's
``adapter``): the adapters are stacked into one bank over the fused param
layout (training/lora.fuse_lora_bank, id 0 the zero adapter) and every row
applies its own adapter by its id.  The bank and the per-slot ids are
device buffers that the graphs read: the ids follow their rows into a
capacity's buffers and back, and into the admission's row.  An
``add_adapter`` or ``remove_adapter`` that keeps the bank's shapes copies
the new bank into the old buffers on the serving stream (after the chunk in
flight), with no new capture; one that changes a shape (another largest
rank, another set of touched projections, another adapter count) retakes
every capture at its next use, and the old graphs and bank stay alive
until the work queued before the change has run.

On the CPU the same functions run without capture.  Sampling draws its
uniforms from a ``torch.Generator`` that ``reset(seed)`` seeds, outside the
graphs; the JAX server's ``fold_in`` key schedule is not reproduced, so the
two servers' codes are equal at topk=1 only.  Meshes raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from csm_torch.generator import _waits
from csm_torch.models import csm
from csm_torch.models.config import ModelArgs, with_horizon
from csm_torch.models.generation import PROMPT_BUCKETS, bucket_length, capture_graphs, replay
from csm_torch.ops.kvcache import (KVCache, KVHalf, QuantKV, RowOffsets, cache_leaves,
                                   quantize_kv_rows, reset_kv_cache)
from csm_torch.ops.rope import apply_rope, scaled_rope_freqs
from csm_torch.training import lora as lora_mod
from csm_torch.utils import quantize as qz
from csm_torch.utils.device import resolve_device

WEIGHT_DTYPES = ("bf16", "int8", "int8-decoder", "int4", "auto")


@dataclasses.dataclass
class StreamRequest:
    """One TTS request, its prompt packed to (T, K+1) frames.

    ``on_frames(request_id, new_frames (n, K) int32, done)`` is called from
    the serving thread as chunks complete; ``done=True`` fires exactly
    once, possibly with n=0.  ``prefix`` names a prefix registered with
    ``BatchedServer.register_prefix``: the stream starts from its cached
    context, and ``tokens`` holds only the request's own frames.
    ``adapter`` names a loaded LoRA adapter (None: the base model); with a
    ``prefix`` it must be the adapter the prefix was registered under."""

    tokens: np.ndarray  # (T, K+1) int32
    mask: np.ndarray  # (T, K+1) bool
    max_frames: int
    request_id: Any = 0
    on_frames: Optional[Callable[[Any, np.ndarray, bool], None]] = None
    adapter: Optional[str] = None
    prefix: Optional[str] = None


@dataclasses.dataclass
class StreamResult:
    request_id: Any
    frames: np.ndarray  # (n, K) int32 audio codes
    n_steps: int
    cancelled: bool = False  # aborted through BatchedServer.cancel()
    # host times (perf_counter) of its admission, first frame on the host
    # and finish: admit_s, first_frame_s (absent with no frame), done_s
    times: Dict[str, float] = dataclasses.field(default_factory=dict)


class CachedPrefix(NamedTuple):
    """A registered context's backbone K/V on the device: a voice preset
    (context audio and transcript) shared by the requests that name it.
    Admission copies the blocks into the slot's row.  ~32 KB a token at
    CSM-1B bf16, half that with the int8 KV."""

    k: KVHalf  # (L, 1, PB, Hkv, D), or QuantKV halves
    v: KVHalf
    kv_pos: torch.Tensor  # (1, PB) int32: 0..length-1, then PAD_POS
    length: int  # real frames
    bucket: int  # PB: the cache columns it takes
    adapter: Optional[str]


class SlotState(NamedTuple):
    """The device-resident control plane, one entry per row."""

    last_frame: torch.Tensor  # (B, K) int32: fed back as the next token
    pos: torch.Tensor  # (B,) int32: position of the fed token
    live: torch.Tensor  # (B,) bool
    remaining: torch.Tensor  # (B,) int32: frames the row may still emit
    # sliding window: columns [0, anchor) hold the prompt (and prefix) and
    # are never overwritten; decode frames wrap over [anchor, window).
    # Prefix bucket + prompt bucket; unused outside windowed mode.
    anchor: torch.Tensor  # (B,) int32


def init_slot_state(batch: int, K: int, device) -> SlotState:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SlotState(z(batch, K), z(batch), z(batch, dtype=torch.bool), z(batch), z(batch))


class _InFlight(NamedTuple):
    """A dispatched chunk whose results are not read yet.

    ``host`` receives frames (chunk, c, K), counts (c,), liveness (c,) and
    the pending frame 0s (P, K), packed as int32, by one copy enqueued
    behind the chunk; ``ready`` is that copy's event (None on the CPU).
    ``gens`` snapshots each slot's admission generation, so results apply
    only to the request that was resident at dispatch."""

    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    chunk: int
    capacity: int
    pend: List[int]  # slots whose deferred frame 0 rides this chunk
    live_idx: np.ndarray  # active slots at dispatch
    row_of: Dict[int, int]  # slot -> row in the chunk
    gens: Dict[int, int]


class DecodeStep:
    """One capacity's S=1 decode step on static buffers.

    ``step`` feeds each row's last frame at its position, writes each live
    row's K/V at its own cache column, samples, and updates frames, counts
    and the control plane on the device: emit = live and not EOS; a row
    goes dead on EOS or when its budget runs out.  Dead rows query at
    PAD_POS and write at their column, which may run past the cache's end
    (dropped, ``write_rows``); their results are never read.  In windowed
    mode each row's column first wraps into its ring [anchor, window); a
    column past ``window`` (the capture's sentinel) is left where it is,
    and its write dropped."""

    def __init__(self, server: "BatchedServer", c: int):
        args, dev = server.args, server.device
        K = args.audio_num_codebooks
        self.server, self.c = server, c
        if c == server.n_slots:  # the full batch decodes the resident state
            self.state, self.slots, self.idx = server.state, server.slots, None
            self.ids = server.adapter_ids
        else:
            st = csm.init_frame_state(args, c, server.compute_dtype, server.cache_len, dev,
                                      server.kv_dtype)
            self.state = st._replace(offset=RowOffsets(torch.zeros(c, dtype=torch.int64, device=dev)))
            self.slots = init_slot_state(c, K, dev)
            self.idx = torch.zeros(c, dtype=torch.int64, device=dev)
            self.ids = torch.zeros(c, dtype=torch.int64, device=dev)  # the rows' adapters
        self.uniforms = torch.zeros((K, c, 1), dtype=torch.float32, device=dev)
        self.dec_bufs = csm.init_decoder_buffers(args, c, server.compute_dtype, dev)
        self.tokens = torch.zeros((c, 1, K + 1), dtype=torch.int32, device=dev)
        self.audio_cols = torch.zeros((c, 1, K + 1), dtype=torch.bool, device=dev)
        self.audio_cols[:, :, :K] = True  # frame i-1 in: audio columns, text dead
        self.frames = torch.zeros((server.chunk_size, c, K), dtype=torch.int32, device=dev)
        self.counts = torch.zeros((c,), dtype=torch.int32, device=dev)
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)  # step within the chunk
        self.graph = None

    def step(self) -> None:
        srv, sl = self.server, self.slots
        K = srv.args.audio_num_codebooks
        live = sl.live
        if srv.window is not None:  # the ring write: the oldest decode column goes
            C, cols, anchor = srv.cache_len, self.state.offset.cols, sl.anchor.long()
            ring = anchor + torch.remainder(cols - anchor, (C - anchor).clamp_min(1))
            cols.copy_(torch.where(cols <= C, ring, cols))
        self.tokens[:, 0, :K] = sl.last_frame
        pos = torch.where(live, sl.pos, csm.PAD_POS)[:, None]
        frame, _ = csm.generate_frame(
            srv.params, srv.args, None, self.tokens, self.audio_cols & live[:, None, None], pos,
            self.state, srv.temperature_t, srv.topk, srv.compute_dtype,
            uniforms=self.uniforms, dec_bufs=self.dec_bufs, lora=srv.bank, lora_ids=self.ids,
        )
        self.state.offset.cols.add_(1)
        emit = live & ~(frame == 0).all(dim=1)  # EOS emits the all-zero frame
        frame = torch.where(emit[:, None], frame, 0)
        self.frames.index_copy_(0, self.t, frame[None])
        self.counts.add_(emit.to(torch.int32))
        remaining = sl.remaining - emit.to(torch.int32)
        sl.last_frame.copy_(torch.where(emit[:, None], frame, sl.last_frame))
        sl.pos.add_(1)
        sl.live.copy_(emit & (remaining > 0))
        sl.remaining.copy_(remaining)
        self.t.add_(1)

    def capture(self) -> None:
        """Capture ``step``.  Its eager warm-up pass runs with every row dead
        and every column past the cache's end, where no ring wraps it (a live
        row's column is at most the cache's length), so it writes no cache
        entry; the control state and the step counter it advances are put
        back after.  Capacities are captured on first use, while other rows
        are live, and a capture retaken after a bank reshape happens in the
        middle of a chunk's dispatch."""
        state = (*self.slots, self.state.offset.cols, self.t)
        keep = [x.clone() for x in state]
        self.slots.live.zero_()
        self.state.offset.cols.fill_(self.server.cache_len + 1)
        try:
            self.graph = self.server._capture(self.step)
        finally:
            for x, k in zip(state, keep):
                x.copy_(k)

    def run(self) -> None:
        """One step: the graph's replay, captured at first use (or retaken
        after a bank reshape) on a card; the step itself on the CPU."""
        if self.graph is None and self.server.graphs:
            self.capture()
        if self.graph is None:
            self.step()
        else:
            replay(self.graph)

    def gather(self, live_idx: np.ndarray) -> None:
        """The live rows, then copies of the last row forced dead, into this
        capacity's buffers."""
        srv, n = self.server, self.server.n_slots
        idx = np.full((self.c,), n, np.int64)
        idx[: len(live_idx)] = live_idx
        self.idx.copy_(srv._to_device(idx), non_blocking=True)
        rows = self.idx.clamp(max=n - 1)
        for full, sub in zip(cache_leaves(srv.state.cache), cache_leaves(self.state.cache)):
            torch.index_select(full, 1, rows, out=sub)
        torch.index_select(srv.state.kv_pos, 0, rows, out=self.state.kv_pos)
        torch.index_select(srv.offsets, 0, rows, out=self.state.offset.cols)
        for full, sub in zip(srv.slots, self.slots):
            torch.index_select(full, 0, rows, out=sub)
        torch.index_select(srv.adapter_ids, 0, rows, out=self.ids)
        self.slots.live.logical_and_(self.idx < n)

    def scatter(self, n_live: int) -> None:
        """The first ``n_live`` rows back to their slots; padding rows are
        never written back."""
        srv = self.server
        idx = self.idx[:n_live]
        for full, sub in zip(cache_leaves(srv.state.cache), cache_leaves(self.state.cache)):
            full.index_copy_(1, idx, sub[:, :n_live])
        srv.state.kv_pos.index_copy_(0, idx, self.state.kv_pos[:n_live])
        srv.offsets.index_copy_(0, idx, self.state.offset.cols[:n_live])
        for full, sub in zip(srv.slots, self.slots):
            full.index_copy_(0, idx, sub[:n_live])
        srv.adapter_ids.index_copy_(0, idx, self.ids[:n_live])

    def release(self) -> None:
        if self.graph is not None:
            self.graph[0].reset()
        self.graph = None


class Prefill:
    """One prompt bucket's admission on static buffers: the prompt through
    a one-row scratch state of the full cache length, frame 0 sampled, the
    row copied into slot ``slot`` of the resident state and the slot's
    control state set (live unless frame 0 is EOS or the budget is 1).
    The scratch cache is never cleared: its ``kv_pos`` is reset, so the
    columns past the prompt are never attended.

    ``prefix`` = PB > 0: the admission of a request naming a prefix of
    bucket PB.  ``load_prefix`` copies the prefix's blocks into the scratch
    row's columns [0, PB) before the run (the graph reads them there); the
    request's frames go to columns [PB, PB + bucket) at positions from the
    prefix's length on.  ``admit=False``: a prefix's registration, over a
    scratch state of ``bucket`` columns; its cache is the result."""

    def __init__(self, server: "BatchedServer", bucket: int, prefix: int = 0, admit: bool = True):
        args, dev = server.args, server.device
        K = args.audio_num_codebooks
        self.server, self.bucket, self.prefix, self.admit = server, bucket, prefix, admit
        self.tokens = torch.zeros((1, bucket, K + 1), dtype=torch.int32, device=dev)
        self.mask = torch.zeros((1, bucket, K + 1), dtype=torch.bool, device=dev)
        self.length = torch.ones((1,), dtype=torch.int32, device=dev)
        self.p_len = torch.zeros((1,), dtype=torch.int32, device=dev)  # the prefix's frames
        self.budget = torch.ones((1,), dtype=torch.int32, device=dev)
        self.slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.ids = torch.zeros((1,), dtype=torch.int64, device=dev)  # the request's adapter
        self.end_col = torch.full((1,), prefix + bucket, dtype=torch.int64, device=dev)
        self.col = torch.arange(bucket, dtype=torch.int32, device=dev)
        self.uniforms = torch.zeros((K, 1, 1), dtype=torch.float32, device=dev)
        self.sub = csm.init_frame_state(args, 1, server.compute_dtype,
                                        server.cache_len if admit else bucket, dev,
                                        server.kv_dtype)
        self.dec_bufs = csm.init_decoder_buffers(args, 1, server.compute_dtype, dev)
        self.graph = None

    def load_prefix(self, pre: CachedPrefix) -> None:
        """The prefix's K/V and positions into the scratch row's first
        columns (device copies, enqueued before the run)."""
        pb = self.prefix
        for dst, src in zip(cache_leaves(self.sub.cache), cache_leaves(KVCache(pre.k, pre.v))):
            dst[:, :, :pb].copy_(src)
        self.sub.kv_pos[:, :pb].copy_(pre.kv_pos)

    def prefill(self) -> None:
        srv, sub, pb = self.server, self.sub, self.prefix
        sub.kv_pos[:, pb:].fill_(csm.PAD_POS)
        col = self.col[None, :]
        input_pos = torch.where(col < self.length[:, None], self.p_len[:, None] + col, csm.PAD_POS)
        frame, _ = csm.generate_frame(
            srv.params, srv.args, None, self.tokens, self.mask, input_pos, sub._replace(offset=pb),
            srv.temperature_t, srv.topk, srv.compute_dtype, last_idx=self.length - 1,
            uniforms=self.uniforms, dec_bufs=self.dec_bufs, lora=srv.bank, lora_ids=self.ids,
        )
        if not self.admit:
            return
        for full, new in zip(cache_leaves(srv.state.cache), cache_leaves(sub.cache)):
            full.index_copy_(1, self.slot, new)
        srv.state.kv_pos.index_copy_(0, self.slot, sub.kv_pos)
        srv.offsets.index_copy_(0, self.slot, self.end_col)
        sl = srv.slots
        eos = (frame == 0).all(dim=1)
        sl.last_frame.index_copy_(0, self.slot, frame)
        sl.pos.index_copy_(0, self.slot, self.p_len + self.length)
        sl.live.index_copy_(0, self.slot, ~eos & (self.budget > 1))
        sl.remaining.index_copy_(0, self.slot, self.budget - 1)
        sl.anchor.index_copy_(0, self.slot, self.end_col.to(torch.int32))
        srv.adapter_ids.index_copy_(0, self.slot, self.ids)
        srv.frame0.index_copy_(0, self.slot, frame)

    def run(self) -> None:
        """Admit (or register) the loaded request.  The first run on a card
        captures the graph: its eager warm-up pass does this same work,
        which the replay then repeats."""
        if self.server.graphs and self.graph is None:
            self.graph = self.server._capture(self.prefill)
        if self.graph is None:
            self.prefill()
        else:
            replay(self.graph)

    def release(self) -> None:
        if self.graph is not None:
            self.graph[0].reset()
        self.graph = None


class BatchedServer:
    """Continuous-batching decode server over ``n_slots`` streams.

    ``chunk_size``: decode steps per host round trip.  ``ramp_chunk``: a
    shorter chunk for the one dispatch right after an admission, so a
    stream's first frames reach the host sooner.  ``pipelined``: keep one
    chunk in flight, dispatching chunk N+1 before reading chunk N; results
    land one step later and a freed slot admits one step later; with
    ``ramp_chunk`` set, an admission's step goes synchronous.
    ``weight_dtype``: "bf16" keeps the weights as given, "int8" /
    "int8-decoder" / "int4" quantize them here (``utils/quantize.py``),
    "auto" is int8 (the JAX package's policy).  ``kv_dtype``: "bf16" or
    "int8" (a ``QuantKV`` cache).  ``temperature`` may be changed between
    steps; ``topk`` is fixed.  ``window``: a sliding-window cache of that
    many columns for sessions of any length (``max_frames`` is not capped
    by the cache), re-anchored ``reanchor_headroom`` positions below the
    RoPE horizon.  ``adapters``: {name: an adapter directory
    (training/lora.save_lora) or a preloaded (lora tree, LoRAConfig,
    ModelArgs or None)}, served as one bank (the module note).  On a card
    the functions are captured (``graphs``; ``captures`` and
    ``capture_s`` count them); on the CPU they run without capture."""

    def __init__(
        self,
        params: dict,
        args: ModelArgs,
        n_slots: int = 8,
        max_seq_len: int = 2048,
        temperature: float = 0.9,
        topk: int = 50,
        compute_dtype=torch.bfloat16,
        chunk_size: int = 8,
        ramp_chunk: Optional[int] = None,
        mesh=None,
        weight_dtype: str = "bf16",
        kv_dtype: str = "bf16",
        adapters: Optional[dict] = None,
        pipelined: bool = False,
        window: Optional[int] = None,
        reanchor_headroom: int = 1024,
        device="cuda",
    ):
        if mesh is not None:
            raise _waits("serving over a device mesh", "A.11b")
        self._model_args = args  # what an adapter must have been trained for
        self.window = window
        if window is not None:
            if window > max_seq_len:
                raise ValueError(f"window {window} exceeds max_seq_len {max_seq_len}")
            if window < 2 * chunk_size + 2:
                raise ValueError(f"window {window} is too small for chunk_size {chunk_size} "
                                 f"(need >= {2 * chunk_size + 2})")
            if reanchor_headroom < 3 * chunk_size + 4:
                raise ValueError(f"reanchor_headroom {reanchor_headroom} < {3 * chunk_size + 4} "
                                 f"(3*chunk_size + 4)")
            # positions run past the cache between re-anchors: the RoPE
            # table reaches the horizon, no weight changes
            horizon = max(args.backbone.max_seq_len, window + reanchor_headroom)
            args = with_horizon(args, horizon)
            # the host's mirror of each live row's position schedules them
            self._reanchor_at = horizon - 2 * chunk_size - 2
            self._reanchor_target = window + chunk_size
        self.cache_len = window if window is not None else max_seq_len
        if weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be {'|'.join(WEIGHT_DTYPES)}, got {weight_dtype!r}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        if ramp_chunk is not None and not 1 <= ramp_chunk < chunk_size:
            raise ValueError(
                f"ramp_chunk must be in [1, chunk_size) = [1, {chunk_size}), got {ramp_chunk}")
        self.device = resolve_device(device)
        if params["text_embeddings"].device.type != self.device.type:
            raise ValueError(f"params are on {params['text_embeddings'].device}, not {self.device}")
        self.weight_dtype = "int8" if weight_dtype == "auto" else weight_dtype
        params = _quantized(params, self.weight_dtype)
        self.params = csm.fuse_csm_params(params)
        self.args = args
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.temperature = temperature
        self.topk = topk
        self.compute_dtype = compute_dtype
        self.chunk_size = chunk_size
        self.ramp_chunk = ramp_chunk
        self.pipelined = pipelined
        self.kv_dtype = torch.int8 if kv_dtype == "int8" else None
        self.graphs = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.captures = 0  # graphs captured, and their seconds
        self.capture_s = 0.0
        # graphs and bank buffers replaced while work that reads them may
        # still be queued: (event recorded at the replacement, objects)
        self._retired: List[tuple] = []

        dev, K = self.device, args.audio_num_codebooks
        bb = args.backbone
        self._rope_freqs = torch.from_numpy(scaled_rope_freqs(
            bb.head_dim, bb.rope_base, bb.rope_scale_factor, bb.rope_low_freq_factor,
            bb.rope_high_freq_factor, bb.rope_old_context_len).astype(np.float32)).to(dev)
        self.offsets = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        state = csm.init_frame_state(args, n_slots, compute_dtype, self.cache_len, dev,
                                     self.kv_dtype)
        self.state = state._replace(offset=RowOffsets(self.offsets))
        self.slots = init_slot_state(n_slots, K, dev)
        self.frame0 = torch.zeros((n_slots, K), dtype=torch.int32, device=dev)
        self.adapter_ids = torch.zeros((n_slots,), dtype=torch.int64, device=dev)  # by slot
        self.temperature_t = torch.ones((), dtype=torch.float32, device=dev)
        self._decodes: Dict[int, DecodeStep] = {}  # by capacity
        self._prefills: Dict[int, Prefill] = {}  # by bucket
        self._prefix_prefills: Dict[tuple, Prefill] = {}  # by (prefix bucket, bucket)
        self._register_fns: Dict[int, Prefill] = {}  # by prefix bucket
        self._prefixes: Dict[str, CachedPrefix] = {}
        # steps run by capacity, prefills by their own bucket (a prefix's
        # admission too) and registrations by prefix bucket, cumulative:
        # what the kernels' launch counts follow
        self.step_calls: Dict[int, int] = {}
        self.prefill_calls: Dict[int, int] = {}
        self.register_calls: Dict[int, int] = {}
        # multi-LoRA: _loaded[id - 1] is (tree, LoRAConfig) or None for a
        # freed id, so surviving ids are stable across add and remove
        self.bank: Optional[dict] = None
        self._adapter_id: Dict[str, int] = {}
        self._loaded: List[Optional[tuple]] = []
        if adapters:
            for name, src in adapters.items():
                self._loaded.append(self._load_adapter(name, src))
                self._adapter_id[name] = len(self._loaded)  # 0 = base
            self._rebuild_bank()
        self.reset()

    # ---- state ----

    def reset(self, seed: int = 0) -> None:
        """Clear every stream and the device state in place (the graphs
        keep their buffers); reseed the sampling generator."""
        reset_kv_cache(self.state.cache)
        self.state.kv_pos.fill_(csm.PAD_POS)
        self.offsets.zero_()
        for x in self.slots:
            x.zero_()
        self.frame0.zero_()
        self.adapter_ids.zero_()
        self._slot_adapter = np.zeros(self.n_slots, np.int64)  # host mirror of adapter_ids
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        n = self.n_slots
        self.slot_request: List[Optional[StreamRequest]] = [None] * n
        self.slot_frames: List[List[np.ndarray]] = [[] for _ in range(n)]
        self.slot_streamed = np.zeros(n, np.int64)  # frames sent to on_frames
        self.active = np.zeros(n, bool)
        self.slot_gen = np.zeros(n, np.int64)  # admission generation per slot
        # admitted slots whose frame 0 is still on the device: it rides the
        # next chunk's read, so submit() reads nothing from the card
        self._pending: List[int] = []
        # the most frames each slot can still emit after the steps already
        # dispatched (its budget; EOS can only end it sooner): a chunk runs
        # no step that no row could use
        self._left = np.zeros(n, np.int64)
        self._inflight: Optional[_InFlight] = None
        # streams finished in submit() (budget < 1) or drained by cancel()
        self._finished_at_submit: List[StreamResult] = []
        # each slot's request's host times (perf_counter): its admission and
        # its first frame on the host; handed to its StreamResult
        self.slot_times: List[Dict[str, float]] = [{} for _ in range(n)]
        self.read_wait_s = 0.0  # host seconds spent waiting for chunks' results
        # each slot's position, exact for live rows (a row's position moves
        # once a frame it emits): schedules the windowed re-anchors
        self._pos_host = np.zeros(n, np.int64)

    def close(self) -> None:
        """Free the graphs, their pool and every buffer of the capacities
        and buckets; the resident state goes with the server."""
        fns = (list(self._decodes.values()) + list(self._prefills.values())
               + list(self._prefix_prefills.values()) + list(self._register_fns.values()))
        for fn in fns:
            fn.release()
        for d in (self._decodes, self._prefills, self._prefix_prefills, self._register_fns):
            d.clear()
        self._retired.clear()

    def _capture(self, fn):
        """One graph of ``fn`` in the server's pool, counted and timed."""
        t0 = time.perf_counter()
        (graph,) = capture_graphs([fn], self.device, self.pool)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph

    def _retire(self, *objs) -> None:
        """Keep ``objs`` alive until the work queued so far has run."""
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        self._retired.append((ev, objs))

    def _prune_retired(self) -> None:
        self._retired = [(ev, o) for ev, o in self._retired if not ev.query()]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array for a non-blocking copy: pinned on a card, so
        the host does not wait for the queued chunk."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _load(self, dst: torch.Tensor, a: np.ndarray) -> None:
        dst.copy_(self._to_device(a), non_blocking=True)

    # ---- functions on static buffers ----

    def _decode_step(self, c: int) -> DecodeStep:
        ds = self._decodes.get(c)
        if ds is None:
            ds = self._decodes[c] = DecodeStep(self, c)
        return ds

    def _prefill(self, bucket: int, prefix: int = 0) -> Prefill:
        fns, key = (self._prefix_prefills, (prefix, bucket)) if prefix else (self._prefills, bucket)
        pf = fns.get(key)
        if pf is None:
            pf = fns[key] = Prefill(self, bucket, prefix)
        return pf

    def _decode_capacity(self, n_live: int) -> int:
        """The smallest power of two that holds the live slots, or
        ``n_slots`` when that cannot at least halve the batch."""
        c = 1
        while c < n_live:
            c *= 2
        return c if c <= self.n_slots // 2 else self.n_slots

    # ---- shared prefixes ----

    def register_prefix(self, name: str, tokens: np.ndarray, mask: np.ndarray,
                        adapter: Optional[str] = None) -> CachedPrefix:
        """Run a shared context ((T, K+1) frames, e.g. a voice preset's
        segments) through the backbone once and keep its K/V under
        ``name``; a request with ``prefix=name`` then carries only its own
        frames.  Registering a name again replaces it for later admissions.
        ``adapter``: compute it under a loaded adapter; requests naming the
        prefix must name the same adapter."""
        aid = 0
        if adapter is not None:
            if adapter not in self._adapter_id:
                raise ValueError(f"prefix {name!r}: unknown adapter {adapter!r} "
                                 f"(loaded: {sorted(self._adapter_id)})")
            aid = self._adapter_id[adapter]
        T = int(tokens.shape[0])
        # a finer bucket list than requests': a short preset leaves more of
        # the cache to the request
        bucket = bucket_length(T, tuple(b for b in (32,) + PROMPT_BUCKETS if b <= self.cache_len))
        if bucket + 1 >= self.cache_len:
            raise ValueError(f"prefix {name!r}: bucket {bucket} leaves no room for a request in "
                             f"the {self.cache_len}-column cache")
        K = self.args.audio_num_codebooks
        toks = np.zeros((1, bucket, K + 1), np.int32)
        msk = np.zeros((1, bucket, K + 1), bool)
        toks[0, :T], msk[0, :T] = tokens, mask
        reg = self._register_fns.get(bucket)
        if reg is None:
            reg = self._register_fns[bucket] = Prefill(self, bucket, admit=False)
        self._load(reg.tokens, toks)
        self._load(reg.mask, msk)
        self._load(reg.length, np.array([T], np.int32))
        self._load(reg.ids, np.array([aid], np.int64))
        reg.run()
        self.register_calls[bucket] = self.register_calls.get(bucket, 0) + 1
        blocks = [x.clone() for x in cache_leaves(reg.sub.cache)]
        k, v = ((QuantKV(*blocks[:2]), QuantKV(*blocks[2:])) if self.kv_dtype is not None
                else blocks)
        pre = CachedPrefix(k, v, reg.sub.kv_pos.clone(), T, bucket, adapter)
        self._prefixes[name] = pre
        return pre

    def unregister_prefix(self, name: str) -> None:
        """Drop a prefix: later requests naming it are refused; streams
        admitted from it keep their copy."""
        if name not in self._prefixes:
            raise ValueError(f"unknown prefix {name!r} (registered: {sorted(self._prefixes)})")
        del self._prefixes[name]

    # ---- multi-LoRA adapter bank ----

    def _load_adapter(self, name: str, src) -> tuple:
        if isinstance(src, str):
            lora, lcfg, largs = lora_mod.load_lora(src)
        else:  # preloaded (lora tree, LoRAConfig, ModelArgs or None)
            lora, lcfg, largs = src
        if largs is not None and largs != self._model_args:
            raise ValueError(f"adapter {name!r} was trained for a different model shape")
        return lora, lcfg

    def _rebuild_bank(self) -> None:
        """Restack the bank from ``_loaded`` (a freed id: zero rows).  Same
        shapes: copied into the old buffers in place; else the new buffers
        replace them and every graph is retaken at its next use."""
        if not self._adapter_id:
            new = None
        else:
            loaded = [x if x is not None else ({}, lora_mod.LoRAConfig(r=1))
                      for x in self._loaded]
            new = lora_mod.fuse_lora_bank(loaded, self._model_args, dtype=self.compute_dtype,
                                          layout="fused", device=self.device)
            for comp in ("backbone", "decoder"):
                extra = set(new.get(comp) or ()) - set(self.params[comp])
                if extra:
                    raise ValueError(f"adapter bank names {sorted(extra)} missing from the "
                                     f"{comp} param layout: adapters would be ignored")
        old = self.bank
        if (old is not None and new is not None
                and lora_mod.bank_shapes(old) == lora_mod.bank_shapes(new)):
            for comp, sub in new.items():  # on the serving stream: after the chunk in flight
                for name, ad in (sub or {}).items():
                    for ab, t in ad.items():
                        old[comp][name][ab].copy_(t)
            return
        graphs = [fn.graph for d in (self._decodes, self._prefills, self._prefix_prefills,
                                     self._register_fns) for fn in d.values() if fn.graph]
        for d in (self._decodes, self._prefills, self._prefix_prefills, self._register_fns):
            for fn in d.values():
                fn.graph = None
        self._retire(old, graphs)
        self.bank = new

    def add_adapter(self, name: str, src) -> int:
        """Load a LoRA adapter into the running server (``src``: a
        ``save_lora`` directory or a preloaded (tree, LoRAConfig, ModelArgs
        or None)).  Streams in flight keep their adapters; the next
        admission may name it.  Returns its id."""
        if name in self._adapter_id:
            raise ValueError(f"adapter {name!r} already loaded")
        entry = self._load_adapter(name, src)
        free = [i for i, x in enumerate(self._loaded) if x is None]
        pos = free[0] if free else len(self._loaded)
        if free:
            self._loaded[pos] = entry
        else:
            self._loaded.append(entry)
        self._adapter_id[name] = pos + 1
        self._rebuild_bank()
        return pos + 1

    def remove_adapter(self, name: str) -> None:
        """Unload an adapter: its bank rows zero and its id is reused.
        Refused while an active stream decodes with it or a registered
        prefix was computed under it."""
        aid = self._adapter_id.get(name)
        if aid is None:
            raise ValueError(f"unknown adapter {name!r} (loaded: {sorted(self._adapter_id)})")
        if bool(np.any(self._slot_adapter[self.active] == aid)):
            raise ValueError(f"adapter {name!r} is in use by an active stream")
        stale = [p for p, pre in self._prefixes.items() if (pre.adapter or None) == name]
        if stale:
            raise ValueError(f"adapter {name!r} is referenced by prefix(es) {stale}")
        del self._adapter_id[name]
        # dead slots still holding the id read the base model's zero row
        self._slot_adapter[self._slot_adapter == aid] = 0
        self.adapter_ids.masked_fill_(self.adapter_ids == aid, 0)
        self._loaded[aid - 1] = None
        while self._loaded and self._loaded[-1] is None:
            self._loaded.pop()  # the bank shrinks when its tail frees
        self._rebuild_bank()

    # ---- sliding-window re-anchor ----

    def _maybe_reanchor(self) -> None:
        """Re-anchor every live row whose position nears the RoPE horizon
        (after reading a chunk in flight: the state must not move under
        it)."""
        if not (self.active & (self._pos_host >= self._reanchor_at)).any():
            return
        if self._inflight is not None:
            self._finished_at_submit.extend(self._collect(self._inflight))
            self._inflight = None
        need = self.active & (self._pos_host >= self._reanchor_at)
        delta = np.where(need, self._pos_host - self._reanchor_target, 0)
        for s in np.nonzero(need)[0]:
            self._reanchor(int(s), int(delta[s]))
        self._pos_host -= delta

    def _reanchor(self, row: int, delta: int) -> None:
        """Shift one row's positions down by ``delta``: every written
        column's keys rotated by -delta in float32 (RoPE composes: the
        scores, which depend on q_pos - k_pos, are unchanged), its kv_pos
        and its position moved by delta; values untouched.  An int8 row is
        requantized and then selected, so unwritten columns keep their
        codes and scales.  In place on the resident state, outside any
        graph: every capacity's buffers are refilled from it."""
        ang = (-float(delta)) * self._rope_freqs  # float32, as the JAX package
        cos, sin = torch.cos(ang)[None], torch.sin(ang)[None]
        kv_pos = self.state.kv_pos[row]
        region = kv_pos != csm.PAD_POS  # every written column, the anchor's too
        sel = region[None, :, None, None]
        k = self.state.cache.k
        if isinstance(k, QuantKV):
            q, scale = k.q[:, row], k.s[:, row]
            rq = quantize_kv_rows(apply_rope(q.float() * scale, cos, sin))
            q.copy_(torch.where(sel, rq.q, q))
            scale.copy_(torch.where(sel, rq.s, scale))
        else:
            kr = k[:, row]
            kr.copy_(torch.where(sel, apply_rope(kr, cos, sin), kr))
        kv_pos.copy_(torch.where(region, kv_pos - delta, kv_pos))
        self.slots.pos[row] -= delta

    # ---- host-side orchestration ----

    def warmup(self, verbose: bool = False) -> float:
        """Run every function before traffic: one admission per prompt
        bucket that fits, the full batch, every compaction capacity, and an
        admission from each registered prefix, then ``reset()``.  On a card
        this captures every graph.  Returns wall seconds."""
        t0 = time.perf_counter()
        K = self.args.audio_num_codebooks

        def dummy(T, prefix=None):
            tokens = np.zeros((T, K + 1), np.int32)
            mask = np.zeros((T, K + 1), bool)
            mask[:, K] = True
            # with a ramp the budget outlives the ramp step
            adapter = self._prefixes[prefix].adapter if prefix is not None else None
            return StreamRequest(tokens, mask, max_frames=3 + (self.ramp_chunk or 0),
                                 request_id=-1, prefix=prefix, adapter=adapter)

        def fits(used):  # the prompt buckets a request can take after ``used`` columns
            room = (self.window - 2 * self.chunk_size - 2 if self.window is not None
                    else self.max_seq_len - 3)
            return [b for b in PROMPT_BUCKETS if used + b <= room]

        def serve(n, T, prefix=None):
            for _ in range(n):
                self.submit(dummy(T, prefix))
            self.step()
            if self.ramp_chunk:
                self.step()
            self.step()  # a pipelined server reads its chunk here
            self.reset()

        fit = fits(0)
        for b in fit:
            serve(1, b)
            if verbose:
                print(f"  warmup: bucket {b} ready (+{time.perf_counter() - t0:.1f}s)", flush=True)
        serve(min(self.n_slots // 2 + 1, self.n_slots), fit[0])  # the full batch
        c = 2
        while c <= self.n_slots // 2:
            serve(c, fit[0])
            if verbose:
                print(f"  warmup: capacity {c} ready (+{time.perf_counter() - t0:.1f}s)", flush=True)
            c *= 2
        for name, pre in self._prefixes.items():
            sb = fits(pre.bucket)
            if sb:
                serve(1, sb[0], prefix=name)
                if verbose:
                    print(f"  warmup: prefix {name!r} ready (+{time.perf_counter() - t0:.1f}s)",
                          flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def submit(self, req: StreamRequest) -> Optional[int]:
        """Admit a request into a free slot (its prefill runs now); None
        when every slot is taken."""
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        T = req.tokens.shape[0]
        pre = None
        if req.prefix is not None:
            pre = self._prefixes.get(req.prefix)
            if pre is None:
                raise ValueError(f"request {req.request_id}: unknown prefix {req.prefix!r} "
                                 f"(registered: {sorted(self._prefixes)})")
            if (pre.adapter or None) != (req.adapter or None):
                raise ValueError(
                    f"request {req.request_id}: prefix {req.prefix!r} was computed under "
                    f"adapter {pre.adapter!r} but the request uses {req.adapter!r}: register "
                    f"the prefix with adapter={req.adapter!r}")
        pb = pre.bucket if pre is not None else 0
        said = f"prefix bucket {pb} + " if pb else ""
        bucket = bucket_length(T, tuple(b for b in PROMPT_BUCKETS if b <= self.cache_len))
        if self.window is not None:
            # the prompt is the anchor; decode frames need a ring, and
            # max_frames is not capped (the ring evicts)
            if pb + bucket + 2 * self.chunk_size + 2 > self.window:
                raise ValueError(
                    f"request {req.request_id}: {said}prompt bucket {bucket} leaves no decode "
                    f"ring in window {self.window} (need >= {2 * self.chunk_size + 2} ring "
                    f"columns)")
        elif pb + bucket + req.max_frames > self.max_seq_len:
            # the device budgets stop decode at max_frames exactly
            raise ValueError(
                f"request {req.request_id}: {said}prompt bucket {bucket} + max_frames "
                f"{req.max_frames} exceeds max_seq_len {self.max_seq_len}")
        K = self.args.audio_num_codebooks
        toks = np.zeros((1, bucket, K + 1), np.int32)
        msk = np.zeros((1, bucket, K + 1), bool)
        toks[0, :T] = req.tokens
        msk[0, :T] = req.mask
        aid = 0
        if req.adapter is not None:
            if req.adapter not in self._adapter_id:
                raise ValueError(f"request {req.request_id}: unknown adapter {req.adapter!r} "
                                 f"(loaded: {sorted(self._adapter_id)})")
            aid = self._adapter_id[req.adapter]
        pf = self._prefill(bucket, pb)
        if pre is not None:
            pf.load_prefix(pre)
            self._load(pf.p_len, np.array([pre.length], np.int32))
        self._load(pf.tokens, toks)
        self._load(pf.mask, msk)
        self._load(pf.length, np.array([T], np.int32))
        self._load(pf.budget, np.array([req.max_frames], np.int32))
        self._load(pf.slot, np.array([slot], np.int64))
        self._load(pf.ids, np.array([aid], np.int64))
        self.temperature_t.fill_(self.temperature)
        torch.rand(tuple(pf.uniforms.shape), generator=self.gen, out=pf.uniforms)
        pf.run()
        self.prefill_calls[bucket] = self.prefill_calls.get(bucket, 0) + 1

        self._slot_adapter[slot] = aid
        self.slot_times[slot] = {"admit_s": time.perf_counter()}
        self._pos_host[slot] = (pre.length if pre is not None else 0) + T
        self._left[slot] = req.max_frames - 1
        self.slot_request[slot] = req
        self.slot_frames[slot] = []
        self.slot_streamed[slot] = 0
        self.active[slot] = True
        self.slot_gen[slot] += 1
        if req.max_frames < 1:  # no budget: finish empty, free the slot
            self._finished_at_submit.append(self._finish(slot))
        else:
            self._pending.append(slot)
        return slot

    def _dispatch(self) -> _InFlight:
        """Enqueue one chunk for the active slots (no host read): gather into
        the capacity's buffers when the live slots fill at most half the
        server, replay the step, scatter back, and queue the results'
        copy to the host.  The chunk is cut to the most frames any slot's
        budget still allows: where the JAX loop exits on the device once no
        row is live, a graph replay would run its whole step; a chunk of no
        step still reads liveness and the pending frame 0s."""
        self._prune_retired()
        pend, self._pending = self._pending, []
        live_idx = np.nonzero(self.active)[0]
        c = self._decode_capacity(len(live_idx))
        chunk = self.ramp_chunk if (pend and self.ramp_chunk) else self.chunk_size
        chunk = min(chunk, max(0, int(self._left[live_idx].max(initial=0))))
        self._left[live_idx] -= chunk
        ds = self._decode_step(c)
        self.temperature_t.fill_(self.temperature)
        if ds.idx is not None:
            ds.gather(live_idx)
            row_of = {int(s): i for i, s in enumerate(live_idx)}
        else:
            row_of = {int(s): int(s) for s in live_idx}
        ds.counts.zero_()
        ds.t.zero_()
        for _ in range(chunk):
            torch.rand(tuple(ds.uniforms.shape), generator=self.gen, out=ds.uniforms)
            ds.run()
        self.step_calls[c] = self.step_calls.get(c, 0) + chunk
        if ds.idx is not None:
            ds.scatter(len(live_idx))
        parts = [ds.frames[:chunk].reshape(-1), ds.counts, ds.slots.live.to(torch.int32)]
        if pend:
            rows = self._to_device(np.asarray(pend, np.int64)).to(self.device, non_blocking=True)
            parts.append(self.frame0.index_select(0, rows).reshape(-1))
        packed = torch.cat(parts)
        ready = None
        if self.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = packed
        gens = {int(s): int(self.slot_gen[s]) for s in live_idx}
        return _InFlight(host, ready, chunk, c, pend, live_idx, row_of, gens)

    def _collect(self, infl: _InFlight) -> List[StreamResult]:
        """Read a dispatched chunk's results (its one host transfer) and
        apply them to the host mirrors."""
        t0 = time.perf_counter()
        if infl.ready is not None:
            infl.ready.synchronize()
        self.read_wait_s += time.perf_counter() - t0
        a = infl.host.numpy()
        K, c, chunk = self.args.audio_num_codebooks, infl.capacity, infl.chunk
        n_f = chunk * c * K
        frames = a[:n_f].reshape(chunk, c, K)
        counts, live = a[n_f : n_f + c], a[n_f + c : n_f + 2 * c].astype(bool)
        f0s = a[n_f + 2 * c :].reshape(len(infl.pend), K)
        now = time.perf_counter()
        done: List[StreamResult] = []

        def current(s):
            return self.slot_request[s] is not None and self.slot_gen[s] == infl.gens[s]

        # deferred prefill frames land first; an all-zero frame 0 was EOS
        for s, f0 in zip(infl.pend, f0s):
            if current(s) and f0.any():
                self.slot_frames[s].append(f0.copy())
        for slot in infl.live_idx:
            s = int(slot)
            if not current(s):
                continue  # finished, cancelled or re-admitted since dispatch
            r = infl.row_of[s]
            self._pos_host[s] += int(counts[r])
            for t in range(int(counts[r])):
                self.slot_frames[s].append(frames[t, r].copy())
            if self.slot_frames[s]:
                self.slot_times[s].setdefault("first_frame_s", now)
            if not live[r]:
                done.append(self._finish(s))
            elif counts[r]:
                self._notify(s, done=False)
        return done

    def step(self) -> List[StreamResult]:
        """Advance every active stream by up to one chunk; returns the
        streams that finished.  Pipelined: dispatch chunk N+1, then read
        chunk N."""
        if self.window is not None:
            self._maybe_reanchor()
        done, self._finished_at_submit = self._finished_at_submit, []
        if not self.pipelined:
            if not self.active.any():
                return done
            return done + self._collect(self._dispatch())
        sync_ramp = bool(self._pending) and bool(self.ramp_chunk)
        if sync_ramp and self._inflight is not None:
            done += self._collect(self._inflight)
            self._inflight = None
        new = self._dispatch() if self.active.any() else None
        if sync_ramp and new is not None:
            done += self._collect(new)
            new = None
        if self._inflight is not None:
            done += self._collect(self._inflight)
        self._inflight = new
        if self._inflight is not None and not self.active.any():
            # everything died in the chunk just read: drain the new one, so
            # no active slot means nothing in flight
            done += self._collect(self._inflight)
            self._inflight = None
        return done

    def _notify(self, slot: int, done: bool) -> None:
        """Push the frames not streamed yet to the request's ``on_frames``."""
        req = self.slot_request[slot]
        if req is None or req.on_frames is None:
            return
        frames = self.slot_frames[slot]
        start = int(self.slot_streamed[slot])
        new = (np.stack(frames[start:]) if len(frames) > start
               else np.zeros((0, self.args.audio_num_codebooks), np.int32))
        self.slot_streamed[slot] = len(frames)
        req.on_frames(req.request_id, new, done)

    def _finish(self, slot: int, cancelled: bool = False) -> StreamResult:
        req = self.slot_request[slot]
        self._notify(slot, done=True)
        frames = (np.stack(self.slot_frames[slot]) if self.slot_frames[slot]
                  else np.zeros((0, self.args.audio_num_codebooks), np.int32))
        times = dict(self.slot_times[slot], done_s=time.perf_counter())
        res = StreamResult(req.request_id, frames, len(self.slot_frames[slot]), cancelled, times)
        self.active[slot] = False
        self.slot_request[slot] = None
        self.slot_frames[slot] = []
        return res

    def cancel(self, request_id) -> Optional[StreamResult]:
        """Abort an active request: its slot goes dead on the device and
        frees for the next admission; ``on_frames`` fires ``done=True``
        once and the partial result comes back here with
        ``cancelled=True`` (not through ``step()``).  None when no active
        slot carries ``request_id``.  A pipelined server first reads the
        chunk in flight; a request that finished in it is no longer
        cancellable and comes back through the next ``step()``."""
        if self._inflight is not None:
            self._finished_at_submit.extend(self._collect(self._inflight))
            self._inflight = None
        for slot in np.nonzero(self.active)[0]:
            s = int(slot)
            req = self.slot_request[s]
            if req is not None and req.request_id == request_id:
                self.slots.live[s] = False
                self.slots.remaining[s] = 0
                if s in self._pending:  # its frame 0 is never emitted
                    self._pending.remove(s)
                return self._finish(s, cancelled=True)
        return None

    def run(self, requests: List[StreamRequest], max_steps: int = 10_000):
        """Serve a request list to completion; returns (results, stats).
        ``stats["requests"]`` maps each request id to the seconds from the
        start of the run to its admission, its first frame on the host and
        its finish (``admit_s``, ``first_frame_s``, ``done_s``);
        ``stats["read_wait_s"]`` is the host's time blocked on chunk
        results (the rest of ``wall_s`` is host work)."""
        pending = list(requests)
        results: List[StreamResult] = []
        t0 = time.perf_counter()
        wait0 = self.read_wait_s
        steps = 0
        step_wall: List[float] = []  # per-chunk wall times
        while (pending or self.active.any()) and steps < max_steps:
            while pending and self.submit(pending[0]) is not None:
                pending.pop(0)
            ts = time.perf_counter()
            results.extend(self.step())
            step_wall.append(time.perf_counter() - ts)
            steps += 1
        wall = time.perf_counter() - t0
        total_frames = sum(r.n_steps for r in results)
        stats = {
            "wall_s": wall,
            "decode_steps": steps,
            "total_frames": total_frames,
            "frames_per_s": total_frames / max(wall, 1e-9),
            "aggregate_rtf": total_frames / 12.5 / max(wall, 1e-9),
            "step_wall": step_wall,
            "read_wait_s": self.read_wait_s - wait0,
            "requests": {r.request_id: {k: v - t0 for k, v in r.times.items()} for r in results},
        }
        return results, stats


def _quantized(params: dict, weight_dtype: str) -> dict:
    """The tree at ``weight_dtype``; a tree already quantized that way is
    kept."""
    if weight_dtype == "bf16":
        return params
    comp = "decoder" if weight_dtype == "int8-decoder" else "backbone"
    tp = params[comp]
    probe = tp["wqkv"] if "wqkv" in tp else tp["wq"]
    if weight_dtype == "int4":
        return params if qz.is_quantized_int4(probe) else qz.quantize_csm_params_int4(params)
    if qz.is_quantized(probe):
        return params
    comps = ("decoder",) if weight_dtype == "int8-decoder" else ("backbone", "decoder")
    return qz.quantize_csm_params(params, components=comps)
