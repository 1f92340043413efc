"""``csm-torch-serve`` — serving over the continuous-batching server.

The port of the JAX package's ``csm-serve``: requests served through one
``BatchedServer`` (csm_torch/serving.py), each finished request decoded by
Mimi and watermarked unless ``--no-watermark``.  Three ways in:

  * ``--requests FILE``: a JSONL file, one wav per request and a stats line;
  * ``--requests - --follow``: a stdin daemon that admits lines as they
    arrive, writes each wav when its request finishes and exits at EOF once
    everything drains (a line ``{"cancel": ID}`` aborts a request,
    ``{"register_prefix": {"name", "path"[, "adapter"]}}`` and
    ``{"unregister_prefix": NAME}`` change the presets,
    ``{"load_adapter": {"name", "path"}}`` and ``{"unload_adapter": NAME}``
    the LoRA adapters);
  * ``--http [HOST:]PORT``: ``POST /generate`` (a request line's JSON)
    answers ``audio/wav``, ``GET /health`` and ``GET /metrics`` give the
    stats (``/health`` lists the adapters and prefixes), ``POST /prefixes``
    and ``POST /adapters`` change the presets and the adapters (``{"name",
    "path"}`` loads, ``{"name", "unload": true}`` unloads), ``POST
    /shutdown`` drains and exits; past ``--http-queue`` waiting requests a POST gets
    503 at once.  Only the main thread touches the card: handler threads
    queue their request and wait.

``--stream``: each request's frames go through a streaming Mimi decoder of
its own (carried codec state, one ``--chunk-size`` block at a time, on the
main thread, as the chunks arrive), so its audio is ready as it decodes:
``--requests`` and ``--follow`` write its wav the moment it finishes and
print its first-audio time (from the start of the run, or from the line's
arrival); ``--http`` answers ``POST /generate`` with s16le PCM
(``audio/L16``, close-delimited) as the chunks decode.  The watermark is
skipped (it works on whole utterances).

``--prefix NAME=FILE.json`` registers a voice preset at startup (its
context audio Mimi-encoded and run through the backbone once); a request
naming it carries only its own text.  ``--window N`` serves sessions of
any length over an N-column sliding-window cache.  ``--device`` picks the
card (the default) or the CPU; ``--tiny-test`` runs a tiny random model and
codec.  ``--adapter NAME=PATH`` (repeatable) loads LoRA adapters into the
server's bank, and a request picks one by name in its ``adapter`` field
(none: the base model); ``--lora-path`` merges one adapter into the weights
at load.

Request lines: {"id": str|int, "text": "...", "speaker": 0,
                "max_audio_length_ms": 10000,
                "context": [{"audio": "path.wav", "text": "...", "speaker": 1}, ...],
                "prefix": "voice-a", "adapter": "speaker-a"}

    python -m csm_torch.cli.serve --requests reqs.jsonl --output-dir out/ \\
        --model-path ckpt.pt --mimi-path model.safetensors --n-slots 16
    python -m csm_torch.cli.serve --http 127.0.0.1:8000 --warmup --prefix warm=voice.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from csm_torch.cli.common import add_device_flag, add_tiny_test_flag, build_generator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve CSM TTS requests (PyTorch/CUDA)")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--flavor", choices=("1b", "8b", "tiny"), default="1b",
                   help="Model shape of --model-path: 1b (default), 8b (loads quantized a "
                        "few layers at a time: needs --weight-dtype int8 or int4), or tiny")
    p.add_argument("--mimi-path", type=str, default=None)
    p.add_argument("--adapter", action="append", default=None, metavar="NAME=PATH",
                   help="Load a LoRA adapter directory under NAME (repeatable): multi-LoRA "
                        "serving, requests pick one in their 'adapter' field (omitted: the "
                        "base model); one server serves every speaker's fine-tune")
    p.add_argument("--lora-path", type=str, default=None,
                   help="LoRA adapter directory merged into the weights at load (serve one "
                        "fine-tune from the adapter-only artifact)")
    p.add_argument("--prefix", action="append", default=None, metavar="NAME=FILE.json",
                   help="Register a shared context prefix (repeatable): FILE.json holds "
                        "{\"context\": [{audio, text, speaker}, ...]} (or a bare list), run "
                        "through the backbone once at startup; requests name it in their "
                        "'prefix' field and carry only their own text")
    p.add_argument("--requests", type=str, default=None,
                   help="JSONL file of requests ('-' = stdin, with --follow); required "
                        "unless --http")
    p.add_argument("--output-dir", type=str, default="served")
    p.add_argument("--n-slots", type=int, default=8, help="Concurrent decode slots")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--window", type=int, default=None,
                   help="Sliding-window KV of this many columns for sessions of any length: "
                        "each stream keeps its prompt and writes its frames round a ring over "
                        "the rest; max_audio_length_ms is not capped by --max-seq-len")
    p.add_argument("--chunk-size", type=int, default=8, help="Decode frames per host round trip")
    p.add_argument("--ramp-chunk", type=int, default=None,
                   help="Short decode chunk (< chunk-size) for the step right after an admission")
    p.add_argument("--pipelined", action=argparse.BooleanOptionalAction, default=True,
                   help="Keep one decode chunk in flight (on by default)")
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16")
    p.add_argument("--weight-dtype", choices=("bf16", "int8", "int8-decoder", "int4", "auto"),
                   default="bf16")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--seed", type=int, default=0, help="Sampling RNG seed")
    p.add_argument("--no-watermark", action="store_true")
    p.add_argument("--watermark-ckpt", type=str, default=None)
    p.add_argument("--follow", action="store_true",
                   help="Daemon (with --requests -): admit JSONL requests from stdin as they "
                        "arrive, write each wav when its request finishes, exit at EOF once "
                        "everything drains")
    p.add_argument("--http", type=str, default=None, metavar="[HOST:]PORT",
                   help="HTTP daemon: POST /generate (a request line's JSON) answers audio/wav; "
                        "GET /health, GET /metrics, POST /prefixes, POST /adapters, "
                        "POST /shutdown. Default host "
                        "127.0.0.1; port 0 takes a free one (printed)")
    p.add_argument("--http-queue", type=int, default=64,
                   help="Requests waiting for a slot beyond which a POST /generate gets an "
                        "immediate 503 (0: no bound)")
    p.add_argument("--warmup", action="store_true",
                   help="Run (on a card: capture) every serving function, registered prefixes "
                        "included, before the requests")
    p.add_argument("--stream", action="store_true",
                   help="Per-request audio streaming: each request's frames are Mimi-decoded "
                        "as its chunks arrive (carried codec state); its wav is written when it "
                        "finishes, with its first-audio time (--http: s16le PCM as it decodes). "
                        "The watermark is skipped")
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def load_requests(path: str) -> list:
    f = sys.stdin if path == "-" else open(path)
    try:
        return [json.loads(line) for line in f if line.strip()]
    finally:
        if f is not sys.stdin:
            f.close()


def parse_adapters(specs):
    """``--adapter`` NAME=PATH specs → {name: path}; None when a spec has
    no '='."""
    out = {}
    for spec in specs or ():
        if "=" not in spec:
            return None
        name, path = spec.split("=", 1)
        out[name] = path
    return out


def _adapter_op(server, kind, spec, register_prefix_file):
    """A hot change of the adapters or the presets: ``kind`` "adapter" or
    "prefix", ``spec`` {"name", "path"[, "adapter"]} or {"name", "unload":
    true}.  Returns the JSON answer."""
    name = spec["name"]
    if spec.get("unload"):
        (server.remove_adapter if kind == "adapter" else server.unregister_prefix)(name)
        return {"status": "unloaded", "name": name}
    if kind == "adapter":
        return {"status": "loaded", "name": name, "id": server.add_adapter(name, spec["path"])}
    pre = register_prefix_file(name, spec["path"], spec.get("adapter"))
    return {"status": "loaded", "name": name, "frames": pre.length, "bucket": pre.bucket}


class _ChunkedDecodeSink:
    """A request's ``on_frames``: buffer its frames and send each full
    ``chunk``-frame block through its own streaming Mimi decoder
    (codec/streaming.py) as soon as it is there, the last block padded to
    ``chunk`` frames (one codec shape), without waiting for the card
    (``decode_chunk_async``); each block's samples go to ``_emit`` with the
    count to keep.  Called on the serving thread."""

    def __init__(self, decoder, chunk: int):
        self.decoder, self.chunk = decoder, max(1, chunk)
        self.frames: list = []  # (K,) frames
        self.decoded = 0

    def _decode(self, n: int, pad_to=None) -> None:
        block = np.stack(self.frames[self.decoded : self.decoded + n])
        if pad_to and block.shape[0] < pad_to:  # the last block only
            block = np.concatenate([block, np.zeros((pad_to - n, block.shape[1]), block.dtype)])
        audio = self.decoder.decode_chunk_async(block.T)
        self.decoded += n
        self._emit(audio, n * self.decoder.cfg.samples_per_frame)

    def _emit(self, device_audio, keep: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _finish(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, rid, new, done: bool) -> None:
        self.frames.extend(new)
        while len(self.frames) - self.decoded >= self.chunk:
            self._decode(self.chunk)
        if done:
            rem = len(self.frames) - self.decoded
            if rem:
                self._decode(rem, pad_to=self.chunk)
            self._finish()


class _StreamSink(_ChunkedDecodeSink):
    """``--stream`` to disk: keep the decoded blocks, wait for the card on
    the first only (to time first audio), and write the wav when the
    request finishes.  Times are seconds after ``t0`` (perf_counter)."""

    def __init__(self, decoder, chunk: int, out_path: str, sample_rate: int, t0: float):
        super().__init__(decoder, chunk)
        self.out_path, self.sample_rate, self.t0 = out_path, sample_rate, t0
        self.audio: list = []  # (device samples, count to keep)
        self.first_audio_s = self.done_s = None

    def _emit(self, device_audio, keep: int) -> None:
        self.audio.append((device_audio, keep))
        if self.first_audio_s is None:
            if device_audio.is_cuda:
                ev = torch.cuda.Event()
                ev.record()
                ev.synchronize()
            self.first_audio_s = time.perf_counter() - self.t0

    def _finish(self) -> None:
        from csm_torch.data.audio import save_wav

        self.done_s = time.perf_counter() - self.t0
        audio = (np.concatenate([a[:keep].float().cpu().numpy() for a, keep in self.audio])
                 if self.audio else np.zeros(0, np.float32))
        save_wav(self.out_path, audio, self.sample_rate)


class _HttpStreamSink(_ChunkedDecodeSink):
    """``--http --stream``: each decoded block is copied to pinned host
    memory without waiting (an event marks the copy's end); ``pump``, on
    the main thread, hands the blocks that have landed, in order, to the
    request's handler thread as s16le PCM on ``q``, then None once the
    request has finished.  The end is passed on by the drive loop's pump,
    after the step that finished the request has been counted, so a client
    that has read its whole answer finds it in ``/health``.  The handler
    thread only writes bytes: it makes no CUDA call, which would fail under
    a graph captured meanwhile."""

    def __init__(self, decoder, chunk: int):
        import queue

        super().__init__(decoder, chunk)
        self.q: "queue.Queue" = queue.Queue()
        self._copies: list = []  # (host samples, event or None), oldest first
        self._closed = self.ended = False

    def _emit(self, device_audio, keep: int) -> None:
        audio = device_audio[:keep]
        ev = None
        if audio.is_cuda:
            host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
            host.copy_(audio, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            audio = host
        self._copies.append((audio, ev))
        self.pump()

    def _finish(self) -> None:
        self._closed = True

    def pump(self) -> bool:
        """Main thread: pass on every block whose copy has landed, in order,
        and the end after the last; True once the end has been passed on."""
        while self._copies and (self._copies[0][1] is None or self._copies[0][1].query()):
            self.q.put(self.to_pcm(self._copies.pop(0)[0]))
        if self._closed and not self._copies and not self.ended:
            self.q.put(None)
            self.ended = True
        return self.ended

    @staticmethod
    def to_pcm(audio) -> bytes:
        """Float samples in [-1, 1] (host) → s16le bytes, as ``wav_bytes``
        writes them."""
        a = np.asarray(audio, np.float32).reshape(-1)
        return np.clip(a * 32767.0, -32768, 32767).astype("<i2").tobytes()


class _StdinPoller:
    """The complete lines stdin holds right now, without blocking.

    Reads the raw fd with ``os.read``: a buffered ``readline`` would keep
    the lines after the first of a multi-line write where ``select`` cannot
    see them, and would block on a partial line.  A partial line waits in
    ``buf`` for its newline, or for EOF."""

    def __init__(self, fd: int = 0):
        self.fd = fd
        self.buf = b""
        self.eof = False

    def poll(self):
        """Returns (lines, eof)."""
        import select

        while not self.eof and select.select([self.fd], [], [], 0.0)[0]:
            chunk = os.read(self.fd, 65536)
            if chunk == b"":
                self.eof = True
                break
            self.buf += chunk
        *complete, rest = self.buf.split(b"\n")
        if self.eof and rest:
            complete.append(rest)  # an unterminated last line
            rest = b""
        self.buf = rest
        lines = [raw.decode("utf-8", errors="replace").strip() for raw in complete]
        return [ln for ln in lines if ln], self.eof


def _serve_follow(server, to_stream_request, emit_result, register_prefix_file,
                  attach_sink=None, drop_sink=None):
    """The stdin daemon: poll for JSONL lines, admit requests at chunk
    boundaries, emit each result as it finishes; at EOF, exit once nothing
    is pending or active.  ``attach_sink(request, t_arrival)`` (``--stream``)
    gives a request its streaming sink when its line arrives; a request
    dropped at submit closes its sink and ``drop_sink(request_id)`` releases
    it.  Returns (served, frames, wall seconds)."""
    pending = []
    n_served = total_frames = n_seen = 0
    in_flight = set()  # request ids: two in flight with one id would share a wav path
    poller = _StdinPoller()
    eof = False
    t0 = time.time()
    while True:
        if not eof:
            lines, eof = poller.poll()
            for line in lines:
                try:
                    r = json.loads(line)
                except ValueError as e:
                    print(f"  bad request line skipped: {e}", file=sys.stderr)
                    continue
                ops = {"register_prefix": ("prefix", False), "unregister_prefix": ("prefix", True),
                       "load_adapter": ("adapter", False), "unload_adapter": ("adapter", True)}
                op = next((k for k in ops if isinstance(r, dict) and k in r), None)
                if op is not None:
                    kind, unload = ops[op]
                    try:
                        spec = {"name": r[op], "unload": True} if unload else r[op]
                        ans = _adapter_op(server, kind, spec, register_prefix_file)
                        print(f"  {kind} {ans['name']!r} {ans['status']}"
                              + (f" (id {ans['id']})" if "id" in ans else ""), file=sys.stderr)
                    except Exception as e:  # the daemon outlives a bad spec
                        print(f"  {kind} op failed: {e!r}", file=sys.stderr)
                    continue
                if isinstance(r, dict) and "cancel" in r:
                    cid = r["cancel"]
                    waiting = [p for p in pending if p.request_id == cid]
                    pending = [p for p in pending if p.request_id != cid]
                    for sr in waiting:  # never admitted: close and release its sink
                        if sr.on_frames is not None:
                            sr.on_frames(cid, np.zeros((0, 0), np.int32), True)
                            if drop_sink is not None:
                                drop_sink(cid)
                    res = server.cancel(cid)
                    if res is not None or waiting:
                        in_flight.discard(cid)
                        if res is not None:
                            emit_result(res)  # its partial wav
                        print(f"  cancelled {cid!r}" + (f" after {res.n_steps} frames" if res
                                                        else " (not yet admitted)"),
                              file=sys.stderr)
                    else:
                        print(f"  cancel {cid!r}: not in flight", file=sys.stderr)
                    continue
                try:
                    sr = to_stream_request(n_seen, r)
                except Exception as e:  # the daemon outlives a malformed request
                    rid = r.get("id", n_seen) if isinstance(r, dict) else n_seen
                    print(f"  bad request {rid!r} skipped: {e!r}", file=sys.stderr)
                    sr = None
                n_seen += 1
                if sr is None:
                    continue
                if sr.request_id in in_flight:
                    print(f"  duplicate in-flight id {sr.request_id!r} rejected", file=sys.stderr)
                    continue
                in_flight.add(sr.request_id)
                if attach_sink is not None:
                    attach_sink(sr, time.perf_counter())  # first audio from the arrival
                pending.append(sr)
        while pending:
            try:
                if server.submit(pending[0]) is None:
                    break  # no free slot: next tick
            except ValueError as e:  # e.g. its prefix was unregistered while it waited
                sr = pending.pop(0)
                in_flight.discard(sr.request_id)
                print(f"  request {sr.request_id!r} dropped at submit: {e}", file=sys.stderr)
                if sr.on_frames is not None:  # close its sink, then release it
                    sr.on_frames(sr.request_id, np.zeros((0, 0), np.int32), True)
                    if drop_sink is not None:
                        drop_sink(sr.request_id)
                continue
            pending.pop(0)
        for res in server.step():
            emit_result(res)
            in_flight.discard(res.request_id)
            n_served += 1
            total_frames += res.n_steps
        if not server.active.any() and not pending:
            if eof:
                break
            time.sleep(0.02)  # nothing to decode: wait for stdin
    return n_served, total_frames, time.time() - t0


def _make_http_handler(server, inbox, stop, stats_box, cancel_q=None, sample_rate=24_000):
    """The request handler class of ``_serve_http``.  Handler threads only
    parse, queue and wait: the main thread serves.  A full ``inbox`` (the
    ``--http-queue`` bound) answers 503 at once.  A streamed request
    (``pcm_queue`` in its holder) is answered with the PCM bytes the main
    thread queues, close-delimited; a client that hangs up has its request
    id put on ``cancel_q``."""
    import queue
    import threading
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        timeout = 120  # socket timeout: a stalled client cannot pin a thread
        max_body = 16 * 1024 * 1024  # request JSON (context audio is paths)

        def log_message(self, fmt, *a):
            pass

        def _json_reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", "0"))
            if not 0 <= n <= self.max_body:
                raise OverflowError("body too large")
            req = json.loads(self.rfile.read(n))
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            return req

        def do_GET(self):
            if self.path == "/metrics":  # Prometheus text exposition
                lines = []
                for name, typ, val in (
                    ("csm_serve_slots", "gauge", server.n_slots),
                    ("csm_serve_active_slots", "gauge", int(server.active.sum())),
                    ("csm_serve_queue_depth", "gauge", inbox.qsize()),
                    ("csm_serve_requests_total", "counter", stats_box.get("served", 0)),
                    ("csm_serve_frames_total", "counter", stats_box.get("frames", 0)),
                    ("csm_serve_uptime_seconds", "gauge",
                     time.time() - stats_box.get("t0", time.time())),
                ):
                    lines += [f"# TYPE {name} {typ}", f"{name} {val}"]
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/health":
                return self._json_reply(404, {"error": "GET /health or /metrics"})
            self._json_reply(200, {
                "status": "ok", "n_slots": server.n_slots, "active": int(server.active.sum()),
                "adapters": sorted(server._adapter_id), "prefixes": sorted(server._prefixes),
                **{k: v for k, v in stats_box.items() if k != "t0"},
            })

        def do_POST(self):
            if self.path == "/shutdown":
                stop.set()
                return self._json_reply(200, {"status": "shutting down"})
            if self.path not in ("/generate", "/prefixes", "/adapters"):
                return self._json_reply(404, {"error": "POST /generate, /prefixes, /adapters "
                                                       "or /shutdown"})
            try:
                req = self._body()
            except OverflowError as e:
                return self._json_reply(413, {"error": str(e)})
            except (ValueError, OSError) as e:
                return self._json_reply(400, {"error": f"bad request: {e}"})
            done, holder = threading.Event(), {}
            if self.path in ("/prefixes", "/adapters"):
                # {"name", "path"} loads, {"name", "unload": true} unloads: on the main thread
                if "name" not in req:
                    return self._json_reply(400, {"error": 'body must be {"name", "path"} or '
                                                           '{"name", "unload": true}'})
                kind = "prefix" if self.path == "/prefixes" else "adapter"
                inbox.put(((kind, req), done, holder))
                done.wait()
                return self._json_reply(400 if "error" in holder else 200,
                                        holder.get("json", holder))
            try:
                inbox.put_nowait((req, done, holder))
            except queue.Full:  # backpressure: the bounded admission queue
                return self._json_reply(503, {"error": "server overloaded, retry later"})
            done.wait()
            if "error" in holder:
                return self._json_reply(400, {"error": holder["error"]})
            if "pcm_queue" in holder:  # --stream: s16le PCM as it decodes
                self.send_response(200)
                self.send_header("Content-Type", f"audio/L16;rate={sample_rate};channels=1")
                self.end_headers()
                q = holder["pcm_queue"]
                while True:
                    pcm = q.get()
                    if pcm is None:
                        break
                    try:
                        self.wfile.write(pcm)
                        self.wfile.flush()
                    except OSError:  # the client hung up: free its slot
                        if cancel_q is not None:
                            cancel_q.put(holder.get("request_id"))
                        return
                self.close_connection = True
                return
            wav = holder["wav"]
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(wav)))
            self.send_header("X-Frames", str(holder["frames"]))
            self.end_headers()
            self.wfile.write(wav)

    return Handler


def _serve_http(address, queue_bound, server, to_stream_request, finish_audio,
                register_prefix_file, make_stream_sink=None, sample_rate=24_000):
    """The HTTP daemon.  Handler threads queue each request and wait on its
    event; the main thread alone drives the server (admits at chunk
    boundaries, decodes, turns each finished request into wav bytes) and
    fulfils the waiters, so concurrent POSTs decode together.  With
    ``make_stream_sink`` (``--stream``) each request gets a sink whose PCM
    its handler writes as it comes; the main thread pumps the sinks every
    tick, and a client that hangs up has its request cancelled.  SIGTERM,
    SIGINT and POST /shutdown drain what is in flight, then return.  If the
    drive loop dies, every waiting handler is answered before the exception
    propagates.  Returns (served, frames, wall seconds)."""
    import queue
    import signal
    import threading
    from http.server import ThreadingHTTPServer

    host, _, port = address.rpartition(":")
    inbox: "queue.Queue" = queue.Queue(maxsize=queue_bound)
    stop = threading.Event()
    stats_box = {"served": 0, "frames": 0, "t0": time.time()}
    cancel_q: "queue.Queue" = queue.Queue()
    httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)),
                                _make_http_handler(server, inbox, stop, stats_box, cancel_q,
                                                   sample_rate))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def drain(signum, frame):
        print(f"signal {signum}: draining in-flight requests...", flush=True)
        stop.set()

    prev = {s: signal.signal(s, drain) for s in (signal.SIGTERM, signal.SIGINT)}
    bound_host, bound_port = httpd.server_address[:2]
    print(f"Serving on http://{bound_host}:{bound_port} (POST /generate, GET /health, "
          f"GET /metrics, POST /prefixes, POST /adapters, POST /shutdown; SIGTERM drains)",
          flush=True)
    waiters = {}  # request id -> (done event, holder)
    sinks = {}  # request id -> streaming sink whose end has not been passed on
    pending = []
    n_seen = 0
    t0 = time.time()

    def admit(req, done, holder):
        nonlocal n_seen
        if isinstance(req, tuple):  # ("prefix" | "adapter", spec)
            try:
                holder["json"] = _adapter_op(server, req[0], req[1], register_prefix_file)
            except Exception as e:  # network-facing: the daemon outlives a bad spec
                holder["error"] = repr(e)
            done.set()
            return
        try:
            sr = to_stream_request(n_seen, req)
            if sr is None:
                holder["error"] = "request rejected (see the server log)"
        except Exception as e:  # network-facing: the daemon outlives a malformed request
            holder["error"] = repr(e)
            sr = None
        if sr is None:
            done.set()
        else:
            sr.request_id = n_seen  # a key of its own, whatever id the client gave
            holder["request_id"] = n_seen  # what a hung-up handler cancels
            if make_stream_sink is not None:
                sink = sinks[n_seen] = make_stream_sink()
                sr.on_frames = sink
                holder["pcm_queue"] = sink.q
                done.set()  # the handler starts its response now
            waiters[n_seen] = (done, holder)
            pending.append(sr)
        n_seen += 1

    def busy():
        return bool(pending or server.active.any() or sinks)

    try:
        while not (stop.is_set() and not busy() and inbox.empty()):
            try:
                # wait briefly for an arrival, then drain the inbox: k clients at
                # once admit into one decode, not one a chunk
                admit(*inbox.get(timeout=0.02 if busy() else 0.25))
                while True:
                    admit(*inbox.get_nowait())
            except queue.Empty:
                pass
            while True:  # hung-up stream clients: no decode for an audience of none
                try:
                    rid = cancel_q.get_nowait()
                except queue.Empty:
                    break
                if rid in waiters:
                    pending[:] = [p for p in pending if p.request_id != rid]
                    server.cancel(rid)  # None when it was still pending
                    waiters.pop(rid)
                    sinks.pop(rid, None)
                    stats_box["cancelled"] = stats_box.get("cancelled", 0) + 1
            while pending:
                try:
                    if server.submit(pending[0]) is None:
                        break  # no free slot: next tick
                except ValueError as e:  # e.g. its prefix was dropped while it waited
                    sr = pending.pop(0)
                    done, holder = waiters.pop(sr.request_id)
                    if sr.on_frames is not None:  # its response has begun: end it
                        sr.on_frames(sr.request_id, np.zeros((0, 0), np.int32), True)
                    holder["error"] = str(e)
                    done.set()
                    continue
                pending.pop(0)
            for res in server.step():
                done, holder = waiters.pop(res.request_id)
                if "pcm_queue" not in holder:  # a streamed one has had its audio
                    holder["wav"] = finish_audio(res)
                    holder["frames"] = res.frames.shape[0]
                    done.set()
                stats_box["served"] += 1
                stats_box["frames"] += res.frames.shape[0]
            for rid in [rid for rid, sink in sinks.items() if sink.pump()]:
                del sinks[rid]
    finally:
        for done, holder in waiters.values():
            if "pcm_queue" in holder:  # its handler waits on the queue
                holder["pcm_queue"].put(None)
            if not done.is_set():
                holder.setdefault("error", "server loop terminated")
                done.set()
        waiters.clear()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        for s, h in prev.items():
            signal.signal(s, h)
        # a request that reached the inbox after the last check is answered, not left hanging
        while True:
            try:
                _, done, holder = inbox.get_nowait()
            except queue.Empty:
                break
            holder["error"] = "server shutting down"
            done.set()
    return stats_box["served"], stats_box["frames"], time.time() - t0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    adapters = parse_adapters(args.adapter)
    if adapters is None:
        print(f"--adapter must be NAME=PATH, got {args.adapter}", file=sys.stderr)
        return 2
    raw = []
    if args.http:
        if args.follow or args.requests is not None:
            print("--http takes its requests over HTTP: no --follow, no --requests",
                  file=sys.stderr)
            return 2
        print(f"Loading model... (--http {args.http})")
    elif args.follow:
        if args.requests != "-":
            print("--follow requires --requests - (stdin)", file=sys.stderr)
            return 2
        print("Loading model... (--follow: requests from stdin)")
    elif args.requests is None:
        print("--requests is required (or --http)", file=sys.stderr)
        return 2
    else:
        raw = load_requests(args.requests)
        if not raw:
            print("no requests", file=sys.stderr)
            return 1
        print(f"Loading model... ({len(raw)} requests)")
    from csm_torch.data import frames as fr
    from csm_torch.data.audio import load_audio, save_wav, wav_bytes
    from csm_torch.generator import MS_PER_FRAME, Segment
    from csm_torch.models.generation import PROMPT_BUCKETS, bucket_length
    from csm_torch.serving import BatchedServer, StreamRequest

    t0 = time.time()
    # the weights load at the server's dtype (the 8B flavor can only load
    # quantized); the server keeps a tree that is quantized already
    wd = args.weight_dtype
    args.int4, args.int8, args.int8_decoder = wd == "int4", wd in ("int8", "auto"), wd == "int8-decoder"
    args.kv_int8 = False  # the server's own cache: --kv-dtype
    generator = build_generator(args)
    if args.tiny_test:
        args.max_seq_len = min(args.max_seq_len, generator.max_seq_len)
    wmark = None
    if not args.no_watermark:
        from csm_torch.watermarking import load_watermarker, watermark

        w = load_watermarker(args.watermark_ckpt, device=generator.device)
        wmark = lambda audio, sr: watermark(w, audio, sr)  # noqa: E731
    print(f"Model ready in {time.time() - t0:.1f}s")
    cache_len = args.window or args.max_seq_len

    def segments(ctx):
        return [Segment(speaker=int(c["speaker"]), text=c["text"],
                        audio=load_audio(c["audio"], generator.sample_rate)) for c in ctx]

    def to_stream_request(i, r):
        rid = r.get("id", i)
        prefix, pb = r.get("prefix"), 0
        if prefix is not None:
            pre = server._prefixes.get(prefix)
            if pre is None:  # refused here, not by the drive loop's submit
                print(f"  skipping {rid}: unknown prefix {prefix!r} (registered: "
                      f"{sorted(server._prefixes)})", file=sys.stderr)
                return None
            pb = pre.bucket
        adapter = r.get("adapter")
        if adapter is not None and adapter not in server._adapter_id:
            # refused here: a submit that raises in the drive loop drops it later
            print(f"  skipping {rid}: unknown adapter {adapter!r} (loaded: "
                  f"{sorted(server._adapter_id)})", file=sys.stderr)
            return None
        # with a prefix the request's own frames are its extra context and text
        tokens, mask = generator._build_prompt(r["text"], int(r.get("speaker", 0)),
                                               segments(r.get("context", [])))
        try:  # the server's checks, on the prompt's bucket
            bucket = bucket_length(tokens.shape[0],
                                   tuple(b for b in PROMPT_BUCKETS if b <= cache_len))
        except ValueError:
            bucket = cache_len
        budget = int(float(r.get("max_audio_length_ms", 10_000)) / MS_PER_FRAME)
        if args.window is not None:  # the ring evicts: the budget is not capped
            if pb + bucket + 2 * args.chunk_size + 2 > args.window:
                print(f"  skipping {rid}: prompt ({tokens.shape[0]} frames, bucket "
                      f"{pb + bucket} with its prefix) leaves no decode ring in window "
                      f"{args.window}", file=sys.stderr)
                return None
            max_frames = max(1, budget)
        else:
            if pb + bucket + 1 > args.max_seq_len:
                print(f"  skipping {rid}: prompt ({tokens.shape[0]} frames, bucket "
                      f"{pb + bucket} with its prefix) leaves no room in max_seq_len "
                      f"{args.max_seq_len}", file=sys.stderr)
                return None
            max_frames = max(1, min(budget, args.max_seq_len - pb - bucket))
        return StreamRequest(tokens, mask, max_frames=max_frames, request_id=rid, prefix=prefix,
                             adapter=adapter)

    ramp_chunk = args.ramp_chunk
    if ramp_chunk is None and (args.stream or args.http) and args.chunk_size > 2:
        ramp_chunk = 2  # a listener waits for its first audio: a short first chunk
    server = BatchedServer(
        generator.params, generator.args, n_slots=args.n_slots, max_seq_len=args.max_seq_len,
        temperature=args.temperature, topk=args.topk, compute_dtype=generator.compute_dtype,
        chunk_size=args.chunk_size, ramp_chunk=ramp_chunk, weight_dtype=wd,
        kv_dtype=args.kv_dtype, pipelined=args.pipelined, window=args.window,
        adapters=adapters or None, device=generator.device,
    )

    def register_prefix_file(name, path, adapter=None):
        """A preset's context file ({"context": [{audio, text, speaker}]}
        or a bare list), Mimi-encoded and registered under ``name`` (and
        ``adapter``)."""
        with open(path) as f:
            ctx = json.load(f)
        if isinstance(ctx, dict):
            ctx = ctx.get("context", [])
        t0p = time.time()
        tokens, mask = fr.concat_frames([generator._segment_frames(s) for s in segments(ctx)])
        pre = server.register_prefix(name, tokens, mask, adapter=adapter)
        print(f"  prefix {name!r}: {pre.length} frames (bucket {pre.bucket}) cached in "
              f"{time.time() - t0p:.2f}s", file=sys.stderr)
        return pre

    for spec in args.prefix or ():
        if "=" not in spec:
            print(f"--prefix must be NAME=FILE.json, got {spec!r}", file=sys.stderr)
            return 2
        register_prefix_file(*spec.split("=", 1))
    server.reset(args.seed)
    if args.warmup:
        print("Warming serving functions...", flush=True)
        print(f"Warmup done in {server.warmup(verbose=True):.1f}s", flush=True)
        server.reset(args.seed)

    if args.stream and wmark is not None:
        print("--stream: skipping the watermark (it works on whole utterances); watermark "
              "the written audio afterwards if needed", file=sys.stderr)
        wmark = None
    sinks = {}  # --stream: request id -> its sink, until its result is emitted

    def attach_sink(sr, t_ref):
        """A request's streaming decoder and wav writer; first audio counts
        from ``t_ref`` (the run's start, or the line's arrival)."""
        out = os.path.join(args.output_dir, f"{sr.request_id}.wav")
        sink = sinks[sr.request_id] = _StreamSink(generator.mimi.stream_decoder(),
                                                  args.chunk_size, out, generator.sample_rate,
                                                  t_ref)
        sr.on_frames = sink

    def finish_audio(res):
        """A result's wav samples: Mimi decode, then the watermark."""
        audio = (generator.mimi.decode(res.frames.T) if res.frames.shape[0]
                 else np.zeros(0, np.float32))
        if wmark is not None and audio.shape[0]:
            audio, _ = wmark(audio, generator.sample_rate)
        return audio

    def emit_result(res):
        out = os.path.join(args.output_dir, f"{res.request_id}.wav")
        n = res.frames.shape[0]
        if args.stream:  # its sink has written the wav; drop the sink and its state
            sink = sinks.pop(res.request_id)
            print(f"  {out}: {n} frames ({n * MS_PER_FRAME / 1000:.2f}s), first audio "
                  f"+{1e3 * (sink.first_audio_s or 0):.0f} ms, done +{sink.done_s or 0:.2f} s",
                  flush=True)
            return
        save_wav(out, finish_audio(res), generator.sample_rate)
        print(f"  {out}: {n} frames ({n * MS_PER_FRAME / 1000:.2f}s)", flush=True)

    if args.http:
        n_served, frames, wall = _serve_http(
            args.http, args.http_queue, server, to_stream_request,
            lambda res: wav_bytes(finish_audio(res), generator.sample_rate),
            register_prefix_file,
            make_stream_sink=(lambda: _HttpStreamSink(generator.mimi.stream_decoder(),
                                                      args.chunk_size)) if args.stream else None,
            sample_rate=generator.sample_rate)
        print(f"HTTP served {n_served} requests in {wall:.2f}s: {frames} frames "
              f"(weights {server.weight_dtype}, {args.n_slots} slots)")
        return 0
    os.makedirs(args.output_dir, exist_ok=True)
    if args.follow:
        n_served, frames, wall = _serve_follow(
            server, to_stream_request, emit_result, register_prefix_file,
            attach_sink=attach_sink if args.stream else None,
            drop_sink=lambda rid: sinks.pop(rid, None))
        print(f"Served {n_served} requests in {wall:.2f}s: {frames} frames, "
              f"{frames / max(wall, 1e-9):.1f} frames/s "
              f"(weights {server.weight_dtype}, {args.n_slots} slots)")
        return 0
    requests, seen = [], set()
    for i, r in enumerate(raw):
        sr = to_stream_request(i, r)
        if sr is None:
            continue
        if sr.request_id in seen:  # one wav path per id
            print(f"  duplicate id {sr.request_id!r} rejected", file=sys.stderr)
            continue
        seen.add(sr.request_id)
        requests.append(sr)
    if not requests:
        print("no servable requests", file=sys.stderr)
        return 1
    t0 = time.time()
    if args.stream:
        t_ref = time.perf_counter()  # first audio counts from the run's start
        for sr in requests:
            attach_sink(sr, t_ref)
    results, stats = server.run(requests)
    wall = time.time() - t0
    for res in results:
        emit_result(res)
    print(f"Served {len(results)} requests in {wall:.2f}s: {stats['total_frames']} frames, "
          f"{stats['frames_per_s']:.1f} frames/s decode, "
          f"aggregate RTF {stats['aggregate_rtf']:.2f} "
          f"(weights {server.weight_dtype}, {args.n_slots} slots)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
