# SPDX-License-Identifier: Apache-2.0
"""Dense multi-session streaming STT serving.

Port of ``streamkit_tpu/engine/stt_serving.py``. :class:`SttServingEngine`
serves N concurrent realtime speech-to-text sessions over one shared Whisper
model. Per VAD block and session:

* **C++** (:class:`~.ingest.IngestPool`): packet pacing, buffering and block
  assembly; the Python loop drains all sessions' blocks once per tick.
* **Device** (:meth:`~..models.whisper.streaming.StreamTable.
  identity_step_fn` through the :class:`~.batcher.DeviceBatcher`): segment
  open, VAD scoring, ring append, chunk-causal encode and decode
  continuation, fused into one batched call over every co-paced session.
  On a card that call launches the windowed-write and history-attention
  kernels.
* **Python** (here): the per-session segmentation state machine
  (:class:`~..nodes.ml.vad_node.SpeechSegmenter`), cursor planning for the
  fused step, and event emission.

Spans (when the process tracer is on, :mod:`..utils.tracing`): ``stt.session``
over each session worker's life, the parent of that session's
``stt.plan`` (planning and submitting a block's fused step),
``stt.finish`` (its segmenter and events) and ``stt.final_exact`` (an
exact-final ring decode's await); ``stt.drain`` over each drain iteration
that returned blocks, from the ingest pool's executor round trip through
routing. The fused call's own spans are the batcher's (``batcher.wait``,
``batcher.call``) and the step's (``stream.*``).

Finals come in two modes:

* ``final_mode="stream"``: the continuation decode has consumed the
  utterance and the VAD hangover; its newest tokens are the final.
* ``final_mode="exact"``: re-decode the segment with the exact bidirectional
  encoder (bucketed ring decode, the flash-attention kernel on a card). The
  session's worker awaits it inline.

On a ``(dp, tp)`` mesh (``mesh=``, :func:`..parallel.mesh.make_mesh`) the
engine is built on every rank of the group. Rank 0 owns the sessions, the
ingest pool and the :class:`~.batcher.DeviceBatcher`; every device call it
makes (the fused step, the exact-final ring decodes) goes out as one
broadcast of its name and host inputs, and the other ranks run the same call
on their shards in :meth:`SttServingEngine.follow` until rank 0 stops. A
row runs on the dp rank that owns its slot (every tp rank of that group runs
it); its outputs come back to rank 0 by an all-gather over dp
(:mod:`..parallel.serving`).

With ``resources=`` the model comes from a shared
:class:`~..core.resource_manager.ResourceManager` under the key the
:class:`~..nodes.ml.whisper_node.WhisperNode` uses (path, size, dtype,
device), so an engine and a node on one manager hold one model per device.
On a mesh the manager keeps the whole params; each rank shards its copy.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.resource_manager import ResourceKey, ResourceManager
from ..device import resolve_device
from ..models.whisper import WHISPER_CONFIGS, WhisperDetokenizer, load_pretrained, seeded_params
from ..models.whisper.config import language_index
from ..models.whisper.decode import transcribe_ring
from ..models.whisper.streaming import CHUNK_POS, CHUNK_SAMPLES, RIGHT_CTX, get_stream_table
from ..nodes.ml.vad_node import SpeechSegmenter
from ..ops.vad import VAD_FRAME
from ..utils.tracing import NOOP_SPAN, get_tracer, now_ns
from .audio_ring import get_audio_ring
from .batcher import DeviceBatcher
from .ingest import IngestPool

__all__ = ["SttServingEngine"]

logger = logging.getLogger(__name__)

_SR = 16_000


@dataclass
class _Session:
    sid: int
    vad_slot: int
    stream_id: int
    on_event: Callable[[dict], None]
    seg: SpeechSegmenter
    q: asyncio.Queue = field(default_factory=asyncio.Queue)
    worker: Optional[asyncio.Task] = None
    written: int = 0
    st_tip: int = 0
    st_pos: int = 0
    st_ready: bool = False
    st_last_dec: float = 0.0
    st_last_tok: Optional[tuple] = None
    pending_reset: bool = False
    seq: int = 0
    # the worker awaits an exact-final ring decode: it submits no stream
    # steps then and does not count toward the batch's `expected`
    awaiting_final: bool = False
    # the worker is between q.get and the item's completion; the drain loop
    # group-submits a block only when nothing is queued or processing
    # (per-session block order is the correctness contract)
    processing: bool = False
    # close_session was called: late blocks must not reach the device, since
    # the worker frees this session's ring and table slots on exit
    closing: bool = False
    # the worker's ``stt.session`` span: the parent of this session's block
    # spans wherever they run
    span: object = NOOP_SPAN


class SttServingEngine:
    """N realtime STT sessions over one shared model (module docstring).
    Runs on ``device`` (default ``cuda``), on one device or, with ``mesh``,
    on every rank of a ``(dp, tp)`` mesh."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        model_size: str = "tiny",
        language: str = "en",
        dtype: str = "bfloat16",
        max_sessions: int = 64,
        vad_block_frames: int = 8,
        vad_threshold: float = 0.5,
        min_silence_ms: float = 700.0,
        max_segment_secs: float = 30.0,
        partial_interval_ms: float = 250.0,
        final_mode: str = "stream",  # "stream" | "exact"
        window_buckets: Optional[List[float]] = None,  # exact-final buckets
        max_tokens: int = 32,
        batcher: Optional[DeviceBatcher] = None,
        resources: Optional[ResourceManager] = None,
        mesh=None,
        ingest_queue_cap: int = 4096,
        device=None,
    ) -> None:
        if final_mode not in ("stream", "exact"):
            raise ValueError(f"final_mode must be stream|exact, got {final_mode}")
        self.device = resolve_device(device)
        self.model_path = model_path
        self.model_size = model_size
        self.language = language
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.max_sessions = max_sessions
        self.vad_block = vad_block_frames
        self.block_samples = vad_block_frames * VAD_FRAME
        self.vad_threshold = vad_threshold
        self.min_silence_ms = min_silence_ms
        self.max_segment_secs = max_segment_secs
        self.partial_interval = partial_interval_ms / 1000.0
        self.final_mode = final_mode
        self.window_buckets = sorted(window_buckets or [4.0, 8.0, 30.0])
        self.max_tokens = max_tokens
        self.batcher = batcher or DeviceBatcher(tick_ms=float(os.environ.get("SK_STT_TICK_MS", "5")),
                                                device=self.device)
        self._own_batcher = batcher is None
        self.resources = resources
        # optional (dp, tp) DeviceMesh: weights tensor parallel, stream slots
        # over dp and heads over tp, audio-ring slots over dp
        self.mesh = mesh
        self._leader = mesh is None or dist.get_rank() == 0
        self._mesh_fns: Dict[str, Callable] = {}
        self._mesh_lock = threading.Lock()
        self._mesh_open = True
        # device calls this rank ran on the mesh, by batcher kind
        self.mesh_calls: Dict[str, int] = {}
        # full-speed replay benches must hold the whole backlog, or the
        # pool's drop-oldest backpressure loses blocks
        self.ingest_queue_cap = ingest_queue_cap
        self.pool: Optional[IngestPool] = None
        self._sessions: Dict[int, _Session] = {}
        self._workers: set = set()
        self._drain_task: Optional[asyncio.Task] = None
        self._running = False
        self._params = self._cfg = self._detok = self._ring = self._tbl = self._prefix = None
        self._sstep_kind = self._stt_kind = None
        self._stream_steps = int(os.environ.get("SK_STREAM_STEPS", "3"))
        # group submit: the drain loop plans and submits a whole co-paced
        # cohort's stream steps in one synchronous sweep
        self._group_submit = os.environ.get("SK_STREAM_GROUP_SUBMIT", "1") == "1"
        self._tracer = get_tracer()
        # finals served from the stream table vs exact-decode fallbacks
        self.finals_stream = 0
        self.finals_fallback = 0

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        dev = self.device

        def build():
            if self.model_path and os.path.isdir(self.model_path):
                cfg, params = load_pretrained(self.model_path, self.dtype, device=dev)
                return cfg, params, WhisperDetokenizer.from_model_dir(self.model_path)
            cfg = WHISPER_CONFIGS[self.model_size]
            params = seeded_params(cfg, self.dtype, dev)
            return cfg, params, WhisperDetokenizer()

        if self.resources is not None:
            # the WhisperNode's key: one model per device for both
            key = ResourceKey.from_params(
                "whisper",
                {"path": self.model_path, "size": self.model_size, "dtype": str(self.dtype),
                 "device": str(dev)},
            )

            async def loader():
                return await loop.run_in_executor(None, build)

            self._cfg, self._params, self._detok = await self.resources.get_or_create(key, loader)
        else:
            self._cfg, self._params, self._detok = await loop.run_in_executor(None, build)
        if self.mesh is not None:
            # a local copy: the cached params stay whole
            from ..parallel.mesh import shard_params

            self._params = shard_params(self.mesh, self._params, self._cfg)
        self._lang_index = language_index(self.language)
        cfg = self._cfg
        self._prefix = np.asarray(
            [cfg.token_sot, cfg.token_language(self._lang_index), cfg.token_transcribe, cfg.token_no_timestamps],
            np.int32,
        )
        self._ring = get_audio_ring(dev, mesh=self.mesh)
        model_tag = f"{self.model_path or self.model_size}:{self._lang_index}:{self.max_tokens}:{self.dtype}"
        # table width = engine capacity (the identity-packed step is B =
        # table width); dec_t sized to the token budget, 64-aligned (the
        # decoder self K/V is read whole every step)
        dec_t = min(int(os.environ.get("SK_STREAM_DEC_T", "128")),
                    max(64, -(-(len(self._prefix) + self.max_tokens + 8) // 64) * 64))
        self._tbl = get_stream_table(
            model_tag, cfg, self.dtype, device=dev, mesh=self.mesh,
            max_slots=min(self.max_sessions, int(os.environ.get("SK_STREAM_SLOTS", "64"))), dec_t=dec_t,
        )
        self._sstep_kind = f"stream_step:{model_tag}:{self.vad_block}"
        # stream-final mode force-cuts segments at the stream horizon less an
        # 8-chunk margin: a segment that outgrows it freezes the tip, and its
        # final would need the exact-decode fallback
        if self.final_mode == "stream":
            horizon_secs = (self._tbl.enc_t // CHUNK_POS - 8) * CHUNK_SAMPLES / _SR
            self.max_segment_secs = min(self.max_segment_secs, horizon_secs)
        params, ring, tbl = self._params, self._ring, self._tbl
        # chunk budget per call: the encode rate must cover the block rate
        self._n_chunks = max(2, -(-self.block_samples // CHUNK_SAMPLES))
        batched_sstep = self._device_call(
            self._sstep_kind,
            tbl.identity_step_fn(params, ring, ring.trash_slot(), self._stream_steps, n_chunks=self._n_chunks),
        )
        stream_pad = int(os.environ.get("SK_STREAM_PAD", str(min(64, tbl.max_slots))))
        # with `expected` coalescing a co-paced period fires once every
        # active session's block is in; the window only bounds stragglers
        block_ms = self.block_samples * 1000.0 / _SR
        if self._leader:
            self.batcher.register(
                self._sstep_kind, batched_sstep, pad_to=stream_pad,
                gather_ms=float(os.environ.get("SK_STREAM_GATHER_MS", str(0.8 * block_ms))), host_inputs=True,
            )

        # exact bucketed ring decode: the primary path in "exact" mode, the
        # fallback in "stream" mode (frozen horizon, never-decoded segment)
        self._stt_kind = f"whisper_ring:{model_tag}"
        pad_stt = int(os.environ.get("SK_STT_PAD_TO", "0")) or None
        gather_ms = float(os.environ.get("SK_STT_GATHER_MS", "150"))

        def make_ring_stt(window: int, tok_budget: int):
            def batched_stt(slot_ids, starts, lengths, lang_rows):
                return transcribe_ring(params, cfg, ring.ring_ref(), slot_ids, starts, lengths,
                                       window_samples=window, language_index=lang_rows, max_tokens=tok_budget)

            if self.mesh is None:
                return batched_stt
            from ..parallel.serving import dp_row_call

            # each row on the dp rank that owns its ring slot
            return lambda *rows: dp_row_call(ring, batched_stt, *rows)

        for b in self.window_buckets:
            tok_budget = min(self.max_tokens, max(12, int(b * 4) + 8))
            kind = f"{self._stt_kind}:{int(b * _SR)}"
            fn = self._device_call(kind, make_ring_stt(int(b * _SR), tok_budget))
            if self._leader:
                # on a mesh the inputs stay on the host: they are broadcast
                self.batcher.register(kind, fn, pad_to=pad_stt, gather_ms=gather_ms,
                                      host_inputs=self.mesh is not None)
        if not self._leader:
            return

        self.pool = IngestPool(self.max_sessions, self.block_samples, queue_cap=self.ingest_queue_cap)
        self.batcher.start()
        self._running = True
        self._drain_task = asyncio.ensure_future(self._drain_loop())

    async def stop(self) -> None:
        if not self._leader:
            return
        self._running = False
        for s in list(self._sessions.values()):
            self.close_session(s.sid)
        if self._drain_task is not None:
            try:
                await asyncio.wait_for(self._drain_task, timeout=5)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._drain_task.cancel()
        # workers remove themselves from _sessions: reap from _workers
        if self._workers:
            _, pending = await asyncio.wait(self._workers, timeout=5)
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        self._workers.clear()
        self._sessions.clear()
        if self._own_batcher:
            self.batcher.stop()
        if self.pool is not None:
            self.pool.close()
        if self.mesh is not None:
            with self._mesh_lock:  # after any call in flight: the followers return
                self._mesh_open = False
                dist.broadcast_object_list([None], src=0)

    # -- mesh ----------------------------------------------------------------
    def _device_call(self, name: str, fn: Callable) -> Callable:
        """``fn`` as the batcher calls it. On a mesh, rank 0's call first
        broadcasts ``(name, inputs, pending VAD resets)`` so every rank runs
        the same calls in the same order (one at a time: their collectives
        must pair up)."""
        self._mesh_fns[name] = fn
        if self.mesh is None:
            return fn

        def call(*inputs):
            with self._mesh_lock:
                if not self._mesh_open:
                    raise RuntimeError("the engine has stopped")
                msg = (name, tuple(np.asarray(a) for a in inputs), self._ring.take_resets())
                dist.broadcast_object_list([msg], src=0)
                return self._run_call(*msg)

        return call

    def _run_call(self, name: str, inputs, resets):
        self._ring.reset_slots(resets)
        self.mesh_calls[name] = self.mesh_calls.get(name, 0) + 1
        return self._mesh_fns[name](*inputs)

    def follow(self) -> None:
        """On a mesh rank other than 0 (after :meth:`start`): run rank 0's
        device calls on this rank's shards until rank 0 stops."""
        if self._leader:
            raise RuntimeError("follow() runs on the ranks other than 0")
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0)
            if msg[0] is None:
                return
            self._run_call(*msg[0])

    # -- sessions ------------------------------------------------------------
    def open_session(self, on_event: Callable[[dict], None]) -> int:
        """Open one STT session → its id (also the ingest id for
        :meth:`push` / :meth:`start_replay`). ``on_event`` receives
        ``{type: partial|final|speech_start|speech_end, text?, start_ms?,
        end_ms?, seq}`` on the event-loop thread."""
        stream_id = self._tbl.try_alloc()
        if stream_id is None:
            raise RuntimeError("stream table full")
        shard = self._tbl.shard  # on a mesh the ring slot goes on the stream slot's dp rank
        try:
            vad_slot = self._ring.alloc(dp_rank=None if shard is None else int(shard.owner(stream_id)))
        except RuntimeError:
            self._tbl.free(stream_id)
            raise
        sid = self.pool.open()
        s = _Session(
            sid=sid, vad_slot=vad_slot, stream_id=stream_id, on_event=on_event,
            seg=SpeechSegmenter(self.vad_threshold, self.min_silence_ms, self.max_segment_secs,
                                store_samples=False),  # finals decode from the ring
        )
        s.worker = asyncio.ensure_future(self._session_worker(s))
        self._workers.add(s.worker)
        s.worker.add_done_callback(self._workers.discard)
        self._sessions[sid] = s
        return sid

    def close_session(self, sid: int) -> None:
        s = self._sessions.get(sid)
        if s is None:
            return
        s.closing = True
        self.pool.close_session(sid)
        s.q.put_nowait(None)

    def idle(self) -> bool:
        """True when no session worker is live (every slot freed)."""
        return not self._sessions

    def push(self, sid: int, pcm: np.ndarray) -> None:
        self.pool.push(sid, pcm)

    def start_replay(self, sid: int, audio: np.ndarray, **kw) -> None:
        self.pool.start_replay(sid, audio, **kw)

    # -- serving loops -------------------------------------------------------
    async def _drain_loop(self) -> None:
        loop = asyncio.get_running_loop()
        pool = self.pool
        # a session counts as active while it produced a block within the
        # last 2 block periods; feeds BatchKind.expected so the fused step
        # fires the moment every active session's block is in
        last_seen: Dict[int, float] = {}
        period = self.block_samples / _SR
        tracer = self._tracer
        while self._running:
            t_drain = now_ns() if tracer.enabled else 0
            ids, _arrivals, blocks = await loop.run_in_executor(None, pool.drain, None, 20_000)
            now = time.monotonic()
            for i in range(len(ids)):
                if int(ids[i]) in self._sessions:
                    last_seen[int(ids[i])] = now
            # prune and refresh on every drain, empty ones included
            horizon = now - 2.0 * period
            for sid in [k for k, t in last_seen.items() if t < horizon or k not in self._sessions]:
                del last_seen[sid]
            # sessions awaiting an exact final submit no stream steps
            expected = sum(1 for k in last_seen if k in self._sessions and not self._sessions[k].awaiting_final)
            # SK_STREAM_COHORTS=n fires the batch at ceil(active/n)
            cohorts = max(1, int(os.environ.get("SK_STREAM_COHORTS", "1")))
            self.batcher.set_expected(self._sstep_kind, -(-expected // cohorts) if expected else 0)
            for i in range(len(ids)):
                s = self._sessions.get(int(ids[i]))
                if s is not None:
                    self._route_block(s, blocks[i])
            if t_drain and len(ids):
                tracer.record("stt.drain", t_drain, now_ns(), {"blocks": len(ids)})

    def _route_block(self, s: _Session, block: np.ndarray) -> None:
        """Group-submit the block's fused step here when the session has
        nothing queued or processing and is not closing; else queue the
        block for its worker (a closing session's worker never reads it)."""
        if self._group_submit and s.q.empty() and not s.processing and not s.closing:
            try:
                fut, ctx = self._plan_block(s, block)
            except Exception:  # noqa: BLE001 — one session's fault must not stop the loop
                logger.exception("planning a block of session %d failed; its worker retries it", s.sid)
            else:
                s.q.put_nowait(("p", fut, ctx))
                return
        s.q.put_nowait(("b", block))

    async def _session_worker(self, s: _Session) -> None:
        try:
            with self._tracer.span("stt.session") as span:
                span.set_attribute("session", s.sid)
                s.span = span
                while True:
                    item = await s.q.get()
                    if item is None:
                        break
                    s.processing = True
                    try:
                        if item[0] == "p":
                            _, fut, ctx = item
                        else:
                            fut, ctx = self._plan_block(s, item[1])
                        await self._finish_block(s, ctx, await fut)
                    except Exception:  # noqa: BLE001 — drop the block, keep the session
                        logger.exception("block of session %d failed", s.sid)
                    finally:
                        s.processing = False
                for ev in s.seg.flush():  # close any open segment
                    await self._segment_closed(s, ev[2], ev[3])
        finally:
            self._tbl.free(s.stream_id)
            self._ring.free(s.vad_slot)
            if self._sessions.get(s.sid) is s:  # the ingest id may already serve a new session
                del self._sessions[s.sid]

    def _plan_block(self, s: _Session, block: np.ndarray):
        """Plan and submit one block's fused step (synchronous) → ``(result
        future, ctx)``. The session's cursors advance only once the submit
        has succeeded: a planning fault leaves them as they were."""
        with self._tracer.span("stt.plan", parent=s.span) as span:
            block2 = block.reshape(self.vad_block, VAD_FRAME)
            n_req, do_dec, now = 0, False, time.monotonic()
            if s.seg.in_speech and s.st_ready:
                avail = s.written + block.size - RIGHT_CTX - s.st_tip
                room = (self._tbl.enc_t - s.st_pos) // CHUNK_POS
                n_req = max(0, min(avail // CHUNK_SAMPLES, self._n_chunks))
                if room < n_req:
                    n_req = 0  # horizon full: partials freeze
                do_dec = s.st_pos + CHUNK_POS * n_req > 0 and now - s.st_last_dec >= self.partial_interval
            span.set_attribute("session", s.sid)
            span.set_attribute("n_req", n_req)
            span.set_attribute("do_dec", do_dec)
            rs = self._ring.ring_samples
            meta_row = np.concatenate([
                np.asarray([s.vad_slot, s.stream_id, s.written % rs, s.st_tip % rs, n_req, int(do_dec),
                            int(s.pending_reset)], np.int32),
                self._prefix,
            ])
            fut = self.batcher.submit_nowait(self._sstep_kind, meta_row, block2)
            if do_dec:
                s.st_last_dec = now
            s.pending_reset = False
            s.written += block.size
            s.st_tip += n_req * CHUNK_SAMPLES
            s.st_pos += n_req * CHUNK_POS
            return fut, (block2, do_dec)

    async def _finish_block(self, s: _Session, ctx, result) -> None:
        block2, do_dec = ctx
        probs, tok_row, ntk, _ = result
        with self._tracer.span("stt.finish", parent=s.span) as span:
            seq0, bounds = s.seq, 0
            partial_emit = None
            if do_dec:
                partial_emit = (tok_row, int(ntk), s.st_tip // VAD_FRAME)
                s.st_last_tok = (tok_row, int(ntk))
            for i in range(self.vad_block):
                for kind, _samples, start_f, end_f in s.seg.push(block2[i], float(probs[i])):
                    bounds += 1
                    if kind == "speech_start":
                        s.on_event({"type": "speech_start", "seq": s.seq})
                        s.pending_reset = True
                        s.st_tip = start_f * VAD_FRAME
                        s.st_pos = 0
                        s.st_ready = True
                        s.st_last_tok = None
                    else:
                        s.st_ready = False
                        await self._segment_closed(s, start_f, end_f)
                        s.st_last_tok = None
            # the partial after the segment events (a closing block's partial is
            # superseded by the final)
            if partial_emit is not None and s.seg.in_speech and s.st_ready and partial_emit[1] > len(self._prefix):
                tok_row, ntk, end_f = partial_emit
                self._emit(s, "partial", self._detok.decode(tok_row[len(self._prefix) : ntk]),
                           s.seg._segment_start_frame, end_f)
            span.set_attribute("session", s.sid)
            # speech_start / speech_end, then the partials and finals
            span.set_attribute("events", bounds + s.seq - seq0)

    async def _segment_closed(self, s: _Session, start_f: int, end_f: int) -> None:
        s.on_event({"type": "speech_end", "seq": s.seq})
        stream_ok = (
            s.st_last_tok is not None
            and s.st_last_tok[1] > len(self._prefix)
            and s.st_tip >= end_f * VAD_FRAME - 2 * CHUNK_SAMPLES
        )
        if self.final_mode == "stream" and stream_ok:
            self.finals_stream += 1
            text = self._detok.decode(s.st_last_tok[0][len(self._prefix) : s.st_last_tok[1]])
            self._emit(s, "final", text, start_f, end_f)
            return
        # exact (or stream-fallback) final: bucketed ring re-decode
        self.finals_fallback += 1
        n = min((end_f - start_f) * VAD_FRAME, int(self.window_buckets[-1] * _SR))
        window = next((int(b * _SR) for b in self.window_buckets if n <= int(b * _SR)),
                      int(self.window_buckets[-1] * _SR))
        rs = self._ring.ring_samples
        s.awaiting_final = True
        try:
            # a child of the block's stt.finish (or, at close, of stt.session)
            with self._tracer.span("stt.final_exact") as span:
                span.set_attribute("session", s.sid)
                span.set_attribute("window", window)
                tokens, length = await self.batcher.submit(
                    f"{self._stt_kind}:{window}", np.int32(s.vad_slot), np.int32((start_f * VAD_FRAME) % rs),
                    np.int32(n), np.int32(self._lang_index),
                )
        finally:
            s.awaiting_final = False
        self._emit(s, "final", self._detok.decode(tokens[: int(length)]), start_f, end_f)

    def _emit(self, s: _Session, typ: str, text: str, start_f: int, end_f: int) -> None:
        s.on_event({
            "type": typ,
            "text": text,
            "start_ms": start_f * VAD_FRAME * 1000 // _SR,
            "end_ms": end_f * VAD_FRAME * 1000 // _SR,
            "seq": s.seq,
        })
        s.seq += 1
