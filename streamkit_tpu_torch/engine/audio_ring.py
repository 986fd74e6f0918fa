# SPDX-License-Identifier: Apache-2.0
"""Device-resident per-session audio rings fused with VAD scoring.

Port of ``streamkit_tpu/engine/audio_ring.py``. Each audio block crosses
the host boundary once, inside the VAD-scoring call that also appends it to
the session's ring on the device; later decodes reference audio by
``(slot, start_sample, length)``.

Layout: ``ring [max_slots, ring_samples] int16``, VAD state rows
``[max_slots, ...]``.

Concurrency: the batcher runs batches in executor threads, so VAD appends
and ring decodes interleave. VAD state is updated **in place** under
``_step_lock`` (only VAD calls touch it). The ring is written **out of
place**: each append builds a new ring tensor and swaps it in under the
lock, so a ring tensor handed out by :meth:`SessionAudioRing.ring_ref` is
never written again and a decode reading it sees a fixed snapshot.

Capacity rule: ``ring_samples`` (default 2^19 = 32.77 s @16 kHz) must exceed
the longest segment (30 s) plus the closing silence (0.7 s).

On a mesh (:func:`...parallel.serving.shard_audio_ring`) a rank holds the
rows of its dp share of the slots plus a trash row of its own; slot ids stay
global. A slot's VAD reset then runs on the rank that owns it: ``alloc``
only records it, and the serving engine hands the pending resets to every
rank with its next device call (:meth:`SessionAudioRing.reset_slots`).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.vad import vad_frame_probs, vad_init_state

__all__ = [
    "SessionAudioRing",
    "RING_SAMPLES",
    "get_audio_ring",
    "pcm_to_wire",
    "ring_append_rows",
    "gather_ring_window",
]

RING_SAMPLES = 1 << 19  # 32.768 s @ 16 kHz


def pcm_to_wire(frames: np.ndarray) -> np.ndarray:
    """Host-side f32 PCM → int16 wire (the ring stores int16, and VAD scores
    exactly the audio the ring stores)."""
    if frames.dtype == np.int16:
        return frames
    return np.clip(frames * 32768.0, -32768.0, 32767.0).astype(np.int16)


def _vad_append(vad_state, ring, slot_ids, starts, frames_b):
    """Score VAD frames and append them to the rings.

    ``frames_b [B, n_frames, VAD_FRAME]`` int16 wire (or f32 PCM, quantized
    here), ``starts [B]`` absolute sample positions. Writes the scored rows
    of ``vad_state`` in place and returns ``(new_ring, probs [B, n_frames])``
    with ``ring`` itself left untouched."""
    rows = type(vad_state)(*(s[slot_ids] for s in vad_state))
    if frames_b.dtype == torch.int16:
        wire3 = frames_b
    else:
        wire3 = torch.clamp(frames_b.float() * 32768.0, -32768.0, 32767.0).to(torch.int16)
    frames_f = wire3.float() / 32768.0
    probs, new_rows = vad_frame_probs(rows, frames_f)
    for s, r in zip(vad_state, new_rows):
        s[slot_ids] = r
    new_ring = ring_append_rows(ring.clone(), slot_ids, starts, wire3.reshape(wire3.shape[0], -1))
    return new_ring, probs


def ring_append_rows(ring, slot_ids, starts, wire):
    """Write ``wire [B, n]`` int16 into ``ring`` **in place** at per-row
    absolute ``starts`` (mod ``ring_samples``) and return ``ring``. Callers
    append whole VAD blocks at block-aligned starts, so a write never
    splits across the wrap."""
    n = wire.shape[1]
    idx = (starts.long()[:, None] + torch.arange(n, device=ring.device)) % ring.shape[1]
    ring[slot_ids.long()[:, None], idx] = wire
    return ring


def gather_ring_window(ring, slot_ids, starts, lengths, window_samples: int):
    """``[B]`` ring coordinates → ``[B, window_samples]`` f32 audio, zeroed
    beyond each row's length. Indices wrap modulo the ring, which also covers
    windows longer than the ring (tiny test rings)."""
    ring_samples = ring.shape[1]
    pos = torch.arange(window_samples, device=ring.device)
    idx = (starts.long()[:, None] + pos) % ring_samples
    audio = ring[slot_ids.long()[:, None], idx].float() / 32768.0
    mask = pos[None, :] < lengths.long()[:, None]
    return torch.where(mask, audio, 0.0)


class SessionAudioRing:
    """Pool of device-resident (VAD state, audio ring) rows keyed by slot."""

    def __init__(self, max_slots: int = 128, ring_samples: int = RING_SAMPLES, device=None) -> None:
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.ring_samples = ring_samples
        self._vad_state = vad_init_state((max_slots,), self.device)
        self._init_row = vad_init_state((), self.device)
        self._ring = torch.zeros((max_slots, ring_samples), dtype=torch.int16, device=self.device)
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._trash = None
        self.shard = None  # this rank's SlotShard on a mesh
        self._pending_resets: List[int] = []
        self._alloc_lock = threading.Lock()
        # serializes VAD steps (in-place state) and ring swaps; decode
        # readers snapshot the ring under it but run outside it
        self._step_lock = threading.Lock()

    # -- slot lifecycle -----------------------------------------------------
    def alloc(self, dp_rank: Optional[int] = None) -> int:
        """Acquire a slot (on a mesh: one of ``dp_rank``'s, when given); its
        VAD state resets (on a mesh: at the next :meth:`reset_slots`). Stale
        ring contents are harmless (decodes mask by length and only read
        what VAD wrote)."""
        with self._alloc_lock:
            free = self._free
            if dp_rank is not None and self.shard is not None:
                free = [s for s in self._free if self.shard.owner(s) == dp_rank]
            if not free:
                raise RuntimeError(f"audio ring table exhausted ({self.max_slots} slots)")
            slot = free[-1]
            self._free.remove(slot)
            if self.shard is not None:
                self._pending_resets.append(slot)
                return slot
        self.reset_slots([slot])
        return slot

    def take_resets(self) -> List[int]:
        """The slots allocated on a mesh since the last call (their VAD resets
        are still to run on every rank: :meth:`reset_slots`)."""
        with self._alloc_lock:
            out, self._pending_resets = self._pending_resets, []
        return out

    def reset_slots(self, slots) -> None:
        """Reset the VAD state of ``slots`` (global ids); on a mesh, of those
        this rank owns."""
        rows = list(slots)
        if self.shard is not None:
            sh = self.shard
            rows = [s - sh.rank * sh.local for s in rows if sh.owner(s) == sh.rank]
        if not rows:
            return
        with self._step_lock:
            for s, r in zip(self._vad_state, self._init_row):
                s[rows] = r

    def free(self, slot: int) -> None:
        with self._alloc_lock:
            self._free.append(slot)

    def trash_slot(self) -> int:
        """Process-shared parking slot for the inert rows of identity-packed
        fused batches (duplicate writes of garbage, never read). Allocated
        once, at first use, and never freed. On a mesh: ``-1``, which each
        rank reads as its own trash row."""
        if self.shard is not None:
            return -1
        with self._alloc_lock:
            if self._trash is None:
                if not self._free:
                    raise RuntimeError(f"audio ring table exhausted ({self.max_slots} slots)")
                self._trash = self._free.pop()
            return self._trash

    @property
    def in_use(self) -> int:
        with self._alloc_lock:
            return self.max_slots - len(self._free)

    # -- batched steps --------------------------------------------------------
    @torch.no_grad()
    def vad_append(self, slot_ids, starts, frames_b) -> torch.Tensor:
        """Batched VAD score + ring append.

        ``slot_ids [B]``, ``starts [B]`` absolute sample positions,
        ``frames_b [B, n_frames, VAD_FRAME]`` f32 PCM or int16 wire (numpy or
        tensor) → probs ``[B, n_frames]`` on the ring's device. Host f32 is
        quantized to the int16 wire before upload."""
        if self.shard is not None:
            raise ValueError("a sharded ring appends only inside the fused stream step")
        if isinstance(frames_b, np.ndarray):
            frames_b = pcm_to_wire(frames_b)
        frames = torch.as_tensor(frames_b, device=self.device)
        ids = torch.as_tensor(slot_ids, dtype=torch.int64, device=self.device)
        pos = torch.as_tensor(starts, dtype=torch.int64, device=self.device)
        with self._step_lock:
            self._ring, probs = _vad_append(self._vad_state, self._ring, ids, pos, frames)
        return probs

    def ring_ref(self) -> torch.Tensor:
        """Snapshot the current ring for a read-only decode. Appends never
        write a ring tensor after it has been handed out."""
        with self._step_lock:
            return self._ring


# process-wide rings, one per device and mesh shard (slots are allocated per
# session)
_RINGS: Dict[object, SessionAudioRing] = {}
_RINGS_LOCK = threading.Lock()


def get_audio_ring(device=None, mesh=None) -> SessionAudioRing:
    """The process-wide :class:`SessionAudioRing` on ``device`` (default
    ``cuda``), ``SK_RING_SLOTS`` slots (default 128) at first creation. With
    a ``mesh``, this rank's dp shard of it (a ring of its own: a rank is
    never handed the unsharded one)."""
    dev = resolve_device(device)
    key = str(dev)
    if mesh is not None:
        from ..parallel.mesh import mesh_coords

        key = (key, mesh_coords(mesh))
    with _RINGS_LOCK:
        ring = _RINGS.get(key)
        if ring is None:
            ring = SessionAudioRing(max_slots=int(os.environ.get("SK_RING_SLOTS", "128")), device=dev)
            if mesh is not None:
                from ..parallel.serving import shard_audio_ring

                shard_audio_ring(mesh, ring)
            _RINGS[key] = ring
        return ring
