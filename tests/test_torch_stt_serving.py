# SPDX-License-Identifier: Apache-2.0
"""The port's dense STT serving engine on the CPU (Whisper tiny, f32, random
weights): the event flow in stream and exact final modes (mirrors
tests/test_stt_serving.py), and the three faults the reference's review
found, each refused: a block drained after close_session reaching the
device, a planning exception stopping the drain loop, and a push mixed into
a running replay."""

import asyncio
import logging

import numpy as np
import pytest
import torch

from streamkit_tpu_torch.engine import audio_ring
from streamkit_tpu_torch.engine.stt_serving import SttServingEngine
from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

torch.set_num_threads(2)  # pytest runs files in parallel workers

SR = 16_000


@pytest.fixture(autouse=True)
def small_ring():
    """A small process-wide CPU ring (the default holds 128 slots)."""
    saved = dict(audio_ring._RINGS)
    audio_ring._RINGS["cpu"] = audio_ring.SessionAudioRing(max_slots=8, device="cpu")
    yield
    audio_ring._RINGS.clear()
    audio_ring._RINGS.update(saved)


def _speech(seconds: float, seed: int) -> np.ndarray:
    return synth_speech_with_plan(seconds, SR, seed=seed)[0].astype(np.float32)


def _engine(final_mode="stream", **kw):
    return SttServingEngine(model_size="tiny", dtype="float32", max_sessions=4, final_mode=final_mode,
                            window_buckets=[4.0], partial_interval_ms=250.0, device="cpu", **kw)


async def _serve(eng, n_sessions, seconds=6.0, before_push=None):
    await eng.start()
    events = {i: [] for i in range(n_sessions)}
    sids = [eng.open_session(lambda ev, i=i: events[i].append(ev)) for i in range(n_sessions)]
    if before_push is not None:
        before_push(eng, sids)
    audio = [_speech(seconds, seed=i) for i in range(n_sessions)]
    for off in range(0, int(seconds * SR), 8000):  # 0.5 s pieces, faster than real time
        for i, sid in enumerate(sids):
            eng.push(sid, audio[i][off : off + 8000])
        await asyncio.sleep(0.05)
    for sid in sids:  # trailing silence closes the last segment
        eng.push(sid, np.zeros(SR, np.float32))
    deadline = asyncio.get_running_loop().time() + 120
    while asyncio.get_running_loop().time() < deadline:
        if all(any(e["type"] == "final" for e in evs) for evs in events.values()):
            break
        await asyncio.sleep(0.1)
    drain_alive = not eng._drain_task.done()
    for sid in sids:
        eng.close_session(sid)
    await eng.stop()
    assert eng.idle()
    return events, drain_alive


def _check_flow(events, partials=True):
    for i, evs in events.items():
        types = [e["type"] for e in evs]
        assert "speech_start" in types, (i, types)
        finals = [e for e in evs if e["type"] == "final"]
        assert finals, (i, types)
        if partials:
            assert "partial" in types, (i, types)
        seqs = [e["seq"] for e in evs if "text" in e]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
        assert all(isinstance(e["text"], str) for e in evs if "text" in e)
        for f in finals:
            assert f["end_ms"] > f["start_ms"] >= 0


def test_stream_mode_two_sessions():
    eng = _engine("stream")
    events, alive = asyncio.run(_serve(eng, 2))
    assert alive
    _check_flow(events)
    assert eng.finals_stream > 0
    calls = eng.batcher.stats()["kinds"][eng._sstep_kind]
    assert calls["items"] > calls["calls"]  # the two sessions' blocks batch


def test_exact_mode_single_session():
    eng = _engine("exact")
    events, _ = asyncio.run(_serve(eng, 1))
    _check_flow(events, partials=False)
    assert eng.finals_fallback > 0 and eng.finals_stream == 0


def test_closing_session_keeps_late_blocks_off_the_device():
    """A block drained after close_session is queued behind the worker's
    sentinel, never planned: its ring and table slots are about to be freed
    and may be reallocated to another session."""

    async def run():
        eng = _engine("stream")
        await eng.start()
        sid = eng.open_session(lambda ev: None)
        live = eng.open_session(lambda ev: None)
        s = eng._sessions[sid]
        block = np.zeros(eng.block_samples, np.float32)
        eng.close_session(sid)
        before = eng.batcher.submissions
        eng._route_block(s, block)
        late = eng.batcher.submissions - before
        queued = s.q.qsize()
        eng._route_block(eng._sessions[live], block)
        live_submitted = eng.batcher.submissions - before
        await eng.stop()
        return late, queued, live_submitted

    late, queued, live_submitted = asyncio.run(run())
    assert late == 0 and queued == 2  # the sentinel and the parked block
    assert live_submitted == 1  # an open session's block is group-submitted


def test_plan_block_fault_does_not_stop_the_drain_loop(caplog):
    """An exception while planning one session's block is logged; the drain
    loop lives on, the block is retried by the session's worker, and every
    session still gets its events."""
    failed = []

    def arm(eng, sids):
        plan = eng._plan_block

        def flaky(s, block):
            if s.sid == sids[0] and not failed:
                failed.append(s.sid)
                raise RuntimeError("injected planning fault")
            return plan(s, block)

        eng._plan_block = flaky

    caplog.set_level(logging.ERROR, logger="streamkit_tpu_torch.engine.stt_serving")
    events, alive = asyncio.run(_serve(_engine("stream"), 2, before_push=arm))
    assert failed and alive
    assert "injected planning fault" in caplog.text
    _check_flow(events)


def test_push_during_replay_is_refused():
    async def run():
        eng = _engine("stream")
        await eng.start()
        sid = eng.open_session(lambda ev: None)
        eng.start_replay(sid, np.zeros(SR, np.float32), frame_us=20_000, close_at_end=False)
        try:
            with pytest.raises(RuntimeError, match="closed or replaying"):
                eng.push(sid, np.zeros(320, np.float32))
        finally:
            eng.close_session(sid)
            await eng.stop()

    asyncio.run(run())
