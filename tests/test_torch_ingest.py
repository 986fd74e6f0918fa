# SPDX-License-Identifier: Apache-2.0
"""The port's native ingestion shim (csrc/ingest.cpp, built here with g++
from the repo's source): block assembly, drain coalescing, paced replay,
drop-oldest backpressure, and a push refused while a replay feeds the
session. Mirrors tests/test_ingest.py, which needs a prebuilt library."""

import os
import time

import numpy as np
import pytest
import torch

from streamkit_tpu_torch.engine.ingest import SOURCE, IngestPool, ingest_available
from streamkit_tpu_torch.ops import _build

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

BLOCK = 4096  # 8 VAD frames x 512 samples = 256 ms @16 kHz


def test_shim_builds_from_the_ports_source():
    lib = _build.build(SOURCE)
    assert os.path.exists(lib) and os.path.dirname(lib) == _build.BUILD_DIR
    assert SOURCE.path.endswith(os.path.join("streamkit_tpu_torch", "csrc", "ingest.cpp"))


def test_ingest_available_means_the_pool_loads(monkeypatch, tmp_path):
    """Where g++ is found (this image) the shim builds, so a pool opens; with
    no compiler and no built library for this revision there is none."""
    assert ingest_available()
    IngestPool(1, BLOCK).close()
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert not ingest_available()


@pytest.mark.parametrize("piece", [1, 777, BLOCK, 3 * BLOCK])
def test_push_assembles_blocks_in_order(piece):
    pool = IngestPool(4, BLOCK)
    sid = pool.open()
    audio = np.arange(BLOCK * 2 + 100, dtype=np.float32)
    for off in range(0, audio.size, piece):  # block boundaries must not care
        pool.push(sid, audio[off : off + piece])
    ids, _, blocks = pool.drain()
    assert list(ids) == [sid, sid]
    np.testing.assert_array_equal(blocks[0], audio[:BLOCK])
    np.testing.assert_array_equal(blocks[1], audio[BLOCK : 2 * BLOCK])
    assert pool.pending() == 0  # the 100-sample remainder is no block yet
    pool.close()


def test_multi_session_drain_coalesces():
    pool = IngestPool(8, BLOCK)
    sids = [pool.open() for _ in range(8)]
    for s in sids:
        pool.push(s, np.full(BLOCK, float(s), np.float32))
    ids, _, blocks = pool.drain()
    assert sorted(ids) == sorted(sids)
    for i, s in enumerate(ids):
        assert blocks[i, 0] == float(s)
    pool.close()


def test_paced_replay_cadence_and_close():
    """Three blocks at 64x realtime arrive at the paced cadence, and the
    session closes at the end."""
    pool = IngestPool(2, BLOCK)
    sid = pool.open()
    n = ((BLOCK * 3 + 319) // 320) * 320
    audio = np.random.RandomState(0).randn(n).astype(np.float32)
    pool.start_replay(sid, audio, frame_samples=320, frame_us=312)
    t0 = time.monotonic()
    got = []
    while len(got) < 3 and time.monotonic() - t0 < 5:
        ids, arr, blocks = pool.drain(timeout_us=100_000)
        got.extend((arr[i], blocks[i]) for i in range(len(ids)))
    assert len(got) == 3
    np.testing.assert_array_equal(got[0][1], audio[:BLOCK])
    np.testing.assert_array_equal(got[2][1], audio[2 * BLOCK : 3 * BLOCK])
    gaps = np.diff([g[0] for g in got]) / 1e6  # ms; one block ~ 4 ms here
    assert (gaps > 1.0).all(), gaps
    deadline = time.monotonic() + 2
    while pool.active() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.active() == 0
    assert pool.replay_start_ns(sid) > 0
    pool.close()


def test_queue_backpressure_drops_oldest():
    pool = IngestPool(1, BLOCK, queue_cap=2)
    sid = pool.open()
    for i in range(4):
        pool.push(sid, np.full(BLOCK, float(i), np.float32))
    assert pool.dropped() == 2
    ids, _, blocks = pool.drain()
    assert len(ids) == 2 and blocks[0, 0] == 2.0 and blocks[1, 0] == 3.0
    pool.close()


def test_closed_session_rejects_push():
    pool = IngestPool(1, BLOCK)
    sid = pool.open()
    pool.close_session(sid)
    with pytest.raises(RuntimeError, match="closed or replaying"):
        pool.push(sid, np.zeros(10, np.float32))
    assert pool.open() == sid  # the slot is reusable
    pool.close()


def test_push_during_replay_is_refused_and_order_kept():
    """While a paced replay feeds a session, push returns -1 (RuntimeError
    here) instead of queueing its samples ahead of earlier replayed ones;
    once the replay has ended, pushes continue the same stream in order."""
    pool = IngestPool(1, BLOCK)
    sid = pool.open()
    audio = np.arange(BLOCK + 1024, dtype=np.float32)  # 16 frames: a block and a remainder
    pool.start_replay(sid, audio, frame_samples=320, frame_us=20_000, close_at_end=False)
    time.sleep(0.01)
    with pytest.raises(RuntimeError, match="closed or replaying"):
        pool.push(sid, np.full(100, -1.0, np.float32))
    deadline = time.monotonic() + 5
    got = []
    while time.monotonic() < deadline:
        got.extend(pool.drain(timeout_us=50_000)[2])
        try:
            pool.push(sid, np.full(BLOCK, -2.0, np.float32))
            break
        except RuntimeError:
            continue
    got.extend(pool.drain()[2])
    stream = np.concatenate(got)
    assert stream.size == 2 * BLOCK
    np.testing.assert_array_equal(stream[: audio.size], audio)  # the replay's remainder first
    assert (stream[audio.size :] == -2.0).all()
    pool.close()
