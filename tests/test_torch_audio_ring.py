# SPDX-License-Identifier: Apache-2.0
"""Port parity: device audio ring fused with VAD scoring, against the JAX
package on the CPU. VAD probabilities agree at rtol 1e-5; ring contents are
bit-exact int16."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamkit_tpu.engine import audio_ring as jring
from streamkit_tpu.ops import vad as jvad
from streamkit_tpu_torch.engine import audio_ring as tring
from streamkit_tpu_torch.ops import vad as tvad
from streamkit_tpu_torch.ops.vad import VAD_FRAME

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others


def _blocks(rng, n_blocks, block_frames):
    return [rng.randn(block_frames, VAD_FRAME).astype(np.float32) * 0.1 for _ in range(n_blocks)]


def _stream_both(jr, tr, slots, blocks_per_slot):
    """Append the same blocks to both rings; return (jax probs, port probs)."""
    pos = [0] * len(slots)
    pj, pt = [], []
    for step in zip(*blocks_per_slot):
        frames = np.stack(step)
        pj.append(np.asarray(jr.vad_append(np.asarray(slots), np.asarray(pos), jnp.asarray(frames))))
        pt.append(tr.vad_append(np.asarray(slots), np.asarray(pos), torch.from_numpy(frames)).numpy())
        pos = [p + b.size for p, b in zip(pos, step)]
    return np.concatenate(pj, axis=1), np.concatenate(pt, axis=1)


@pytest.mark.parametrize("backend", ["learned", "spectral"])
def test_vad_append_matches_jax_and_ring_is_bit_exact(monkeypatch, backend):
    if backend == "spectral":
        monkeypatch.setattr(jvad, "_BACKEND", "spectral")
        monkeypatch.setattr(tvad, "_BACKEND", "spectral")
    else:
        assert jvad.vad_backend() == tvad.vad_backend() == "learned"
    jr = jring.SessionAudioRing(max_slots=4, ring_samples=1 << 14)
    tr = tring.SessionAudioRing(max_slots=4, ring_samples=1 << 14, device="cpu")
    slots = [jr.alloc(), jr.alloc()]
    assert [tr.alloc(), tr.alloc()] == slots
    rng = np.random.RandomState(0)
    loud = [b * 5.0 for b in _blocks(rng, 4, 4)]  # speech-level energy after quiet
    pj, pt = _stream_both(jr, tr, slots, [_blocks(rng, 4, 4), _blocks(rng, 2, 4) + loud[:2]])
    assert pt.shape == (2, 16)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tr.ring_ref().numpy(), np.asarray(jr.ring_ref()))


def test_ring_wraparound_and_length_mask():
    ring_samples = 4 * VAD_FRAME
    tr = tring.SessionAudioRing(max_slots=2, ring_samples=ring_samples, device="cpu")
    slot = tr.alloc()
    rng = np.random.RandomState(1)
    frames = rng.randn(6, VAD_FRAME).astype(np.float32) * 0.1
    for i, f in enumerate(frames):  # 6 frames into a 4-frame ring: the last 4 survive
        tr.vad_append(np.asarray([slot]), np.asarray([i * VAD_FRAME]), f[None, None, :])
    got = tring.gather_ring_window(
        tr.ring_ref(), torch.tensor([slot]), torch.tensor([2 * VAD_FRAME]), torch.tensor([4 * VAD_FRAME]),
        4 * VAD_FRAME,
    )[0].numpy()
    want = np.clip(frames[2:].reshape(-1) * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
    np.testing.assert_array_equal(got, want.astype(np.float32))
    masked = tring.gather_ring_window(
        tr.ring_ref(), torch.tensor([slot]), torch.tensor([0]), torch.tensor([100]), VAD_FRAME
    )[0].numpy()
    assert np.all(masked[100:] == 0.0) and np.all(masked[:100] != 0.0)


@pytest.mark.parametrize("window", [3000, 2 * 4096 + 5])
def test_gather_matches_jax_including_windows_longer_than_ring(window):
    """Windows shorter than the ring, and longer ones that lap it (the
    reference's modular path)."""
    rng = np.random.RandomState(2)
    ring = rng.randint(-32768, 32768, (3, 4096)).astype(np.int16)
    slots = np.asarray([2, 0, 2], np.int32)
    starts = np.asarray([4000, 123, 70000], np.int32)
    lengths = np.asarray([window, 1000, window - 7], np.int32)
    want = np.asarray(
        jring.gather_ring_window(jnp.asarray(ring), jnp.asarray(slots), jnp.asarray(starts),
                                 jnp.asarray(lengths), window)
    )
    got = tring.gather_ring_window(
        torch.from_numpy(ring), torch.from_numpy(slots), torch.from_numpy(starts), torch.from_numpy(lengths), window
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_snapshot_is_never_written():
    """A decode's ring_ref() snapshot stays fixed while appends land: the
    ring is replaced, never written in place."""
    tr = tring.SessionAudioRing(max_slots=2, ring_samples=1 << 12, device="cpu")
    slot = tr.alloc()
    rng = np.random.RandomState(3)
    tr.vad_append([slot], [0], _blocks(rng, 1, 2)[0][None])
    snap = tr.ring_ref()
    frozen = snap.clone()
    tr.vad_append([slot], [2 * VAD_FRAME], _blocks(rng, 1, 2)[0][None])
    assert torch.equal(snap, frozen)
    assert not torch.equal(tr.ring_ref(), frozen)


def test_ring_snapshot_stress():
    """Writers append while readers hold snapshots (more threads than the
    work needs, short switch interval): no snapshot ever changes."""
    tr = tring.SessionAudioRing(max_slots=4, ring_samples=1 << 12, device="cpu")
    slots = [tr.alloc() for _ in range(4)]
    stop = time.monotonic() + 1.0
    errors = []

    def writer(slot, seed):
        rng = np.random.RandomState(seed)
        pos = 0
        while time.monotonic() < stop:
            tr.vad_append([slot], [pos], (rng.randn(1, 1, VAD_FRAME) * 0.1).astype(np.float32))
            pos += VAD_FRAME

    def reader():
        while time.monotonic() < stop:
            snap = tr.ring_ref()
            frozen = snap.clone()
            time.sleep(0.001)
            if not torch.equal(snap, frozen):
                errors.append("snapshot changed")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(s, s)) for s in slots]
        threads += [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors


def test_alloc_resets_vad_state_and_exhaustion_raises():
    tr = tring.SessionAudioRing(max_slots=2, ring_samples=1 << 12, device="cpu")
    a = tr.alloc()
    rng = np.random.RandomState(4)
    first = tr.vad_append([a], [0], _blocks(rng, 1, 4)[0][None]).numpy()
    tr.free(a)
    b = tr.alloc()
    assert b == a
    again = tr.vad_append([b], [0], _blocks(np.random.RandomState(4), 1, 4)[0][None]).numpy()
    np.testing.assert_array_equal(again, first)  # fresh state, same audio, same probs
    tr.alloc()
    assert tr.in_use == 2
    with pytest.raises(RuntimeError, match="exhausted"):
        tr.alloc()


def test_pcm_to_wire_matches_jax():
    x = np.linspace(-1.1, 1.1, 5000).astype(np.float32)
    np.testing.assert_array_equal(tring.pcm_to_wire(x), jring.pcm_to_wire(x))
