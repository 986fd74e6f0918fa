# SPDX-License-Identifier: Apache-2.0
"""Streaming Whisper (the live-partials path): the port's ``StreamTable``
against the JAX package's, on the CPU, with the same weights and audio.

Mirrors tests/test_whisper_streaming.py: chunk encode and decode
continuation, the fused block step in general and identity packing (the
identity int8 step is the path that runs the windowed-write and
history-attention kernels on a card; here it takes their plain versions),
fused against separate calls, identity against general, masked rows
untouched, and the int8 table following the f32 one.

Limits: tokens, ``n_tok``, positions and ring contents equal; f32 caches
within 1e-5; int8 codes equal (measured: no code differs) and scales
within rtol 1e-6; VAD probabilities within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamkit_tpu.engine.audio_ring import SessionAudioRing as JRing
from streamkit_tpu.models.whisper import streaming as js
from streamkit_tpu.models.whisper.config import WhisperConfig as JConfig
from streamkit_tpu.models.whisper.model import init_params as jinit
from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
from streamkit_tpu_torch.models.whisper import streaming as ts
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.ops import cache_write, decode_attention, stream_attention
from streamkit_tpu_torch.ops.vad import VAD_FRAME

torch.set_num_threads(2)  # pytest runs files in parallel workers

DIMS = dict(
    n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=256, n_text_ctx=32, n_text_state=64, n_text_head=2, n_text_layer=2,
)
CFG = WhisperConfig(**DIMS)
PREFIX = np.asarray([1, 2, 3, 4], np.int32)
CHUNK = ts.CHUNK_SAMPLES
RS = 1 << 14  # ring samples
KINDS = ("enc_k", "enc_v", "xk", "xv", "dec_k", "dec_v")


@pytest.fixture(scope="module")
def pair():
    jp = jinit(JConfig(**DIMS), jax.random.PRNGKey(7), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG, torch.float32, device="cpu")


def _tables(int8, slots=2, enc_t=64):
    kw = dict(max_slots=slots, enc_t=enc_t, dec_t=32, kv_int8=int8)
    return js.StreamTable(JConfig(**DIMS), jnp.float32, **kw), ts.StreamTable(CFG, torch.float32, device="cpu", **kw)


def _ring_arrays(n_chunks, seed):
    """Ring row 0 holding int16 noise for ``n_chunks`` chunks + lookahead."""
    rng = np.random.RandomState(seed)
    n = n_chunks * CHUNK + ts.RIGHT_CTX
    wire = np.clip(rng.randn(n) * 0.2 * 32768.0, -32768, 32767).astype(np.int16)
    ring = np.zeros((1, RS), np.int16)
    ring[0, :n] = wire
    return jnp.asarray(ring), torch.from_numpy(ring)


def _session_rings(slots):
    jr, tr = JRing(max_slots=slots, ring_samples=RS), SessionAudioRing(max_slots=slots, ring_samples=RS, device="cpu")
    for r in (jr, tr):
        for k in range(slots):
            assert r.alloc() == k
    return jr, tr


def _blocks(n_blocks, seed):
    """Speech-amplitude noise blocks ``[n, 8, VAD_FRAME]``."""
    return np.random.RandomState(seed).randn(n_blocks, 8, VAD_FRAME).astype(np.float32) * 0.2


def _assert_caches(jt, tt, rows=slice(None), atol=1e-5):
    for w in KINDS:
        want, got = jt.cache_view(w), tt.cache_view(w)
        if isinstance(got, tuple):
            np.testing.assert_array_equal(got[0][rows], np.asarray(want[0])[rows], err_msg=w)
            np.testing.assert_allclose(got[1][rows], np.asarray(want[1])[rows], rtol=1e-6, err_msg=w)
        else:
            np.testing.assert_allclose(got[rows], np.asarray(want)[rows], atol=atol, rtol=0, err_msg=w)


def _assert_state(jt, tt, rows=slice(None)):
    for name in ("_tokens", "_n_tok", "_fed", "_enc_pos"):
        np.testing.assert_array_equal(getattr(tt, name).numpy()[rows], np.asarray(getattr(jt, name))[rows],
                                      err_msg=name)


@pytest.mark.parametrize("int8", [False, True])
def test_chunk_encode_and_decode_match_jax(pair, int8):
    """Three one-chunk encodes over two rows, then an 8-step continuation."""
    jp, tp = pair
    jt, tt = _tables(int8)
    jr, tr = _ring_arrays(3, seed=1)
    for t in (jt, tt):
        t.reset(0, PREFIX)
        t.reset(1, PREFIX)
    for k in range(3):
        jt.encode_chunks(jp, jr, [0, 0], [0, 1], [k * CHUNK] * 2)
        tt.encode_chunks(tp, tr, [0, 0], [0, 1], [k * CHUNK] * 2)
    assert tt._enc_pos.tolist() == [24, 24]
    jtok, jn = jt.decode_steps(jp, [0, 1], 8)
    ttok, tn = tt.decode_steps(tp, [0, 1], 8)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) > 4, "decode should append tokens"
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_caches(jt, tt)
    _assert_state(jt, tt)


def test_multichunk_encode_matches_single(pair):
    """One two-chunk encode appends what two one-chunk encodes append, up to
    the chunk-local mel floor (max − 8 over 19 vs 35 frames)."""
    _, tp = pair
    t1, t2 = _tables(False, slots=1)[1], _tables(False, slots=1)[1]
    _, tr = _ring_arrays(2, seed=5)
    for t in (t1, t2):
        t.reset(0, PREFIX)
    for k in range(2):
        t1.encode_chunks(tp, tr, [0], [0], [k * CHUNK], n_chunks=1)
    t2.encode_chunks(tp, tr, [0], [0], [0], n_chunks=2)
    assert int(t1._enc_pos[0]) == int(t2._enc_pos[0]) == 16
    for w in ("enc_k", "xv"):
        np.testing.assert_allclose(t1.cache_view(w), t2.cache_view(w), atol=5e-3)


def test_decode_continuation_invariance(pair):
    """12 decode steps in one call equal three calls of 4 steps."""
    _, tp = pair
    tt = _tables(False)[1]
    _, tr = _ring_arrays(3, seed=2)
    for sid in (0, 1):
        tt.reset(sid, PREFIX)
    for k in range(3):
        tt.encode_chunks(tp, tr, [0, 0], [0, 1], [k * CHUNK] * 2)
    tok_a, n_a = tt.decode_steps(tp, [0], 12)
    for _ in range(3):
        tok_b, n_b = tt.decode_steps(tp, [1], 4)
    assert int(n_a[0]) == int(n_b[0])
    np.testing.assert_array_equal(tok_a[0, : int(n_a[0])].numpy(), tok_b[0, : int(n_b[0])].numpy())


def _meta(rows):
    """rows: (slot, stream, wpos, cstart, n_req, do_dec, do_reset) → meta."""
    return np.stack([np.concatenate([np.asarray(r, np.int32), PREFIX]) for r in rows])


@pytest.mark.parametrize("mode", ["general_f32", "general_int8", "identity_f32", "identity_int8"])
def test_fused_step_matches_jax(pair, mode):
    """Three fused block steps with a segment open, rows committing
    different chunk counts, and (identity) an inert gap row on a trash ring
    slot. identity_int8 is the serving path that launches the kernels on a
    card."""
    jp, tp = pair
    identity, int8 = mode.startswith("identity"), mode.endswith("int8")
    S = 3
    jt, tt = _tables(int8, slots=S)
    jr, tr = _session_rings(S + 1)  # ring slot S is the trash slot
    blocks = _blocks(3, seed=13)
    block_n = 8 * VAD_FRAME
    tips = [0, 0, 0]
    active = [0, 2] if identity else [0, 1, 2]
    for bi, block in enumerate(blocks):
        written = bi * block_n
        rows = []
        for s in range(S):
            avail = written + block_n - ts.RIGHT_CTX - tips[s]
            n_req = max(0, min(avail // CHUNK, 2 if s != 1 else 1))  # row 1 lags
            if s in active:
                rows.append((s, s, written % RS, tips[s] % RS, n_req, int(bi > 0), int(bi == 0)))
                tips[s] += n_req * CHUNK
            else:
                rows.append((S, s, 0, 0, 0, 0, 0))
        meta = _meta(rows if identity else rows[::-1])  # general: scrambled order
        frames = np.stack([block] * S)
        jout = jt.step(jp, jr, meta, None, None, None, None, None, frames, max_steps=4)
        tout = tt.step(tp, tr, meta, None, None, None, None, None, frames, max_steps=4)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=1e-5, rtol=0)
        for k in (1, 2, 3):
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
    assert (tt._n_tok.numpy()[active] > 4).all()
    np.testing.assert_array_equal(tr._ring.numpy()[active], np.asarray(jr._ring)[active])
    _assert_state(jt, tt, active)
    _assert_caches(jt, tt, active)


def test_fused_step_matches_separate_calls(pair):
    """The fused step equals the separate vad_append / encode_chunks /
    decode_steps schedule, with rows committing different chunk counts."""
    _, tp = pair
    ring_a, ring_b = _session_rings(2)[1], _session_rings(2)[1]
    tbl_a, tbl_b = _tables(False)[1], _tables(False)[1]
    for t in (tbl_a, tbl_b):
        t.reset(0, PREFIX)
        t.reset(1, PREFIX)
    blocks = _blocks(3, seed=13)
    block_n = 8 * VAD_FRAME
    written, tip = 0, [0, 0]
    pa, pb = [], []
    for bi, block in enumerate(blocks):
        avail = written + block_n - ts.RIGHT_CTX
        n0 = max(0, min((avail - tip[0]) // CHUNK, 2))
        n1 = max(0, min((avail - tip[1]) // CHUNK, 1))
        do_dec = bi == len(blocks) - 1
        probs_a, tok_a, n_a, _ = tbl_a.step(
            tp, ring_a, [0, 1], [0, 1], [written % RS] * 2, [tip[0] % RS, tip[1] % RS],
            [n0, n1], [do_dec] * 2, np.stack([block, block]), max_steps=6,
        )
        pa.append(probs_a.numpy())
        pb.append(ring_b.vad_append([0, 1], [written] * 2, np.stack([block, block])).numpy())
        for row, n in ((0, n0), (1, n1)):
            if n:
                tbl_b.encode_chunks(tp, ring_b.ring_ref(), [row], [row], [tip[row] % RS], n_chunks=n)
        if do_dec:
            tok_b, n_b = tbl_b.decode_steps(tp, [0, 1], 6)
        tip[0] += n0 * CHUNK
        tip[1] += n1 * CHUNK
        written += block_n
    np.testing.assert_allclose(np.concatenate(pa), np.concatenate(pb), atol=1e-6)
    assert torch.equal(ring_a._ring, ring_b._ring)
    assert torch.equal(tbl_a._enc_pos, tbl_b._enc_pos)
    for w in ("enc_k", "xv"):  # the mel floor tolerance, as above
        np.testing.assert_allclose(tbl_a.cache_view(w), tbl_b.cache_view(w), atol=5e-3)
    assert torch.equal(n_a, n_b)
    for row in range(2):
        assert torch.equal(tok_a[row, : int(n_a[row])], tok_b[row, : int(n_b[row])])


@pytest.mark.parametrize("int8", [False, True])
def test_fused_step_identity_matches_general(pair, int8):
    """Identity packing (B = max_slots, gap rows inert on the trash slot;
    writes through the windowed-write wrapper, int8 attention through the
    history-attention wrapper) evolves the active rows as a scrambled
    general batch of just those rows does."""
    _, tp = pair
    S, active, order = 4, [0, 1, 3], [3, 0, 1]
    ring_a, ring_b = _session_rings(S + 1)[1], _session_rings(S + 1)[1]
    tbl_a, tbl_b = _tables(int8, slots=S)[1], _tables(int8, slots=S)[1]
    blocks = _blocks(3, seed=31)
    block_n = 8 * VAD_FRAME
    written = tip = 0
    for bi, block in enumerate(blocks):
        n_req = max(0, min((written + block_n - ts.RIGHT_CTX - tip) // CHUNK, 2))
        row = lambda s: (s, s, written % RS, tip % RS, n_req, int(bi > 0), int(bi == 0))  # noqa: E731
        meta_a = _meta([row(p) if p in active else (S, p, 0, 0, 0, 0, 0) for p in range(S)])
        pa = tbl_a.step(tp, ring_a, meta_a, None, None, None, None, None, np.stack([block] * S), max_steps=4)[0]
        pb = tbl_b.step(tp, ring_b, _meta([row(s) for s in order]), None, None, None, None, None,
                        np.stack([block] * 3), max_steps=4)[0]
        np.testing.assert_allclose(pa.numpy()[active], pb.numpy()[[order.index(s) for s in active]], atol=1e-6)
        written += block_n
        tip += n_req * CHUNK
    assert torch.equal(ring_a._ring[active], ring_b._ring[active])
    for name in ("_tokens", "_n_tok", "_fed", "_enc_pos"):
        assert torch.equal(getattr(tbl_a, name)[active], getattr(tbl_b, name)[active]), name
    for w in KINDS:
        a, b = tbl_a.cache_view(w), tbl_b.cache_view(w)
        if int8 and w not in ("dec_k", "dec_v"):
            np.testing.assert_array_equal(a[0][active], b[0][active], err_msg=w)
            np.testing.assert_allclose(a[1][active], b[1][active], rtol=1e-6, err_msg=w)
        else:
            np.testing.assert_allclose(a[active], b[active], atol=1e-5, err_msg=w)
    assert int(tbl_a._enc_pos[2]) == 0 and int(tbl_a._n_tok[2]) == 0  # the gap row


@pytest.mark.parametrize("int8", [False, True])
def test_fused_step_masked_rows_untouched(pair, int8):
    """A row with n_req = 0 and do_dec = 0 keeps its caches and decode state
    bit for bit while another row of the same call advances."""
    _, tp = pair
    ring = _session_rings(2)[1]
    tbl = _tables(int8)[1]
    tbl.reset(0, PREFIX)
    tbl.reset(1, PREFIX)
    blocks = _blocks(2, seed=21)
    block_n = 8 * VAD_FRAME
    tbl.step(tp, ring, [0, 1], [0, 1], [0, 0], [0, 0], [1, 1], [True, True], np.stack([blocks[0]] * 2),
             max_steps=4)
    snap = {w: tbl.cache_view(w) for w in KINDS}
    state = {n: getattr(tbl, n)[1].clone() for n in ("_tokens", "_n_tok", "_fed", "_enc_pos")}
    tbl.step(tp, ring, [0, 1], [0, 1], [block_n] * 2, [CHUNK] * 2, [1, 0], [True, False],
             np.stack([blocks[1]] * 2), max_steps=4)
    assert int(tbl._enc_pos[0]) == int(state["_enc_pos"]) + 8  # row 0 advanced
    for n, v in state.items():
        assert torch.equal(getattr(tbl, n)[1], v), n
    for w in KINDS:
        got, want = tbl.cache_view(w), snap[w]
        for g, s in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
            np.testing.assert_array_equal(g[1], s[1], err_msg=w)


def test_int8_table_tracks_f32(pair):
    """The int8 table's dequantised caches follow the f32 table within a few
    per-column quantisation steps, and decode still appends tokens."""
    _, tp = pair
    tf, tq = _tables(False, slots=1)[1], _tables(True, slots=1)[1]
    _, tr = _ring_arrays(3, seed=9)
    for t in (tf, tq):
        t.reset(0, PREFIX)
        for k in range(3):
            t.encode_chunks(tp, tr, [0], [0], [k * CHUNK])
    ref = tf.cache_view("enc_k")[0]
    q8, sc = tq.cache_view("enc_k")
    got = (q8.astype(np.float32) * sc)[0]
    step = np.abs(ref).max(axis=2, keepdims=True) / 127.0
    assert np.abs(got - ref).max() <= step.max() * 4 + 1e-3
    assert int(tq.decode_steps(tp, [0], 8)[1][0]) > 4


def test_cpu_step_takes_the_plain_versions(pair, monkeypatch):
    """On CPU tensors the identity int8 step goes through the three kernel
    wrappers, which take their plain versions and count no launch (the
    cross-attention's once per decoder layer and decode step); the batcher
    closure maps rows back to submission order."""
    _, tp = pair
    plain = decode_attention.decode_cross_attention_reference
    calls = []
    monkeypatch.setattr(decode_attention, "decode_cross_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    S = 3
    ring = _session_rings(S + 1)[1]
    tbl = _tables(True, slots=S)[1]
    launches = lambda: (cache_write.windowed_write_groups.launches,  # noqa: E731
                        stream_attention.history_attention.launches, decode_attention.decode_cross_attention.launches)
    before = launches()
    fn = tbl.identity_step_fn(tp, ring, trash_slot=S, max_steps=3)
    meta = _meta([(2, 2, 0, 0, 1, 1, 1), (0, 0, 0, 0, 1, 1, 1)])
    probs, tok, n, pos = fn(meta, np.stack([_blocks(1, seed=3)[0]] * 2))
    assert probs.shape == (2, 8) and tok.shape == (2, 32)
    np.testing.assert_array_equal(pos, [8, 8])
    np.testing.assert_array_equal(tok[:, :4], np.stack([PREFIX] * 2))
    assert tbl._enc_pos.tolist() == [8, 0, 8]
    assert launches() == before
    assert len(calls) == CFG.n_text_layer * 3


def test_get_stream_table_first_creator_wins(pair, caplog):
    tag = "test-first-creator"
    a = ts.get_stream_table(tag, CFG, torch.float32, device="cpu", max_slots=2, enc_t=64, dec_t=32)
    b = ts.get_stream_table(tag, CFG, torch.float32, device="cpu", max_slots=5)
    assert a is b and b.max_slots == 2
    assert "first creator wins" in caplog.text


def test_concurrent_steps_keep_snapshots_and_counts(pair):
    """Fused steps from several threads at once (as the batcher's executor
    runs them) serialize on the step locks: every row's position advances by
    exactly what its steps committed, and a ring snapshot handed out by
    ring_ref is never written again (appends are out of place)."""
    import sys
    import threading

    _, tp = pair
    S, n_threads, n_steps = 4, 8, 2  # 4 blocks a row: exactly one ring of RS samples
    ring = _session_rings(S)[1]
    tbl = _tables(False, slots=S)[1]
    block = _blocks(1, seed=4)[0]
    snaps, errors = [], []
    counters = [0] * S
    lock = threading.Lock()

    def worker(k):
        row = k % S
        try:
            for _ in range(n_steps):
                snap = ring.ring_ref()
                snaps.append((snap, snap.clone()))
                with lock:  # one block in flight per row, as the engine keeps it
                    written = counters[row] * 8 * VAD_FRAME
                    tbl.step(tp, ring, [row], [row], [written % RS], [0], [0], [0], block[None], max_steps=1)
                    counters[row] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert counters == [n_threads // S * n_steps] * S
    for snap, copy in snaps:
        assert torch.equal(snap, copy)
    want = np.tile(block.reshape(-1), n_threads // S * n_steps)
    for row in range(S):  # every row's audio landed in order
        got = ring._ring[row, : want.size].numpy().astype(np.float32) / 32768.0
        np.testing.assert_allclose(got, want, atol=1 / 32768.0 + 1e-6)


def test_chunk_geometry_constants_match_jax():
    """The chunk's sample counts, ``GATHER`` (the samples one chunk's mel
    reads) among them, are the reference's."""
    for name in ("CHUNK_POS", "CHUNK_MEL", "CHUNK_SAMPLES", "LEFT_CTX", "RIGHT_CTX", "GATHER"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.GATHER == 3320
