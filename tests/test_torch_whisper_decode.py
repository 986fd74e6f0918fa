# SPDX-License-Identifier: Apache-2.0
"""Port parity: greedy decoding (window, ring, language detection) against
the JAX package on the CPU at f32. Tokens and lengths must be equal;
log-prob sums agree within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from streamkit_tpu.engine.audio_ring import SessionAudioRing as JRing
from streamkit_tpu.models.whisper import decode as jdec
from streamkit_tpu.models.whisper import model as jmodel
from streamkit_tpu.models.whisper.config import WhisperConfig as JConfig
from streamkit_tpu.ops.mel import log_mel_spectrogram as jmel
from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
from streamkit_tpu_torch.models.whisper import decode as tdec
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.ops.mel import log_mel_spectrogram as tmel
from streamkit_tpu_torch.ops.vad import VAD_FRAME

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(
    n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2,
)
CFG, JCFG = WhisperConfig(**DIMS), JConfig(**DIMS)
WINDOW = CFG.n_audio_ctx * 2 * 160  # samples for this context


@pytest.fixture(scope="module")
def pair():
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    # sharper, stronger cross-attention makes the random model's greedy path
    # depend on its audio (with the plain init every row decodes alike)
    for layer in jp["dec"]["layers"]:
        for name, gain in (("q", 10.0), ("k", 10.0), ("o", 3.0)):
            layer["xattn"][name]["w"] = layer["xattn"][name]["w"] * gain
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, tp


def _audio(seed, b, n=WINDOW):
    """Amplitude-modulated tones over noise, one random pitch per row."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    rows = []
    for _ in range(b):
        f, am = rng.uniform(100, 3000), rng.uniform(1, 8)
        tone = 0.3 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * am * t))
        rows.append(tone + 0.05 * rng.randn(n))
    return np.asarray(rows, np.float32)


def _biases():
    """Non-speech style suppression (every step) and blank/eot suppression
    (first token), as the whisper node builds them."""
    sup = np.zeros(CFG.n_vocab, np.float32)
    sup[[220, 1000, 2000, 30000]] = -1e9
    beg = np.zeros(CFG.n_vocab, np.float32)
    beg[[CFG.token_eot, 440]] = -1e9
    return sup, beg


@pytest.mark.parametrize("int8", [False, True], ids=["bf-cross", "int8-cross"])
def test_greedy_decode_matches_jax(pair, int8):
    jp, tp = pair
    audio = _audio(0, 3)
    sup, beg = _biases()
    mel_j = jmel(jnp.asarray(audio), CFG.n_mels)
    want = jdec.greedy_decode(jp, JCFG, mel_j, language_index=2, max_tokens=10,
                              cross_kv_int8=int8, suppress_bias=jnp.asarray(sup), begin_bias=jnp.asarray(beg))
    got = tdec.greedy_decode(tp, CFG, tmel(torch.from_numpy(audio), CFG.n_mels), language_index=2,
                             max_tokens=10, cross_kv_int8=int8, suppress_bias=sup, begin_bias=beg)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert len({tuple(r) for r in got[0]}) > 1  # rows differ: the test discriminates


def test_transcribe_window_matches_jax_and_rows_are_independent(pair):
    jp, tp = pair
    audio = _audio(1, 3, WINDOW // 2)  # shorter than the window: zero-padded
    want_t, want_l = jdec.transcribe_window(jp, JCFG, audio, window_samples=WINDOW, max_tokens=12)
    got_t, got_l = tdec.transcribe_window(tp, CFG, audio, window_samples=WINDOW, max_tokens=12)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    # row i of the batch equals row i alone
    solo_t, solo_l = tdec.transcribe_window(tp, CFG, audio[1], window_samples=WINDOW, max_tokens=12)
    np.testing.assert_array_equal(solo_t[0], got_t[1])
    assert int(solo_l[0]) == int(got_l[1])


def test_eot_ends_rows(pair):
    """A bias that makes eot win after the first token: every row stops at
    length 1 and the rest of the row is eot."""
    jp, tp = pair
    audio = _audio(2, 2)
    sup = np.zeros(CFG.n_vocab, np.float32)
    sup[CFG.token_eot] = 1e6
    beg = np.zeros(CFG.n_vocab, np.float32)
    beg[CFG.token_eot] = -1e9
    mel = jmel(jnp.asarray(audio), CFG.n_mels)
    want = jdec.greedy_decode(jp, JCFG, mel, max_tokens=12, suppress_bias=jnp.asarray(sup),
                              begin_bias=jnp.asarray(beg))
    got = tdec.greedy_decode(tp, CFG, tmel(torch.from_numpy(audio), CFG.n_mels), max_tokens=12,
                             suppress_bias=sup, begin_bias=beg)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].tolist() == [1, 1]
    assert (got[0][:, 1:] == CFG.token_eot).all()


def _rings(audio_rows, ring_samples=1 << 17):
    """One JAX and one port ring holding the same int16 audio per slot."""
    jr = JRing(max_slots=4, ring_samples=ring_samples)
    tr = SessionAudioRing(max_slots=4, ring_samples=ring_samples, device="cpu")
    slots = []
    for a in audio_rows:
        sj, st = jr.alloc(), tr.alloc()
        assert sj == st
        n = a.size // VAD_FRAME
        frames = a[: n * VAD_FRAME].reshape(1, n, VAD_FRAME)
        jr.vad_append(np.asarray([sj]), np.asarray([0]), frames)
        tr.vad_append(np.asarray([st]), np.asarray([0]), frames)
        slots.append(sj)
    return jr, tr, np.asarray(slots, np.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["bf-cross", "int8-cross"])
def test_transcribe_ring_matches_jax(pair, int8):
    """Per-row token caps (from lengths), per-row languages, both biases and
    log-probs (atol 1e-4)."""
    jp, tp = pair
    audio = _audio(3, 3)
    jr, tr, slots = _rings(list(audio))
    starts = np.asarray([0, 1024, 0], np.int32)
    lengths = np.asarray([WINDOW - 2048, 9000, 30000], np.int32)  # caps 23, 6, 11
    langs = np.asarray([0, 5, 17], np.int32)
    sup, beg = _biases()
    want = jdec.transcribe_ring(jp, JCFG, jr.ring_ref(), slots, starts, lengths, window_samples=WINDOW,
                                language_index=langs, max_tokens=12, cross_kv_int8=int8,
                                suppress_bias=jnp.asarray(sup), begin_bias=jnp.asarray(beg),
                                with_logprobs=True)
    got = tdec.transcribe_ring(tp, CFG, tr.ring_ref(), slots, starts, lengths, window_samples=WINDOW,
                               language_index=langs, max_tokens=12, cross_kv_int8=int8,
                               suppress_bias=sup, begin_bias=beg, with_logprobs=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the reference's loop lets a row with cap c ≥ 2 emit c + 1 tokens (its
    # done test runs after the write); the port keeps that
    assert got[1].tolist() == [12, 7, 12]
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)


def test_ring_decode_equals_window_decode(pair):
    """transcribe_ring == transcribe_window on the same (int16-quantized)
    audio, inside the port."""
    _, tp = pair
    audio = _audio(4, 1, WINDOW // 2)[0]
    _, tr, slots = _rings([audio])
    n = (audio.size // VAD_FRAME) * VAD_FRAME
    tok_r, len_r = tdec.transcribe_ring(tp, CFG, tr.ring_ref(), slots, [0], [n],
                                        window_samples=WINDOW, max_tokens=8)
    quant = np.clip(audio[:n] * 32768.0, -32768, 32767).astype(np.int16) / 32768.0
    tok_w, len_w = tdec.transcribe_window(tp, CFG, quant.astype(np.float32), window_samples=WINDOW,
                                          max_tokens=8)
    assert int(len_r[0]) == int(len_w[0])
    np.testing.assert_array_equal(tok_r[0].numpy(), tok_w[0])


def test_language_detection_matches_jax(pair):
    jp, tp = pair
    audio = _audio(5, 3)
    jr, tr, slots = _rings(list(audio))
    starts = np.zeros(3, np.int32)
    lengths = np.asarray([WINDOW, 20000, 50000], np.int32)
    want = np.asarray(jdec.detect_language_ring(jp, JCFG, jr.ring_ref(), slots, starts, lengths,
                                                window_samples=WINDOW))
    got = tdec.detect_language_ring(tp, CFG, tr.ring_ref(), slots, starts, lengths, window_samples=WINDOW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_detect_language_window_matches_jax():
    """The window detector always encodes a 30 s window, so it needs the
    full 1500-frame context (narrow and one layer deep here)."""
    dims = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
                n_vocab=51865, n_text_ctx=8, n_text_state=64, n_text_head=1, n_text_layer=1)
    jcfg, cfg = JConfig(**dims), WhisperConfig(**dims)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    for layer in jp["dec"]["layers"]:
        for name, gain in (("q", 10.0), ("k", 10.0), ("o", 3.0)):
            layer["xattn"][name]["w"] = layer["xattn"][name]["w"] * gain
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got = [tdec.detect_language_window(tp, cfg, row) for row in _audio(6, 3, 48000)]
    want = [jdec.detect_language_window(jp, jcfg, row) for row in _audio(6, 3, 48000)]
    assert got == want


def test_pad_or_trim_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    np.testing.assert_array_equal(tdec.pad_or_trim(x, 8), jdec.pad_or_trim(x, 8))
    np.testing.assert_array_equal(tdec.pad_or_trim(x, 3), jdec.pad_or_trim(x, 3))
