# SPDX-License-Identifier: Apache-2.0
"""The whole slice: concurrent sessions stream audio through ``vad_ring``
and decode their segments through ``whisper_ring`` (plus ``whisper_detect``)
on a DeviceBatcher, registered as the whisper node registers them. The
port and the JAX package, given the same weights and audio, must produce
the same VAD probabilities (rtol 1e-5), languages and tokens."""

import asyncio

import numpy as np
import torch

import jax
import jax.numpy as jnp

from streamkit_tpu.engine.audio_ring import SessionAudioRing as JRing
from streamkit_tpu.engine.batcher import DeviceBatcher as JBatcher
from streamkit_tpu.models.whisper import decode as jdec
from streamkit_tpu.models.whisper import model as jmodel
from streamkit_tpu.models.whisper.config import WhisperConfig as JConfig
from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
from streamkit_tpu_torch.engine.batcher import DeviceBatcher
from streamkit_tpu_torch.models.whisper import decode as tdec
from streamkit_tpu_torch.models.whisper.config import WhisperConfig
from streamkit_tpu_torch.models.whisper.load import params_from_numpy
from streamkit_tpu_torch.ops.vad import VAD_FRAME

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

DIMS = dict(
    n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
    n_vocab=51865, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2,
)
WINDOW = DIMS["n_audio_ctx"] * 2 * 160
BLOCK_FRAMES = 4  # the whisper node's default vad_block_frames
MAX_TOKENS = 10


def _session_audio(seed):
    """Tone bursts between near-silence, 2.6 s."""
    rng = np.random.RandomState(seed)
    n = 5 * BLOCK_FRAMES * VAD_FRAME * 4
    t = np.arange(n) / 16000.0
    x = 0.002 * rng.randn(n)
    f = rng.uniform(150, 2500)
    x[n // 4 : 3 * n // 4] += 0.3 * np.sin(2 * np.pi * f * t[n // 4 : 3 * n // 4])
    return x.astype(np.float32)


async def _drive(batcher, ring, stt, detect, audios):
    """Register the slice's kinds like whisper_node.py and run sessions."""
    batcher.register("vad_ring:4", lambda s, st, f: ring.vad_append(s, st, f), max_batch=128)
    batcher.register("whisper_detect:t:%d" % WINDOW, detect)
    batcher.register("whisper_ring:t:%d" % WINDOW, stt, gather_ms=300.0)
    batcher.set_expected("whisper_ring:t:%d" % WINDOW, len(audios))
    batcher.start()

    async def session(audio):
        slot = ring.alloc()
        written, probs = 0, []
        block = BLOCK_FRAMES * VAD_FRAME
        for i in range(len(audio) // block):
            frames = audio[i * block : (i + 1) * block].reshape(BLOCK_FRAMES, VAD_FRAME)
            p = await batcher.submit("vad_ring:4", np.int32(slot), np.int32(written % ring.ring_samples), frames)
            probs.append(np.asarray(p))
            written += block
        lang = await batcher.submit("whisper_detect:t:%d" % WINDOW, np.int32(slot), np.int32(0), np.int32(written))
        tokens, length, lp = await batcher.submit(
            "whisper_ring:t:%d" % WINDOW, np.int32(slot), np.int32(0), np.int32(written), np.int32(lang)
        )
        return np.concatenate(probs), int(lang), np.asarray(tokens), int(length), float(lp)

    out = await asyncio.gather(*(session(a) for a in audios))
    batcher.stop()
    return out, batcher.stats()


def test_slice_port_equals_jax_through_the_batcher():
    jcfg, cfg = JConfig(**DIMS), WhisperConfig(**DIMS)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    for layer in jp["dec"]["layers"]:
        for name, gain in (("q", 10.0), ("k", 10.0), ("o", 3.0)):
            layer["xattn"][name]["w"] = layer["xattn"][name]["w"] * gain
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    audios = [_session_audio(s) for s in range(3)]

    jr = JRing(max_slots=8, ring_samples=1 << 17)

    def j_stt(slot_ids, starts, lengths, lang_rows):
        return jdec.transcribe_ring(jp, jcfg, jr.ring_ref(), slot_ids, starts, lengths,
                                    window_samples=WINDOW, language_index=np.asarray(lang_rows, np.int32),
                                    max_tokens=MAX_TOKENS, with_logprobs=True)

    def j_detect(slot_ids, starts, lengths):
        return (np.asarray(jdec.detect_language_ring(jp, jcfg, jr.ring_ref(), slot_ids, starts, lengths,
                                                     window_samples=WINDOW)),)

    tr = SessionAudioRing(max_slots=8, ring_samples=1 << 17, device="cpu")

    def t_stt(slot_ids, starts, lengths, lang_rows):
        return tdec.transcribe_ring(tp, cfg, tr.ring_ref(), slot_ids, starts, lengths,
                                    window_samples=WINDOW, language_index=lang_rows,
                                    max_tokens=MAX_TOKENS, with_logprobs=True)

    def t_detect(slot_ids, starts, lengths):
        return tdec.detect_language_ring(tp, cfg, tr.ring_ref(), slot_ids, starts, lengths,
                                         window_samples=WINDOW)

    want, _ = asyncio.run(_drive(JBatcher(tick_ms=2.0), jr, j_stt, j_detect, audios))
    got, stats = asyncio.run(_drive(DeviceBatcher(tick_ms=2.0, device="cpu"), tr, t_stt, t_detect, audios))

    assert stats["kinds"]["vad_ring:4"]["items"] == 3 * len(audios[0]) // (BLOCK_FRAMES * VAD_FRAME)
    assert stats["kinds"]["whisper_ring:t:%d" % WINDOW]["items"] == 3
    for (pw, lw, tw, nw, lpw), (pg, lg, tg, ng, lpg) in zip(want, got):
        np.testing.assert_allclose(pg, pw, rtol=1e-5, atol=1e-7)
        assert lg == lw
        np.testing.assert_array_equal(tg, tw)
        assert ng == nw > 0
        np.testing.assert_allclose(lpg, lpw, atol=1e-4)
    np.testing.assert_array_equal(tr.ring_ref().numpy(), np.asarray(jr.ring_ref()))
    assert len({tuple(g[2]) for g in got}) > 1  # sessions decode differently
