# SPDX-License-Identifier: Apache-2.0
"""The port's Ogg container and Opus codec (``nodes/containers/ogg.py``,
``nodes/codecs/opus.py``) and the Opus half of its ingest shim
(``csrc/ingest.cpp``) against the JAX package's, on the CPU.

Tolerance: none. Ogg bytes, CRCs and decoded PCM are compared bit for bit
(both packages call the same system libopus on the same packets; the port's
batched decode goes through its own shim, built with g++ from
``streamkit_tpu_torch/csrc/ingest.cpp``). The kinds register only where
libopus loads; every Opus test here skips without it, as the JAX package's
own codec tests do.
"""

import os
import time

import numpy as np
import pytest
import torch

from streamkit_tpu.nodes.containers import ogg as jogg
from streamkit_tpu_torch.nodes.codecs import opus_available
from streamkit_tpu_torch.nodes.containers import ogg as togg

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEECH_OGG = os.path.join(REPO, "samples", "media", "speech_30s.ogg")


@pytest.fixture
def opus():
    """Skips where the system libopus does not load (decided at run time)."""
    if not opus_available():
        pytest.skip("libopus unavailable")


def ogg_packets(path: str) -> list:
    """The Opus packets of an Ogg/Opus file, headers left out."""
    with open(path, "rb") as f:
        data = f.read()
    out = [p for p, _ in togg.OggPageReader().feed(data)]
    return [p for p in out if not p.startswith((b"OpusHead", b"OpusTags"))]


def test_ogg_crc_equals_jax():
    rng = np.random.RandomState(0)
    assert togg.ogg_crc(b"") == 0
    for n in (1, 4, 27, 255, 4096):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert togg.ogg_crc(data) == jogg.ogg_crc(data)
    # the RFC 3533 polynomial 0x04c11db7 with no reflection: CRC of a single
    # 0x01 byte is the polynomial itself
    assert togg.ogg_crc(b"\x01") == 0x04C11DB7


@pytest.mark.parametrize("sizes,granule", [((5, 300, 4), 4242), ((0, 255, 256, 510), 7), ((3000,), 1 << 40)])
def test_ogg_page_roundtrip_equals_jax(sizes, granule):
    """The port's writer emits the JAX writer's bytes (lacing, CRC); the
    reader gives the packets back, whole or fed in 13-byte pieces."""
    rng = np.random.RandomState(len(sizes))
    pkts = [rng.randint(0, 256, n).astype(np.uint8).tobytes() for n in sizes]
    page = togg.OggPageWriter().page(pkts, granule=granule)
    assert page == jogg.OggPageWriter().page(pkts, granule=granule)
    assert [p for p, _ in togg.OggPageReader().feed(page)] == [p for p, _ in jogg.OggPageReader().feed(page)]
    out, r = [], togg.OggPageReader()
    for i in range(0, len(page), 13):
        out.extend(r.feed(page[i : i + 13]))
    assert [p for p, _ in out] == pkts and all(g == granule for _, g in out)
    assert togg.opus_head(2, 48000) == jogg.opus_head(2, 48000)
    assert togg.opus_tags() == jogg.opus_tags()


def test_ogg_reader_equals_jax_on_the_sample():
    with open(SPEECH_OGG, "rb") as f:
        data = f.read()
    want = jogg.OggPageReader().feed(data)
    got, r = [], togg.OggPageReader()
    for i in range(0, len(data), 8192):  # the file reader's chunk size
        got.extend(r.feed(data[i : i + 8192]))
    assert got == want and len(got) > 1000
    assert [togg._opus_packet_samples(p) for p, _ in got[2:50]] == [jogg._opus_packet_samples(p) for p, _ in want[2:50]]


@pytest.mark.parametrize("rate,channels", [(48000, 1), (16000, 1), (48000, 2)])
def test_opus_decode_equals_jax_on_speech_30s(opus, rate, channels):
    """Every packet of ``samples/media/speech_30s.ogg`` decodes to the JAX
    package's PCM: the port's batched decode (through its own shim) and its
    per-packet decode, against the JAX package's per-packet decode."""
    from streamkit_tpu.nodes.codecs.opus import OpusDecoder as JaxDecoder
    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder

    packets = ogg_packets(SPEECH_OGG)
    ref = JaxDecoder(rate, channels)
    want = [ref.decode(p) for p in packets]
    single = OpusDecoder(rate, channels)
    batched = OpusDecoder(rate, channels)
    got_single = [single.decode(p) for p in packets]
    got_batch = []
    for i in range(0, len(packets), 37):
        got_batch.extend(batched.decode_batch(packets[i : i + 37]))
    assert len(want) == len(got_single) == len(got_batch) > 1000
    for w, a, b in zip(want, got_single, got_batch):
        assert w.tobytes() == a.tobytes() == b.tobytes()
    # every packet decodes to the length its TOC byte gives
    toc = sum(togg._opus_packet_samples(p) for p in packets)
    assert sum(w.size for w in want) == toc * rate // 48000 * channels


def test_opus_batch_decode_goes_through_the_ports_shim(opus):
    """The batched decode loads the port's library, built from
    ``csrc/ingest.cpp`` into ``streamkit_tpu_torch/_build``, and equals the
    per-packet decode in uneven batches."""
    from streamkit_tpu_torch.engine.ingest import SOURCE
    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder, OpusEncoder, _batch_shim

    lib = _batch_shim()
    assert os.path.realpath(lib._name) == os.path.realpath(SOURCE.library())
    assert "native" not in os.path.relpath(lib._name, REPO).split(os.sep)
    sr, ch = 48000, 1
    enc = OpusEncoder(sr, ch, 64000)
    t = np.arange(sr) / sr
    audio = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    packets = [enc.encode(audio[i * 960 : (i + 1) * 960]) for i in range(40)]
    d_single, d_batch = OpusDecoder(sr, ch), OpusDecoder(sr, ch)
    singles = [d_single.decode(p) for p in packets]
    batched = []
    for i in range(0, len(packets), 7):  # uneven batches exercise offsets
        batched.extend(d_batch.decode_batch(packets[i : i + 7]))
    assert len(batched) == len(singles) == 40
    for a, b in zip(singles, batched):
        assert a.tobytes() == b.tobytes()


def test_opus_native_rate_decode(opus):
    """``sample_rate: 16000`` decodes natively at 16 kHz (the basis of the
    compiler's decode-resample fusion); rates libopus cannot synthesize are
    refused, as in the JAX package."""
    from streamkit_tpu.nodes.codecs.opus import OpusDecoderNode as JaxNode
    from streamkit_tpu_torch.core.errors import ConfigurationError
    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder, OpusDecoderNode, OpusEncoder

    sr, f0 = 48000, 440.0
    t = np.arange(sr, dtype=np.float32) / sr
    pcm = (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
    enc = OpusEncoder(sr, 1)
    packets = [enc.encode(pcm[i : i + 960]) for i in range(0, sr - 960, 960)]
    out = np.concatenate(OpusDecoder(16000, 1).decode_batch(packets))
    assert len(out) == len(packets) * 320  # 20 ms packets → 320 samples at 16 kHz
    tail = out[len(out) // 2 :]
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    peak_hz = (np.argmax(spec[1:]) + 1) * 16000 / len(tail)
    assert abs(peak_hz - f0) < 15.0, peak_hz
    node = OpusDecoderNode({"channels": 1, "sample_rate": 16000})
    assert repr(node.output_pins()) == repr(JaxNode({"channels": 1, "sample_rate": 16000}).output_pins())
    assert node.output_pins()[0].produces_type.audio_format.sample_rate == 16000
    with pytest.raises(ConfigurationError):
        OpusDecoderNode({"sample_rate": 22050})


def _drain_all(pool, timeout_s: float = 20.0) -> np.ndarray:
    got = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        ids, _arr, blocks = pool.drain(timeout_us=200_000)
        got.extend(blocks[i] for i in range(len(ids)))
        if pool.active() == 0 and pool.pending() == 0:
            break
    return np.stack(got) if got else np.zeros((0, pool.block_samples), np.float32)


def test_start_replay_opus_drains_the_reference_shims_blocks(opus):
    """The port's Opus replay (its own shim) and the JAX package's (the
    reference shim) drain the same 256 ms blocks from the sample's packets,
    decoded natively at 16 kHz, bit for bit; the port's shim refuses a push
    while its replay runs."""
    if not os.path.exists(os.path.join(REPO, "native", "build", "libskit_ingest.so")):
        pytest.skip("the reference shim native/build/libskit_ingest.so is not built")
    from streamkit_tpu.engine.ingest import IngestPool as JaxPool
    from streamkit_tpu_torch.engine.ingest import IngestPool

    packets = ogg_packets(SPEECH_OGG)[:400]
    n16 = sum(togg._opus_packet_samples(p) for p in packets) // 3  # samples at 16 kHz
    out = {}
    for name, cls in (("jax", JaxPool), ("torch", IngestPool)):
        pool = cls(2, 4096)
        sid = pool.open()
        pool.start_replay_opus(sid, packets, sample_rate=16_000, channels=1, frame_us=0 if name == "jax" else 2_000)
        if name == "torch":
            with pytest.raises(RuntimeError, match="replay"):
                pool.push(sid, np.zeros(10, np.float32))
        out[name] = _drain_all(pool)
        pool.close()
    assert out["torch"].shape == out["jax"].shape == (n16 // 4096, 4096)
    assert out["torch"].tobytes() == out["jax"].tobytes()
