# SPDX-License-Identifier: Apache-2.0
"""The host codec kinds in both packages: the WebM muxer, the libav (FLAC)
decoder and the MP3 decoder of the port against the JAX package's, on the
same bytes (host code: equal exactly).

* WebM: the same synthetic Opus packets (no libopus needed) give the same
  bytes, header and clusters;
* FLAC: the port builds its own shim (``csrc/av_decode.cpp``) with ``g++``
  and ``pkg-config``; a verbatim FLAC of known samples decodes to them bit
  for bit, and to the JAX node's PCM where the JAX package's prebuilt shim
  exists; nothing of the port loads ``native/build``;
* MP3: where libmpg123 loads, silent MPEG-1 Layer III frames decode to the
  same PCM in both.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import streamkit_tpu.core as jax_core
import streamkit_tpu.nodes.containers.webm as jax_webm
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.nodes.containers.webm as torch_webm
from streamkit_tpu_torch.nodes import codecs as torch_codecs
from streamkit_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # chip_smoke.py's FLAC encoder

from _torch_native import point_jax_av  # noqa: E402
from chip_smoke import flac_verbatim  # noqa: E402

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

async def _drive(core, node, packets):
    in_ch, out_ch = core.Channel(4096), core.Channel(4096)
    ctx = core.NodeContext(node_name="n", inputs={"in": in_ch}, output=core.OutputSender("n", direct={"out": out_ch}))
    task = asyncio.ensure_future(node.run(ctx))
    for p in packets:
        await in_ch.send(p)
    in_ch.close()
    await task
    ctx.output.close()
    out = []
    while (item := await out_ch.recv_optional()) is not None:
        out.append(item)
    return out


def _opus_packets(n: int, seed: int) -> list:
    """Synthetic Opus packets: valid TOC bytes (10/20/40/60 ms configs,
    code 0 and code 3 with a frame count), random payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        config = int(rng.choice([1, 2, 3, 9, 16, 19, 28, 31]))
        code = 3 if i % 5 == 4 else 0
        toc = bytes([config << 3 | code])
        extra = bytes([int(rng.integers(1, 4))]) if code == 3 else b""
        out.append(toc + extra + rng.integers(0, 256, int(rng.integers(8, 160)), dtype=np.uint8).tobytes())
    return out


@pytest.mark.parametrize("params", [{}, {"cluster_duration_ms": 200}, {"channels": 2, "sample_rate": 24000}])
def test_webm_muxer_bytes_equal(params):
    packets = _opus_packets(150, seed=len(params))
    got = {}
    for pkg, (core, webm) in {"jax": (jax_core, jax_webm), "torch": (torch_core, torch_webm)}.items():
        node = webm.WebmMuxerNode(dict(params))
        outs = asyncio.run(_drive(core, node, [core.Packet.new_binary(p) for p in packets]))
        got[pkg] = [(o.content_type, o.binary) for o in outs]
    assert got["torch"] == got["jax"]
    assert got["torch"][0][1].startswith(b"\x1a\x45\xdf\xa3") and len(got["torch"]) >= 3
    assert {ct for ct, _ in got["torch"]} == {"video/webm"}


def test_webm_elements_equal():
    for ch, rate in ((1, 48000), (2, 16000)):
        assert torch_webm.webm_header(ch, rate) == jax_webm.webm_header(ch, rate)
    for ms in (-40000, -5, 0, 7, 32767, 90000):
        assert torch_webm.simple_block(b"\x08abc", ms) == jax_webm.simple_block(b"\x08abc", ms)
    assert torch_webm.cluster_header(1234, b"xyz") == jax_webm.cluster_header(1234, b"xyz")
    for n in (0, 1, 126, 127, 16382, 16383, 2 ** 40):
        assert torch_webm._vint_size(n) == jax_webm._vint_size(n)


def _flac_pcm(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.size)
    return np.clip(x * 32767, -32768, 32767).astype(np.int16)


def _decode(core, node_cls, body: bytes, piece: int = 3000):
    packets = [core.Packet.new_binary(body[i : i + piece]) for i in range(0, len(body), piece)]
    outs = asyncio.run(_drive(core, node_cls(None), packets))
    fmt = {(o.audio.format.sample_rate, o.audio.format.channels) for o in outs}
    return fmt, np.concatenate([o.audio.samples for o in outs])


@pytest.fixture(scope="module")
def flac_node():
    if not torch_codecs.flac_available():
        from streamkit_tpu_torch.nodes.codecs import av

        pytest.skip(f"the port's libav shim cannot build here: {av.unavailable_reason}")
    from streamkit_tpu_torch.nodes.codecs.av import SOURCE, AvDecoderNode

    return AvDecoderNode, SOURCE


@pytest.mark.parametrize("seconds", [0.1, 1.0, 10.0])
def test_flac_decodes_the_samples_bit_for_bit(flac_node, seconds):
    node_cls, _ = flac_node
    pcm = _flac_pcm(seconds, seed=int(seconds * 10))
    fmt, out = _decode(torch_core, node_cls, flac_verbatim(pcm))
    assert fmt == {(16000, 1)}
    np.testing.assert_array_equal(out, pcm.astype(np.float32) / 32768.0)


def test_flac_pcm_equals_the_jax_node(flac_node, monkeypatch):
    """The JAX node decodes through the shim that ``_torch_native`` builds
    from ``native/shims/av_decode.cpp``, whether or not ``native/build/``
    holds one."""
    node_cls, _ = flac_node
    from streamkit_tpu.nodes.codecs import av as jax_av

    assert point_jax_av(monkeypatch) is not None  # the port's shim built, so libav is present
    monkeypatch.setattr(jax_av.AvLib, "_lib", None)  # load the shim pointed at, not one loaded before
    body = flac_verbatim(_flac_pcm(2.0, seed=7))
    got = {pkg: _decode(core, cls, body) for pkg, core, cls in
           (("jax", jax_core, jax_av.AvDecoderNode), ("torch", torch_core, node_cls))}
    assert got["torch"][0] == got["jax"][0]
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])


def test_the_port_builds_its_own_shim(flac_node):
    """The loaded library is the port's build of ``csrc/av_decode.cpp``
    (linked as ``pkg-config`` says), never the JAX package's."""
    _, source = flac_node
    lib = source.library()
    assert lib.startswith(_build.BUILD_DIR) and os.path.exists(lib)
    assert source.pkg_config == ("libavformat", "libavcodec", "libavutil", "libswresample")
    assert source.path == os.path.join(REPO, "streamkit_tpu_torch", "csrc", "av_decode.cpp")
    from streamkit_tpu_torch.nodes.codecs.av import AvLib

    assert AvLib.get()._name == lib


def test_a_missing_system_library_fails_the_build():
    with pytest.raises(RuntimeError, match="pkg-config"):
        _build._pkg_flags(("streamkit-no-such-library",))


def test_an_absent_library_unregisters_flac_and_says_which(monkeypatch):
    from streamkit_tpu_torch.nodes.codecs import av

    if shutil.which("g++") is None or shutil.which("pkg-config") is None:
        pytest.skip("needs g++ and pkg-config to reach the library check")
    monkeypatch.setattr(av, "_available", None)
    monkeypatch.setattr(av, "SOURCE", _build.Source("av_decode.cpp", "g++", pkg_config=("streamkit-no-such-library",)))
    monkeypatch.setattr(av.AvLib, "get", staticmethod(lambda: pytest.fail("built without its library")))
    assert not torch_codecs.flac_available()
    assert "streamkit-no-such-library" in av.unavailable_reason


def test_a_failed_shim_build_raises_where_its_libraries_are_present(monkeypatch):
    """A compile error in the port's own shim is not an absent library: it
    raises out of the check, so the FLAC kind cannot vanish silently."""
    from streamkit_tpu_torch.nodes.codecs import av

    monkeypatch.setattr(av, "_available", None)
    monkeypatch.setattr(av, "_missing", lambda: "")

    def broken():
        raise RuntimeError("g++ failed: av_decode.cpp:1: error")

    monkeypatch.setattr(av.AvLib, "get", staticmethod(broken))
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        torch_codecs.flac_available()
    assert av._available is None


def _silent_mp3(frames: int) -> bytes:
    """MPEG-1 Layer III, 128 kb/s, 44.1 kHz, mono frames whose side info and
    main data are zero: each frame it decodes gives 1152 zero samples."""
    header = bytes([0xFF, 0xFB, 0x90, 0xC4])
    return (header + bytes(417 - 4)) * frames


def test_mp3_pcm_equal():
    if not torch_codecs.mp3_available():
        pytest.skip("libmpg123 does not load here")
    from streamkit_tpu.nodes.codecs.mpeg import Mp3DecoderNode as JaxMp3
    from streamkit_tpu_torch.nodes.codecs.mpeg import Mp3DecoderNode as TorchMp3

    body = _silent_mp3(40)
    got = {pkg: _decode(core, cls, body, piece=1000) for pkg, core, cls in
           (("jax", jax_core, JaxMp3), ("torch", torch_core, TorchMp3))}
    assert got["torch"][0] == got["jax"][0] == {(44100, 1)}
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])
    n = got["torch"][1].size
    assert n > 0 and n % 1152 == 0 and not got["torch"][1].any()
