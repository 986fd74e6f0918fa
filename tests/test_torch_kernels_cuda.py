# SPDX-License-Identifier: Apache-2.0
"""The port's hand-written CUDA kernels against their plain versions, on an
NVIDIA card. Skips without one. This file imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from streamkit_tpu_torch.ops import attention as tattn
from streamkit_tpu_torch.ops import cache_write as tcw
from streamkit_tpu_torch.ops import stream_attention as tsa


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [(1, 20, 1500, 64), (4, 20, 400, 64), (2, 3, 300, 64), (3, 1, 37, 64), (1, 2, 257, 128),
     # the 128-row tiles' edges: one past a tile, one short of three, T = 1500 at d = 128
     (1, 2, 129, 64), (1, 2, 383, 64), (1, 2, 383, 128), (1, 1, 1500, 128)],
)
def test_flash_attention_matches_plain(dtype, shape):
    """Kernel vs the plain version run in f32 (f32 atol 1e-4; bf16 within
    twice the plain version's own bf16 error on the same inputs), reading
    head-split views of [B, T, H*d] projections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (
        torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype).reshape(b, t, h, d).transpose(1, 2)
        for _ in range(3)
    )
    before = tattn.flash_attention.launches
    out = tattn.flash_attention(q, k, v, d ** -0.25)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = tattn.attention_reference(q.float(), k.float(), v.float(), d ** -0.25)
    if dtype == torch.float32:
        tol = 1e-4
    else:
        tol = 2 * (tattn.attention_reference(q, k, v, d ** -0.25).float() - ref).abs().max().item()
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention(q, q, q, 0.5)
    q = torch.zeros(1, 2, 256, 96, device="cuda")
    with pytest.raises(ValueError, match="unsupported shape"):
        tattn.flash_attention(q, q, q, 0.5)
    q = torch.zeros(1, 2, 64, 256, device="cuda").transpose(-1, -2)
    with pytest.raises(ValueError, match="unit head_dim stride"):
        tattn.flash_attention(q, q, q, 0.5)
    q = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale > 0"):
        tattn.flash_attention(q, q, q, 0.0)
    # TMA: a base 2 bytes off a 16-byte boundary, a time stride of 264 bytes
    off = torch.zeros(2 * 256 * 64 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(1, 2, 256, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.flash_attention(off, off, off, 0.5)
    odd = torch.zeros(1, 256, 132, device="cuda", dtype=torch.bfloat16)[..., :128].reshape(1, 256, 2, 64)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tattn.flash_attention(*(odd.transpose(1, 2),) * 3, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "G,S,F,T,c,dtype",
    [
        (32, 3, 1280, 512, 16, torch.int8),  # encoder caches
        (32, 3, 20, 512, 16, torch.float32),  # their scales
        (32, 3, 1280, 64, 3, torch.bfloat16),  # decoder folds
        (2, 2, 5, 37, 37, torch.float64),  # odd sizes, window = ring
    ],
)
def test_windowed_write_matches_plain(G, S, F, T, c, dtype):
    """Bit-exact against the plain version, with a wrapping row and a lim = 0 row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(1)
    if dtype == torch.int8:
        cache = torch.randint(-127, 128, (G, S, F, T), device="cuda", generator=g, dtype=torch.int8)
        upd = torch.randint(-127, 128, (G, S, F, c), device="cuda", generator=g, dtype=torch.int8)
    else:
        cache = torch.randn(G, S, F, T, device="cuda", generator=g).to(dtype)
        upd = torch.randn(G, S, F, c, device="cuda", generator=g).to(dtype)
    pos = torch.tensor([T - 2, 0, 8][:S], dtype=torch.int32, device="cuda")
    lim = torch.tensor([c, 0, max(c - 1, 1)][:S], dtype=torch.int32, device="cuda")
    want = tcw.windowed_write_reference(cache.clone(), upd, pos, lim)
    before = tcw.windowed_write_groups.launches
    got = tcw.windowed_write_groups(cache, upd, pos, lim)
    torch.cuda.synchronize()
    assert got is cache and tcw.windowed_write_groups.launches == before + 1
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _k2_rand(shape, dtype, g):
    if dtype in (torch.int8, torch.int16):
        return torch.randint(-127, 128, shape, device="cuda", generator=g, dtype=dtype)
    return torch.randn(shape, device="cuda", generator=g).to(dtype)


def _k2_offset(shape, dtype, g, off):
    """A contiguous [shape] tensor whose base lies ``off`` elements past an
    allocation's (so its byte alignment is the element size's)."""
    n = 1
    for d in shape:
        n *= d
    return _k2_rand((n + off,), dtype, g)[off:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "bases-one-element-off"])
@pytest.mark.parametrize("full", [True, False], ids=["lim-c", "lim-random"])
@pytest.mark.parametrize(
    "G,F,T,c,dtype",
    [
        (2, 64, 512, 16, torch.int8),  # encoder caches
        (2, 20, 512, 16, torch.float32),  # their scales
        (2, 64, 64, 3, torch.bfloat16),  # decoder folds
        (2, 5, 37, 11, torch.float64),  # odd sizes
        (2, 5, 37, 37, torch.float64),  # window = ring
    ],
)
def test_windowed_write_start_sweep(G, F, T, c, dtype, full, off):
    """Bit-exact against the plain version for every start column 0..17 and
    T-9..T-1, pos < 0 and pos >= T (one slot each), so every access width
    the runtime alignment picks, the wrap included, runs; with full windows
    and with random lim in 0..c+2, and with cache and upd bases one element
    off their allocation's alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(4)
    starts = list(range(18)) + list(range(T - 9, T)) + [-5, T + 3]
    S = len(starts)
    cache, upd = _k2_offset((G, S, F, T), dtype, g, off), _k2_offset((G, S, F, c), dtype, g, off)
    pos = torch.tensor(starts, dtype=torch.int32, device="cuda")
    lim = (torch.full((S,), c, dtype=torch.int32, device="cuda") if full
           else torch.randint(0, c + 3, (S,), device="cuda", generator=g, dtype=torch.int32))
    want = tcw.windowed_write_reference(cache.clone(), upd, pos, lim)
    before = tcw.windowed_write_groups.launches
    tcw.windowed_write_groups(cache, upd, pos, lim)
    torch.cuda.synchronize()
    assert tcw.windowed_write_groups.launches == before + 1
    assert torch.equal(cache.view(torch.uint8), want.view(torch.uint8))


def _k2_pairs(specs, S, g):
    return [(_k2_rand((G, S, F, T), dt, g), _k2_rand((G, S, F, c), dt, g)) for G, F, T, c, dt in specs]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "specs,chunked",
    [
        # the fused step's encoder write: 4 int8 caches, each with its f32 scales
        ([(32, 1280, 512, 16, torch.int8), (32, 20, 512, 16, torch.float32)] * 4, True),
        # its decoder folds (bf16, dec_t 64, 3 steps at any start)
        ([(32, 1280, 64, 3, torch.bfloat16)] * 2, False),
        # mixed element sizes and shapes, an empty pair (G = 0) among them
        ([(2, 16, 128, 8, torch.int8), (0, 8, 64, 8, torch.float32), (3, 33, 40, 7, torch.bfloat16),
          (1, 3, 24, 24, torch.float64), (2, 9, 100, 5, torch.int16)], False),
    ],
    ids=["encoder-8-pairs", "fold-pair", "mixed"],
)
def test_windowed_write_many_matches_plain(specs, chunked):
    """One launch over every pair, bit-exact against the plain version
    looped over the pairs; a wrapping row, a lim = 0 row, a lim > c row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(5)
    S = 3
    pairs = _k2_pairs(specs, S, g)
    T_min, c_max = min(s[2] for s in specs), max(s[3] for s in specs)
    pos = torch.tensor([T_min - (8 if chunked else 2), 8, 16 if chunked else 13], dtype=torch.int32, device="cuda")
    lim = torch.tensor([c_max, 0, c_max + 4], dtype=torch.int32, device="cuda")
    want = [tcw.windowed_write_reference(cache.clone(), upd, pos, lim) for cache, upd in pairs]
    before = tcw.windowed_write_groups.launches
    tcw.windowed_write_many(pairs, pos, lim)
    torch.cuda.synchronize()
    assert tcw.windowed_write_groups.launches == before + 1
    for (cache, _), w in zip(pairs, want):
        assert torch.equal(cache.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.cuda
def test_windowed_write_many_refuses_cpu_cuda_mixes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos, lim = torch.zeros(3, dtype=torch.int32), torch.full((3,), 8, dtype=torch.int32)
    on_card = (torch.zeros(2, 3, 4, 16, device="cuda"), torch.zeros(2, 3, 4, 8, device="cuda"))
    on_host = (torch.zeros(2, 3, 4, 16), torch.zeros(2, 3, 4, 8))
    before = tcw.windowed_write_groups.launches
    for pairs in ([on_card, on_host], [on_host, on_card], [(on_card[0], on_host[1])]):
        with pytest.raises(ValueError, match="one device"):
            tcw.windowed_write_many(pairs, pos, lim)
    assert tcw.windowed_write_groups.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,c,hd,T", [(4, 20, 16, 64, 512), (2, 3, 8, 32, 200), (1, 2, 24, 128, 77)])
def test_history_attention_matches_plain(dtype, B, H, c, hd, T):
    """Kernel vs the plain version run in f32 (f32 atol 1e-4; bf16 within
    twice the plain version's own bf16 error), one fresh row (pos = 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(2)
    i8 = lambda *s: torch.randint(-127, 128, s, device="cuda", generator=g, dtype=torch.int8)  # noqa: E731
    sc = lambda *s: torch.rand(s, device="cuda", generator=g) * 0.02 + 0.001  # noqa: E731
    q32 = torch.randn(B, H, c, hd, device="cuda", generator=g) * 0.3
    kw = dict(k8=i8(B, H, hd, T), ks=sc(B, H, T), v8=i8(B, H, hd, T), vs=sc(B, H, T),
              ck8=i8(B, H, hd, c), cks=sc(B, H, c), cv8=i8(B, H, hd, c), cvs=sc(B, H, c))
    pos = torch.tensor([0, T, 3, 100][:B], dtype=torch.int32, device="cuda")
    op = hd ** -0.25
    before = tsa.history_attention.launches
    out = tsa.history_attention(q32.to(dtype), **kw, pos=pos, op_scale=op)
    torch.cuda.synchronize()
    assert tsa.history_attention.launches == before + 1
    ref = tsa.history_attention_reference(q32.to(dtype).float(), **kw, pos=pos, op_scale=op)
    if dtype == torch.float32:
        tol = 1e-4
    else:
        tol = 2 * (tsa.history_attention_reference(q32.to(dtype), **kw, pos=pos, op_scale=op) - ref).abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,c,hd,T",
    [(4, 2, 8, 32, 256), (4, 2, 24, 128, 256), (4, 2, 32, 32, 384), (4, 2, 32, 128, 300), (4, 3, 16, 64, 1500)],
)
def test_history_attention_tile_edges(B, H, c, hd, T):
    """bf16 kernel at its 128-column tiles' edges (histories of 127, 128, 129
    columns and a full one), padded 16-row tiles (c = 8, 24) and T with no
    16-byte rows (300: 4-byte copies): within twice the plain version's own
    bf16 error of the plain version run in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    i8 = lambda *s: torch.randint(-127, 128, s, device="cuda", generator=g, dtype=torch.int8)  # noqa: E731
    sc = lambda *s: torch.rand(s, device="cuda", generator=g) * 0.02 + 0.001  # noqa: E731
    qs = (torch.randn(B, H, c, hd, device="cuda", generator=g) * 0.3).to(torch.bfloat16)
    kw = dict(k8=i8(B, H, hd, T), ks=sc(B, H, T), v8=i8(B, H, hd, T), vs=sc(B, H, T),
              ck8=i8(B, H, hd, c), cks=sc(B, H, c), cv8=i8(B, H, hd, c), cvs=sc(B, H, c))
    pos = torch.tensor([127, 128, 129, T], dtype=torch.int32, device="cuda")
    op = hd ** -0.25
    out = tsa.history_attention(qs, **kw, pos=pos, op_scale=op)
    torch.cuda.synchronize()
    ref = tsa.history_attention_reference(qs.float(), **kw, pos=pos, op_scale=op)
    tol = 2 * (tsa.history_attention_reference(qs, **kw, pos=pos, op_scale=op) - ref).abs().max().item()
    assert (out - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_fused_stream_step_on_cuda_matches_cpu():
    """Fused identity-mode int8 steps on the card (K2 twice per call: all
    encoder-cache appends, then both decoder folds; K3 once per encoder
    layer per call) against the same steps on the CPU: equal
    tokens and positions, int8 codes off by at most one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
    from streamkit_tpu_torch.models.whisper import StreamTable, WhisperConfig, init_params

    cfg = WhisperConfig(n_mels=80, n_audio_ctx=64, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_vocab=512, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2)
    S, block = 2, 8 * 512
    rng = np.random.RandomState(0)
    audio = (rng.randn(S, 3 * block) * 0.2).astype(np.float32)
    prefix = [1, 2, 3, 4]

    def run(device, params):
        ring = SessionAudioRing(max_slots=S, ring_samples=1 << 14, device=device)
        for _ in range(S):
            ring.alloc()
        tbl = StreamTable(cfg, torch.float32, max_slots=S, enc_t=64, dec_t=32, kv_int8=True, device=device)
        tip = 0
        for step in range(3):
            written = step * block
            n_req = max(0, min((written + block - 200 - tip) // 2560, 2))
            meta = np.asarray([[s, s, written, tip, n_req, int(step > 0), int(step == 0)] + prefix
                               for s in range(S)], np.int32)
            tbl.step(params, ring, meta, None, None, None, None, None,
                     audio[:, written : written + block].reshape(S, 8, 512), max_steps=3)
            tip += n_req * 2560
        return tbl

    cpu = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    gpu = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu").to("cuda")
    before = (tcw.windowed_write_groups.launches, tsa.history_attention.launches)
    tg = run("cuda", gpu)
    torch.cuda.synchronize()
    launched = (tcw.windowed_write_groups.launches - before[0], tsa.history_attention.launches - before[1])
    tc = run("cpu", cpu)
    assert launched == (6, 6)
    for name in ("_tokens", "_n_tok", "_enc_pos"):
        assert torch.equal(getattr(tg, name).cpu(), getattr(tc, name)), name
    codes = np.abs(tg.cache_view("enc_k")[0].astype(int) - tc.cache_view("enc_k")[0].astype(int))
    assert codes.max() <= 1 and (codes > 0).mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["transcribe-window", "ring-batcher-auto-language"])
def test_whisper_node_pipeline_on_cuda_matches_cpu(batched):
    """A oneshot STT pipeline through the port's registry and WhisperNode,
    at a small f32 config whose encoder takes K1 (1500 positions, head dim
    64), on the card and on the CPU: the same Transcription JSON lines
    (text, language, segment bounds, and finality by order; confidence
    within 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio
    import io
    import json
    import wave

    import numpy as np

    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.core import NodeRegistry, ResourceManager
    from streamkit_tpu_torch.engine import DeviceBatcher, run_oneshot_pipeline
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.nodes import register_nodes
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    WHISPER_CONFIGS["card-node-test"] = WhisperConfig(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=51865,
        n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)
    x = np.concatenate([np.zeros(8000, np.float32), synth_speech(2.5, seed=21), np.zeros(16000, np.float32)])
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    body = buf.getvalue()
    pipeline = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": {
            "model_size": "card-node-test", "dtype": "float32", "max_tokens": 12,
            "language": "auto" if batched else "en"}},
        {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
        {"kind": "streamkit::http_output"}]})

    def run(device):
        async def main():
            reg = NodeRegistry()
            register_nodes(reg, device=device)
            batcher = DeviceBatcher(device=device) if batched else None

            async def stream():
                yield body

            result = await run_oneshot_pipeline(reg, pipeline, input_stream=stream(), resources=ResourceManager(),
                                                batcher=batcher)
            out = await result.read_all()
            if batcher is not None:
                batcher.stop()
            return [json.loads(line)["Transcription"] for line in out.decode().splitlines() if line.strip()]

        return asyncio.run(main())

    try:
        before = tattn.flash_attention.launches
        got = run("cuda")
        launched = tattn.flash_attention.launches - before
        want = run("cpu")
    finally:
        WHISPER_CONFIGS.pop("card-node-test", None)
    assert got and launched > 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["text"], a["language"]) == (b["text"], b["language"])
        sa, sb = a["segments"][0], b["segments"][0]
        assert (sa["start_time_ms"], sa["end_time_ms"]) == (sb["start_time_ms"], sb["end_time_ms"])
        assert (sa["confidence"] is None) == (sb["confidence"] is None)
        if sb["confidence"] is not None:
            assert abs(sa["confidence"] - sb["confidence"]) <= 1e-4


@pytest.mark.cuda
def test_server_stt_request_on_cuda_matches_cpu():
    """The same multipart oneshot request (a small f32 Whisper whose encoder
    takes K1) to a server on ``cuda`` and to one on ``cpu``, through real
    sockets and the port's client: equal Transcription lines, and K1
    launches on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio
    import io
    import json
    import wave

    import numpy as np

    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.server import ServerConfig, create_app
    from streamkit_tpu_torch.server.http import AppRunner, ClientSession, FormData
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    WHISPER_CONFIGS["card-server-test"] = WhisperConfig(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=51865,
        n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)
    x = np.concatenate([np.zeros(8000, np.float32), synth_speech(2.5, seed=21), np.zeros(16000, np.float32)])
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    doc = {"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": {"model_size": "card-server-test", "dtype": "float32",
                                                       "max_tokens": 12, "language": "en"}},
        {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
        {"kind": "streamkit::http_output"}]}

    def ask(device):
        async def main():
            cfg = ServerConfig()
            cfg.moq_enabled = False
            runner = AppRunner(create_app(cfg, device=device))
            port = await runner.start("127.0.0.1", 0)
            try:
                form = FormData()
                form.add_field("config", json.dumps(doc))  # JSON is YAML
                form.add_field("media", buf.getvalue(), filename="in.wav", content_type="audio/wav")
                resp = await ClientSession(timeout=300).post(f"http://127.0.0.1:{port}/api/v1/process", data=form)
                body = await resp.read()
                assert resp.status == 200, body
            finally:
                await runner.cleanup()
            return [json.loads(line)["Transcription"] for line in body.decode().splitlines() if line.strip()]

        return asyncio.run(main())

    try:
        before = tattn.flash_attention.launches
        got = ask("cuda")
        launched = tattn.flash_attention.launches - before
        want = ask("cpu")
    finally:
        WHISPER_CONFIGS.pop("card-server-test", None)
    assert got and launched > 0 and len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["text"], a["language"]) == (b["text"], b["language"])
        sa, sb = a["segments"][0], b["segments"][0]
        assert (sa["start_time_ms"], sa["end_time_ms"]) == (sb["start_time_ms"], sb["end_time_ms"])
        assert (sa["confidence"] is None) == (sb["confidence"] is None)
        if sb["confidence"] is not None:
            assert abs(sa["confidence"] - sb["confidence"]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("rate,channels", [(48000, 1), (44100, 2)])
def test_slot_table_resampler_on_cuda_matches_host(rate, channels):
    """The resampler node's slot-table route on the card (``compat: exact``,
    ``backend: device``, a ``DeviceBatcher``): 8 concurrent oneshot requests
    through the port's registry give, byte for byte, the responses of the
    same requests without a batcher (the node's host ``LinearResampler``).
    Each input ends 333 frames past a whole chunk, so the end-of-file flush
    runs through the slot table too; after the requests every slot is free."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio
    import struct

    import numpy as np

    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.core import NodeRegistry
    from streamkit_tpu_torch.engine import DeviceBatcher, run_oneshot_pipeline
    from streamkit_tpu_torch.nodes import register_nodes
    from streamkit_tpu_torch.nodes.audio.filters import resampler_slot_table

    S, frames = 8, 25 * 960 + 333
    registry = NodeRegistry()
    register_nodes(registry, device="cuda")
    pipeline = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "audio::resampler", "params": {"target_sample_rate": 16000, "chunk_frames": 960,
                                                "output_frame_size": 320, "compat": "exact", "backend": "device"}},
        {"kind": "containers::wav::muxer", "params": {"bits": 32}}, {"kind": "streamkit::http_output"}]})
    rng = np.random.RandomState(rate + channels)
    bodies = []
    for _ in range(S):
        data = (rng.randn(frames * channels) * 0.5).astype("<f4").tobytes()
        bodies.append(b"".join([b"RIFF", struct.pack("<I", 36 + len(data)), b"WAVE", b"fmt ",
                                struct.pack("<IHHIIHH", 16, 3, channels, rate, rate * channels * 4, channels * 4, 32),
                                b"data", struct.pack("<I", len(data)), data]))

    async def one(body, batcher):
        async def stream():
            yield body

        result = await run_oneshot_pipeline(registry, pipeline, input_stream=stream(), batcher=batcher)
        return await result.read_all()

    async def run(batched):
        batcher = DeviceBatcher(device="cuda") if batched else None
        got = await asyncio.gather(*(one(b, batcher) for b in bodies))
        if batcher is not None:
            batcher.stop()
        return got, batcher

    got, batcher = asyncio.run(run(True))
    want, _ = asyncio.run(run(False))
    stats = batcher.stats()
    kind = f"resample:{rate}:16000:960:{channels}"
    assert stats["kinds"][kind]["items"] == S * 26  # 25 whole chunks and the end-of-file flush
    assert stats["device_calls"] < stats["submissions"]  # the sessions batched
    table = resampler_slot_table(rate, 16000, 960, channels, "cuda")
    assert table.device.type == "cuda" and table.in_use == 0
    for i in range(S):
        assert len(got[i]) > 44 and got[i] == want[i], i


@pytest.mark.cuda
def test_cuda_aliases_share_one_ring_table_and_model():
    """``cuda`` and ``cuda:0`` name one device: one audio ring, one stream
    table, one resampler slot table and one whisper model load."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio

    from streamkit_tpu_torch.core import NodeRegistry, ResourceManager
    from streamkit_tpu_torch.device import resolve_device
    from streamkit_tpu_torch.engine import DeviceBatcher, get_audio_ring
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig, get_stream_table
    from streamkit_tpu_torch.nodes import register_nodes
    from streamkit_tpu_torch.nodes.audio.filters import _resampler_slot_kind

    torch.cuda.set_device(0)
    assert resolve_device("cuda") == resolve_device("cuda:0") == torch.device("cuda", 0)
    assert get_audio_ring("cuda") is get_audio_ring("cuda:0")
    cfg = WhisperConfig(n_mels=80, n_audio_ctx=64, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                        n_vocab=51865, n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=1)
    a = get_stream_table("cuda-alias", cfg, torch.float32, device="cuda", max_slots=1, enc_t=64, dec_t=16)
    assert a is get_stream_table("cuda-alias", cfg, torch.float32, device="cuda:0", max_slots=1, enc_t=64, dec_t=16)
    batcher = DeviceBatcher(device="cuda")
    _, ta, sa = _resampler_slot_kind(batcher, 32000, 16000, 960, 1, "cuda")
    _, tb, sb = _resampler_slot_kind(batcher, 32000, 16000, 960, 1, "cuda:0")
    assert ta is tb
    ta.free(sa)
    tb.free(sb)
    WHISPER_CONFIGS["cuda-alias"] = cfg
    try:
        resources = ResourceManager()

        class Ctx:
            pass

        Ctx.resources = resources
        for device in ("cuda", "cuda:0"):
            reg = NodeRegistry()
            register_nodes(reg, device=device)
            node = reg.create_node("plugin::native::whisper", {"model_size": "cuda-alias"})
            asyncio.run(node._load_model(Ctx()))
        assert resources.misses == 1 and resources.hits == 1
    finally:
        WHISPER_CONFIGS.pop("cuda-alias", None)


@pytest.mark.cuda
def test_engine_and_node_have_equal_parameters_on_cuda():
    """The serving engine and the whisper node draw one model for one
    config on the card: every parameter tensor is equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import asyncio

    from streamkit_tpu_torch.core import ResourceManager
    from streamkit_tpu_torch.engine import SttServingEngine
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.nodes.ml.whisper_node import WhisperNode

    WHISPER_CONFIGS["cuda-draw"] = WhisperConfig(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2,
                                                 n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
                                                 n_text_head=2, n_text_layer=2)
    try:
        eng = SttServingEngine(model_size="cuda-draw", dtype="float32", max_sessions=1, window_buckets=[1.0],
                               device="cuda")

        async def start_stop():
            await eng.start()
            await eng.stop()

        asyncio.run(start_stop())

        class Ctx:
            resources = ResourceManager()

        _, node_params, _ = asyncio.run(WhisperNode({"model_size": "cuda-draw"}, device="cuda")._load_model(Ctx()))
    finally:
        WHISPER_CONFIGS.pop("cuda-draw", None)
    eng_sd, node_sd = eng._params.state_dict(), node_params.state_dict()
    assert eng_sd.keys() == node_sd.keys() and len(eng_sd) > 10
    for k in eng_sd:
        assert eng_sd[k].device.type == "cuda" and torch.equal(eng_sd[k], node_sd[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [1, 4])
def test_nllb_step_and_decode_on_cuda_match_cpu(beam):
    """A small NLLB at f32 (the translate node's random configuration): the
    cached decode step's logits on the card within 1e-4 of the CPU's, and
    greedy / beam-4 tokens and lengths equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from streamkit_tpu_torch.models import nllb
    from streamkit_tpu_torch.nodes.ml.translate_node import RANDOM_INIT_CONFIG as cfg

    out = {}
    src = torch.randint(4, 260, (3, 16), generator=torch.Generator().manual_seed(0))
    src[1, 9:] = cfg.pad_token_id
    for dev in ("cpu", "cuda"):
        params = nllb.nllb_init_params(cfg, 0, device=dev)
        enc, bias = nllb.nllb_encode(params, cfg, src.to(dev))
        cache = nllb._nllb_init_cache(params, cfg, enc, 4)
        logits, _ = nllb.nllb_decode_step(params, cfg, torch.full((3,), 2, device=dev), 0, cache, bias)
        if beam == 1:
            toks, lens = nllb.nllb_greedy_cached(params, cfg, src.to(dev), 3, max_tokens=16)
        else:
            toks, lens = nllb.nllb_beam_translate(params, cfg, src.to(dev), 3, max_tokens=16, beam=beam)
        out[dev] = (logits.cpu(), toks.cpu(), lens.cpu())
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-4
    assert torch.equal(out["cuda"][1], out["cpu"][1]) and torch.equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.cuda
def test_vits_synthesize_on_cuda_matches_cpu():
    """facebook/mms-tts-eng's widths (the TTS node's random VITS at 24 kHz)
    at f32: equal durations and valid lengths on the card and the CPU, the
    waveform within 1e-3 (cuDNN's convolutions, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from streamkit_tpu_torch.models import vits
    from streamkit_tpu_torch.nodes.ml.tts_node import VITS_RANDOM_VOCAB

    cfg = vits.VitsConfig(sampling_rate=24000)
    ids = vits.VitsCharTokenizer(VITS_RANDOM_VOCAB).encode("hello there, this is a test of the voice.")
    out = {}
    for dev in ("cpu", "cuda"):
        params = vits.vits_init_params(cfg, device=dev)
        x = torch.as_tensor(ids[None], device=dev)
        hidden, _, _ = vits.text_encoder(params, cfg, x)
        m = torch.ones_like(hidden[..., :1])
        dur = vits.durations(vits.predict_durations(params, cfg, hidden, m), m, 1.0)
        wave, n = vits.synthesize(params, cfg, x, max_frames=256)
        out[dev] = (dur.cpu(), wave.cpu(), n.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and torch.equal(out["cuda"][2], out["cpu"][2])
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kokoro_on_cuda_matches_cpu():
    """The golden pack at f32 (hidden 512, random from ``PRNGKey(0)``): four
    sentences in one 64-token bucket, the first past 512 frames; durations
    equal on the card and the CPU, audio within 1e-4; ``kokoro_synthesize``
    of one sentence the same length and within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np

    from streamkit_tpu_torch.models import kokoro

    pack = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "samples", "kokoro-golden")
    cfg, cpu, tokens, voices = kokoro.load_kokoro_dir(pack, device="cpu")
    ids = [tokens.encode(s) for s in ("hello there, this is a test of kokoro.", "the quick brown fox", "a")]
    tok, mask = (np.stack(a) for a in zip(*(kokoro.kokoro_token_row(i, cfg) for i in ids)))
    style = np.stack([voices[1][len(i)] for i in ids]).astype(np.float32)
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = cpu if dev == "cpu" else kokoro.kokoro_init_params(cfg, device=dev)
            args = [torch.as_tensor(a, device=dev) for a in (tok, mask, style)]
            dur = kokoro.kokoro_durations_batch(params, cfg, *args).cpu()
            fr = [kokoro.kokoro_frames(dur[r].numpy(), len(i), 1.0) for r, i in enumerate(ids)]
            fi = np.stack([np.pad(f[0], (0, 512 - len(f[0]))) for f in fr])
            fm = np.stack([np.pad(f[1], (0, 512 - len(f[1]))) for f in fr])
            audio, f0 = kokoro.kokoro_core_batch(params, cfg, *args, torch.as_tensor(fi, device=dev),
                                                 torch.as_tensor(fm, device=dev), 512)
            one = kokoro.kokoro_synthesize(params, cfg, ids[1], voices[0], speed=1.3)
            out[dev] = (dur, audio.cpu(), one, [f[2] for f in fr])
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and out["cpu"][3][0] == 512
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-4
    assert out["cuda"][2].shape == out["cpu"][2].shape
    assert np.abs(out["cuda"][2] - out["cpu"][2]).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["node", "published-2"])
def test_matcha_on_cuda_matches_cpu(widths):
    """Matcha at f32, the node's random configuration and the published
    widths cut to 2 + 2 layers: frame counts equal on the card and the CPU,
    mels within 1e-3 after 10 Euler steps (cuDNN's convolutions, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from streamkit_tpu_torch.models import matcha
    from streamkit_tpu_torch.nodes.ml.matcha_node import random_init_config

    cfg = random_init_config(10, 0) if widths == "node" else matcha.MatchaConfig(enc_layers=2, dec_layers=2)
    ids = torch.randint(0, cfg.vocab_size, (3, 32), generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(32)[None] < torch.tensor([[32], [20], [7]])).float()
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = matcha.matcha_init_params(cfg, 0, device=dev)
            mel, n = matcha.matcha_synthesize_mel(params, cfg, ids.to(dev), 256, mask=mask.to(dev), length_scale=1.2)
            out[dev] = (mel.cpu(), n.cpu())
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["node", "published-2"])
def test_sensevoice_on_cuda_matches_cpu(widths):
    """SenseVoice at f32, the node's random configuration and the published
    widths cut to 2 layers: logits within 1e-3 on the card and the CPU, CTC
    ids equal; the bf16 logits on the card finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from streamkit_tpu_torch.models import sensevoice as sv
    from streamkit_tpu_torch.nodes.ml.sensevoice_node import RANDOM_INIT_CONFIG

    cfg = RANDOM_INIT_CONFIG if widths == "node" else sv.SenseVoiceConfig(layers=2)
    mel = torch.randn(3, 96, 80, generator=torch.Generator().manual_seed(0))
    mask = (torch.arange(16)[None] < torch.tensor([[16], [10], [3]])).float()
    lang, itn = torch.tensor([2, 0, 5], dtype=torch.int32), torch.tensor([1, 0, 1], dtype=torch.int32)
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            params = sv.sensevoice_init_params(cfg, 0, device=dev)
            logits = sv.sensevoice_logits(params, cfg, *(t.to(dev) for t in (mel, mask, lang, itn))).cpu()
            out[dev] = (logits, sv.ctc_greedy_decode(logits[:, 2:].numpy(), mask.numpy().astype(bool)))
        bf16 = sv.sensevoice_init_params(cfg, 0, torch.bfloat16, device="cuda")
        low = sv.sensevoice_logits(bf16, cfg, *(t.to("cuda") for t in (mel, mask, lang, itn)))
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-3
    assert out["cuda"][1] == out["cpu"][1] and any(out["cpu"][1])
    assert low.dtype == torch.float32 and bool(torch.isfinite(low).all()) and np.prod(low.shape) == 3 * 18 * cfg.vocab_size


def _bwd_inputs(b, h, tq, tk, d, dtype, fused, seed=0):
    """q, k, v, dO as head-split views: of separate [B, T, H*d] buffers, or
    (``fused``, Tq == Tk) of one [B, T, 3*H*d] buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def split(x):
        return x.reshape(b, x.shape[1], -1, d).transpose(1, 2)

    def rand(t, n):
        return torch.randn(b, t, n, device="cuda", generator=g).to(dtype)

    if fused:
        q, k, v = (split(x) for x in rand(tq, 3 * h * d).split(h * d, dim=-1))
    else:
        q, k, v = split(rand(tq, h * d)), split(rand(tk, h * d)), split(rand(tk, h * d))
    return q, k, v, split(rand(tq, h * d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,tq,tk,d,fused",
    [(2, 4, 300, 300, 64, False), (1, 3, 256, 1500, 64, False), (1, 2, 129, 77, 128, False),
     (1, 3, 300, 300, 128, True), (3, 1, 37, 64, 64, True)],
    ids=["self", "cross-256x1500", "ragged-d128", "fused-d128", "fused-short"],
)
def test_flash_attention_backward_matches_plain(dtype, b, h, tq, tk, d, fused):
    """K1's backward kernels against the plain backward on the same inputs
    (q, k, v, dO, and O and lse from the forward with the store on): f32
    within 1e-4 of each gradient's largest |g| (summation order over the
    keys); bf16 within twice the plain version's own rounding to bf16. One
    launch of each kernel; dq, dk, dv as [B, H, T, d] views of [B, T, H, d]
    buffers; the forward's output equal bit for bit with the store off, and
    its row statistic within 1e-5 (f32) or 1e-3 (bf16) of the plain one, in
    log2 units (both sides here read the kernel's lse, so a wrong row would
    pass the gradient check alone)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if fused:
        tk = tq
    q, k, v, do = _bwd_inputs(b, h, tq, tk, d, dtype, fused)
    scale = d ** -0.25
    out, lse = tattn.flash_attention_lse(q, k, v, scale)
    assert torch.equal(out, tattn.flash_attention(q, k, v, scale))
    want_lse = tattn.attention_lse_reference(q.float(), k.float(), v.float(), scale)[1]
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    assert (lse - want_lse).abs().max().item() <= (1e-5 if dtype == torch.float32 else 1e-3)
    before = (tattn.flash_attention_backward_dq.launches, tattn.flash_attention_backward_dkv.launches)
    grads = tattn.flash_attention_backward(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    assert (tattn.flash_attention_backward_dq.launches, tattn.flash_attention_backward_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    ref = tattn.attention_backward_reference(q.float(), k.float(), v.float(), out.float(), do.float(), lse, scale)
    plain = tattn.attention_backward_reference(q, k, v, out, do, lse, scale)
    for got, want, low, like in zip(grads, ref, plain, (q, k, v)):
        assert got.shape == like.shape and got.dtype == dtype and got.transpose(1, 2).is_contiguous()
        if dtype == torch.float32:
            tol = 1e-4 * want.abs().max().item()
        else:
            tol = 2 * (low.float() - want).abs().max().item()
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_routes(dtype):
    """With grad on and an input that requires grad, K1 records a graph (one
    forward launch with the store; the backward kernels on backward()); under
    no_grad, or without inputs that require grad, it is the serving launch
    and records nothing. The grads against autograd of the plain attention
    in f32 on the same (f32-upcast) inputs: f32 within 1e-4 of each
    gradient's largest |g|; bf16 within twice the error of autograd through
    the plain attention at bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do = _bwd_inputs(1, 2, 256, 256, 64, dtype, False)
    scale = 64 ** -0.25
    assert tattn.flash_attention(q, k, v, scale).grad_fn is None
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        assert tattn.flash_attention(*leaves, scale).grad_fn is None
    counts = lambda: (tattn.flash_attention.launches, tattn.flash_attention_backward_dq.launches,  # noqa: E731
                      tattn.flash_attention_backward_dkv.launches)
    before = counts()
    out = tattn.flash_attention(*leaves, scale)
    assert out.grad_fn is not None and counts() == (before[0] + 1, before[1], before[2])
    out.backward(do)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)

    def plain_grads(dtype):
        ref = [x.detach().cpu().to(dtype).requires_grad_() for x in (q, k, v)]
        tattn.attention_reference(*ref, scale).backward(do.cpu().to(dtype))
        return [x.grad.float() for x in ref]

    truth = plain_grads(torch.float32)
    plain = plain_grads(torch.bfloat16) if dtype == torch.bfloat16 else None
    for i, (got, want) in enumerate(zip(leaves, truth)):
        assert got.grad.dtype == dtype
        if plain is None:
            tol = 1e-4 * want.abs().max().item()
        else:
            tol = 2 * (plain[i] - want).abs().max().item()
        assert (got.grad.float().cpu() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_flash_attention_backward_refused_while_recorded():
    """A shape the kernels do not take raises in the forward, while the
    graph is recorded, before any launch; never in backward()."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = lambda: (tattn.flash_attention.launches, tattn.flash_attention_backward_dq.launches,  # noqa: E731
                      tattn.flash_attention_backward_dkv.launches)
    before = counts()
    q = torch.zeros(1, 2, 256, 96, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported shape"):
        tattn.flash_attention(q, q, q, 0.5)
    h = torch.zeros(1, 2, 256, 64, device="cuda", dtype=torch.float16, requires_grad=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.flash_attention(h, h, h, 0.5)
    assert counts() == before


def _small_whisper(n_text_layer=2):
    from streamkit_tpu_torch.models.whisper import WhisperConfig

    return WhisperConfig(n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                         n_vocab=512, n_text_ctx=256, n_text_state=128, n_text_head=2, n_text_layer=n_text_layer)


@pytest.mark.cuda
def test_encode_grads_on_cuda_match_cpu():
    """A loss through ``encode`` on the card gives the CPU's gradients in
    every encoder q/k/v projection (before K1 had a backward, the card's
    attention output carried no graph: those grads were missing, silently).
    Limit: 1e-4 of each leaf's largest |g|. K1, dQ and dK/dV once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from streamkit_tpu_torch.models.whisper import encode, seeded_params

    cfg = _small_whisper()
    mel = torch.from_numpy((np.random.RandomState(0).randn(2, 512, 80) * 0.3).astype(np.float32))
    # a fixed random readout of the states (a mean square of the layer-normed
    # states is nearly constant: its q/k grads are ~1e-8, cancellation noise)
    readout = torch.from_numpy(np.random.RandomState(5).randn(2, 256, 128).astype(np.float32))
    grads = {}
    for dev in ("cpu", "cuda"):
        params = seeded_params(cfg, device=dev)
        for p in params.parameters():
            p.requires_grad_(True)
        before = (tattn.flash_attention.launches, tattn.flash_attention_backward_dq.launches,
                  tattn.flash_attention_backward_dkv.launches)
        (encode(params, cfg, mel.to(dev)) * readout.to(dev)).sum().backward()
        launched = tuple(a - b for a, b in zip((tattn.flash_attention.launches,
                                                 tattn.flash_attention_backward_dq.launches,
                                                 tattn.flash_attention_backward_dkv.launches), before))
        assert launched == ((2, 2, 2) if dev == "cuda" else (0, 0, 0))
        grads[dev] = {f"{i}.{n}": params.enc.layers[i].attn[n].w.grad for i in range(2) for n in "qkv"}
    for name, want in grads["cpu"].items():
        got = grads["cuda"][name]
        assert got is not None and want.abs().max().item() > 0, name
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu():
    """One ``make_train_step`` step of the small f32 config (encoder and
    cross-attention through K1 at 256 tokens) on the card and the CPU: the
    loss within 1e-5 relative, params within 3·lr; K1, dQ and dK/dV once per
    encoder layer and per cross-attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from streamkit_tpu_torch.models.whisper import seeded_params
    from streamkit_tpu_torch.parallel import init_train_state, make_train_step

    cfg, lr = _small_whisper(), 1e-3
    rng = np.random.RandomState(1)
    batch = (torch.from_numpy((rng.randn(2, 512, 80) * 0.3).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 512, (2, 256))), torch.from_numpy(rng.randint(0, 512, (2, 256))),
             torch.ones(2, 256))
    out = {}
    for dev in ("cpu", "cuda"):
        before = tattn.flash_attention_backward_dkv.launches
        state, loss = make_train_step(cfg, lr)(init_train_state(seeded_params(cfg, device=dev), lr),
                                               *(x.to(dev) for x in batch))
        assert tattn.flash_attention_backward_dkv.launches - before == (4 if dev == "cuda" else 0)
        out[dev] = (loss.item(), [p.detach().cpu() for p in state.params.parameters()])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    assert max((a - b).abs().max().item() for a, b in zip(out["cuda"][1], out["cpu"][1])) <= 3 * lr
