# SPDX-License-Identifier: Apache-2.0
"""The port's continuous batcher on device="cpu": cross-session batching,
batch invariance, shape-bucket isolation, error propagation, coalescing."""

import asyncio

import numpy as np
import pytest
import torch

from streamkit_tpu_torch.engine.batcher import DeviceBatcher


def test_batches_concurrent_submissions():
    async def main():
        b = DeviceBatcher(tick_ms=10.0, device="cpu")
        b.register("double", lambda x: x * 2.0)
        b.start()
        inputs = [np.full(960, i, np.float32) for i in range(32)]
        outs = await asyncio.gather(*(b.submit("double", x) for x in inputs))
        b.stop()
        return outs, b.stats()

    outs, stats = asyncio.run(main())
    for i, out in enumerate(outs):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, np.full(960, 2.0 * i, np.float32))
    assert stats["submissions"] == 32
    assert stats["device_calls"] <= 4, stats
    assert stats["mean_batch"] >= 8


def test_shape_buckets_are_isolated():
    async def main():
        b = DeviceBatcher(tick_ms=5.0, device="cpu")
        b.register("sum", lambda x: torch.sum(x, dim=-1))
        b.start()
        ra, rc = await asyncio.gather(
            b.submit("sum", np.ones(10, np.float32)), b.submit("sum", np.ones(20, np.float32))
        )
        b.stop()
        return ra, rc

    ra, rc = asyncio.run(main())
    assert float(ra) == 10.0 and float(rc) == 20.0


def test_multi_output_and_state_roundtrip():
    async def main():
        b = DeviceBatcher(tick_ms=5.0, device="cpu")
        b.register("step", lambda state, x: (state + torch.sum(x, -1), state * 0 + 1))
        b.start()
        r1, r2 = await asyncio.gather(
            b.submit("step", np.float32(5.0), np.ones(4, np.float32)),
            b.submit("step", np.float32(100.0), np.ones(4, np.float32)),
        )
        b.stop()
        return r1, r2

    (s1, f1), (s2, _) = asyncio.run(main())
    assert float(s1) == 9.0 and float(s2) == 104.0
    assert float(f1) == 1.0


def test_unregistered_kind_raises():
    async def main():
        b = DeviceBatcher(device="cpu")
        with pytest.raises(KeyError):
            await b.submit("nope", np.zeros(1))

    asyncio.run(main())


def test_error_propagates_to_all_waiters():
    async def main():
        b = DeviceBatcher(tick_ms=5.0, device="cpu")

        def bad(x):
            raise RuntimeError("kernel exploded")

        b.register("bad", bad)
        b.start()
        results = await asyncio.gather(
            b.submit("bad", np.zeros(4, np.float32)),
            b.submit("bad", np.zeros(4, np.float32)),
            return_exceptions=True,
        )
        b.stop()
        return results

    assert all(isinstance(r, RuntimeError) for r in asyncio.run(main()))


def test_max_batch_split():
    async def main():
        b = DeviceBatcher(tick_ms=50.0, device="cpu")
        b.register("id", lambda x: x, max_batch=8)
        b.start()
        outs = await asyncio.gather(*(b.submit("id", np.full(4, i, np.float32)) for i in range(20)))
        b.stop()
        return outs, b.stats()

    outs, stats = asyncio.run(main())
    assert [float(o[0]) for o in outs] == list(range(20))
    assert stats["device_calls"] >= 3


def test_inputs_reach_fn_on_device_or_host():
    """Device kinds get tensors on the batcher's device; host_inputs kinds
    get the stacked numpy arrays unpadded."""
    seen = {}

    def dev_fn(x):
        seen["dev"] = (type(x), x.device, tuple(x.shape))
        return x

    def host_fn(x):
        seen["host"] = (type(x), x.shape)
        return x

    async def main():
        b = DeviceBatcher(tick_ms=5.0, device="cpu")
        b.register("d", dev_fn)
        b.register("h", host_fn, host_inputs=True)
        b.start()
        await asyncio.gather(*(b.submit("d", np.zeros(2, np.float32)) for _ in range(3)))
        await asyncio.gather(*(b.submit("h", np.zeros(2, np.float32)) for _ in range(3)))
        b.stop()

    asyncio.run(main())
    assert seen["dev"] == (torch.Tensor, torch.device("cpu"), (4, 2))  # padded to a power of two
    assert seen["host"] == (np.ndarray, (3, 2))


def test_multisession_whisper_batching():
    """Several sessions' STT windows share device calls and equal solo
    decoding (batch invariance)."""
    from streamkit_tpu_torch.models.whisper import WhisperConfig, greedy_decode, init_params
    from streamkit_tpu_torch.ops.mel import log_mel_spectrogram

    cfg = WhisperConfig(
        n_audio_ctx=50, n_audio_state=64, n_audio_head=2, n_audio_layer=1,
        n_vocab=51865, n_text_ctx=16, n_text_state=64, n_text_head=2, n_text_layer=1,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    n_samples = cfg.n_audio_ctx * 2 * 160

    def batched_stt(audio_b):
        return greedy_decode(params, cfg, log_mel_spectrogram(audio_b, cfg.n_mels), max_tokens=4)

    rng = np.random.RandomState(0)
    windows = [rng.randn(n_samples).astype(np.float32) * 0.1 for _ in range(6)]

    async def main():
        b = DeviceBatcher(tick_ms=20.0, device="cpu")
        b.register("stt", batched_stt)
        b.start()
        outs = await asyncio.gather(*(b.submit("stt", w) for w in windows))
        b.stop()
        return outs, b.stats()

    outs, stats = asyncio.run(main())
    assert stats["device_calls"] <= 2
    solo_tokens, _ = batched_stt(torch.from_numpy(windows[2][None]))
    np.testing.assert_array_equal(outs[2][0], solo_tokens[0])


def test_expected_coalescing_fires_at_expected_not_window():
    async def main():
        b = DeviceBatcher(tick_ms=2.0, device="cpu")
        b.register("sq", lambda x: x * x, pad_to=16, gather_ms=400.0)
        b.set_expected("sq", 4)
        b.start()
        t0 = asyncio.get_event_loop().time()
        outs = await asyncio.gather(*(b.submit("sq", np.float32(i)) for i in range(4)))
        t_full = asyncio.get_event_loop().time() - t0
        t0 = asyncio.get_event_loop().time()
        part = await b.submit("sq", np.float32(9))
        t_part = asyncio.get_event_loop().time() - t0
        b.stop()
        return outs, t_full, part, t_part, b.stats()

    outs, t_full, part, t_part, stats = asyncio.run(main())
    np.testing.assert_allclose([float(o) for o in outs], [0, 1, 4, 9])
    assert float(part) == 81.0
    assert t_full < 0.4, f"full batch waited the window: {t_full}"
    assert 0.3 <= t_part < 5.0, f"straggler not window-bounded: {t_part}"
    assert stats["device_calls"] == 2
    b2 = DeviceBatcher(device="cpu")
    b2.register("k", lambda x: x, pad_to=8)
    b2.set_expected("k", 3)
    b2.set_expected("k", 0)
    assert b2.registered_kinds()["k"].expected is None
