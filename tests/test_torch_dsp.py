# SPDX-License-Identifier: Apache-2.0
"""The port's DSP ops (gain, channel conversion, mix, the streaming
resampler) against the JAX package's, on the CPU.

Tolerance: none. Every comparison is bit for bit (``tobytes`` equality of
f32 / int32 outputs): the reference is exact here, and the port computes
the same f32 operations in the same order (the resampler's product is
rounded before its add on both sides). Inputs are made from numpy seeds.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamkit_tpu.ops import dsp as jdsp
from streamkit_tpu.ops import resample as jrs
from streamkit_tpu_torch.ops import dsp as tdsp
from streamkit_tpu_torch.ops import resample as trs

GOLD = os.path.join(os.path.dirname(__file__), "golden", "dsp_golden.npz")


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("gain", [0.0, 0.3, 1.0, 2.0, 3.999, 1 / 3])
@pytest.mark.parametrize("shape", [(960,), (4, 256), (3, 2, 321)])
def test_apply_gain_bit_exact(gain, shape):
    x = (np.random.RandomState(len(shape)).randn(*shape) * 0.7).astype(np.float32)
    want = jdsp.apply_gain(jnp.asarray(x), gain)
    got = tdsp.apply_gain(t(x), gain)
    assert same_bits(want, got.numpy())
    # the batcher's batched form: [B, n] * gains[:, None]
    if len(shape) == 2:
        gains = np.full(shape[0], gain, np.float32)
        assert same_bits(want, (t(x) * t(gains)[:, None]).numpy())


@pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (3, 2), (2, 3), (1, 4), (2, 2)])
def test_convert_channels_bit_exact(src, dst):
    x = np.random.RandomState(src * 10 + dst).randn(2, 480 * src).astype(np.float32)
    want = jdsp.convert_channels(jnp.asarray(x), src, dst)
    assert same_bits(want, tdsp.convert_channels(t(x), src, dst).numpy())


@pytest.mark.parametrize(
    "lens,chans,dst,out",
    [
        ((1920, 1920, 1920), (2, 2, 2), 2, 1920),
        ((960, 1920), (1, 2), 2, 1920),
        ((1920, 960, 400), (2, 1, 2), 1, 960),
        ((2880,), (3,), 2, 1920),
        ((400, 1920), (2, 2), 2, 1920),
        ((5000, 7), (2, 1), 2, 3000),
    ],
)
def test_mix_frames_bit_exact(lens, chans, dst, out):
    rng = np.random.RandomState(sum(lens))
    xs = [(rng.randn(n) * 0.5).astype(np.float32) for n in lens]
    want = jdsp.mix_frames([jnp.asarray(x) for x in xs], list(chans), dst, out)
    got = tdsp.mix_frames([t(x) for x in xs], list(chans), dst, out)
    assert same_bits(want, got.numpy())


RATES = [(s, d) for s in (8000, 16000, 44100, 48000) for d in (16000, 48000)]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("src,dst", RATES)
def test_resample_chunk_bit_exact(src, dst, channels):
    """Batched chunks with odd histories and every phase class: outputs,
    valid counts, new phases and new histories equal the JAX function's."""
    g = math.gcd(src, dst)
    sn, dn = src // g, dst // g
    rng = np.random.RandomState(src + dst + channels)
    for frames in (960, 333):
        mo = trs.max_output_frames(frames, src, dst)
        assert mo == jrs.max_output_frames(frames, src, dst)
        B = 6
        hist = (rng.randn(B, channels) * 3.0).astype(np.float32)  # outside [-1, 1] on purpose
        chunk = rng.randn(B, frames, channels).astype(np.float32)
        phase = np.concatenate([[0, dn, dn - 1], rng.randint(0, dn + 1, B - 3)]).astype(np.int32)
        want = jrs.resample_chunk(jnp.asarray(hist), jnp.asarray(chunk), jnp.asarray(phase), sn, dn, mo)
        got = trs.resample_chunk(t(hist), t(chunk), t(phase), sn, dn, mo)
        for w, o in zip(want, got):
            assert same_bits(w, o.numpy())


@pytest.mark.parametrize("src,dst,channels", [(48000, 16000, 1), (44100, 16000, 2), (16000, 48000, 1),
                                              (8000, 16000, 2), (44100, 48000, 1)])
def test_host_resamplers_equal_jax(src, dst, channels):
    """``LinearResampler`` (exact phase) and ``RubatoResampler`` (rubato's
    f64 accumulator, with its EOF flush) give the JAX package's bytes over
    a stream fed in odd-sized pieces."""
    rng = np.random.RandomState(src // 100 + channels)
    x = (rng.randn(channels * 9000) * 0.4).astype(np.float32)
    for cls in ("LinearResampler", "RubatoResampler"):
        a, b = getattr(jrs, cls)(src, dst, 960, channels), getattr(trs, cls)(src, dst, 960, channels)
        outs_a, outs_b, pos = [], [], 0
        for n in (1000, 2882, 40, 5000, 10**9):
            n -= n % channels
            piece = x[pos : pos + n]
            pos += piece.size
            outs_a.append(a.process(piece))
            outs_b.append(b.process(piece))
        if cls == "RubatoResampler":
            outs_a.append(a.flush())
            outs_b.append(b.flush())
        assert same_bits(np.concatenate(outs_a), np.concatenate(outs_b))


def test_host_resampler_matches_resample_chunk():
    """The host path and the device function of the slot table agree bit for
    bit, chunk by chunk (the property that lets a node pick either)."""
    src, dst, ch = 44100, 16000, 2
    g = math.gcd(src, dst)
    host = trs.LinearResampler(src, dst, 960, ch)
    x = np.random.RandomState(5).randn(960 * ch * 7).astype(np.float32)
    phase, hist = torch.tensor([dst // g], dtype=torch.int32), torch.zeros(1, ch)
    mo = trs.max_output_frames(960, src, dst)
    for i in range(7):
        chunk = x[i * 960 * ch : (i + 1) * 960 * ch]
        out, n, phase, hist = trs.resample_chunk(hist, t(chunk.reshape(1, 960, ch)), phase, src // g, dst // g, mo)
        assert same_bits(host.process(chunk), out[0, : int(n[0])].reshape(-1).numpy())


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLD)


@pytest.mark.parametrize(
    "case",
    ["mix_same", "mix_m2s", "mix_s2m", "mix_cyc", "mix_short", "gain", "s16", "f32", "rs_48_16", "rs_16_48",
     "rs_441_16", "rsru_48_441", "rsru_441_16", "rsru_48_16"],
)
def test_golden_fixtures_reproduced(gold, case):
    """``tests/golden/dsp_golden.npz`` (scalar-loop oracles of the reference
    algorithms) reproduced by the port, bit for bit."""
    g = {k: gold[k] for k in gold.files}
    mix = lambda ins, chans, dst, n: tdsp.mix_frames([t(g[k]) for k in ins], chans, dst, n).numpy()  # noqa: E731
    if case == "mix_same":
        pairs = [(mix(["mix_same_in_a", "mix_same_in_b", "mix_same_in_c"], [2, 2, 2], 2, 1920), g["mix_same_out"])]
    elif case == "mix_m2s":
        pairs = [(mix(["mix_m2s_in"], [1], 2, 1920), g["mix_m2s_out"])]
    elif case == "mix_s2m":
        pairs = [(mix(["mix_s2m_in"], [2], 1, 960), g["mix_s2m_out"])]
    elif case == "mix_cyc":
        pairs = [(mix(["mix_cyc_in"], [3], 2, 1920), g["mix_cyc_out"])]
    elif case == "mix_short":
        pairs = [(mix(["mix_short_in_a", "mix_short_in_b"], [2, 2], 2, 1920), g["mix_short_out"])]
    elif case == "gain":
        pairs = [(tdsp.apply_gain(t(g["gain_in"]), 2.0).numpy(), g["gain_2_out"]),
                 (tdsp.apply_gain(t(g["gain_in"]), 0.3).numpy(), g["gain_0p3_out"])]
    elif case == "s16":
        pairs = [(tdsp.s16le_to_f32(t(g["s16_in"])).numpy(), g["s16_to_f32_out"])]
    elif case == "f32":
        pairs = [(tdsp.f32_to_s16le(t(g["f32_in"])).numpy(), g["f32_to_s16_out"])]
    elif case.startswith("rs_"):
        src, dst, ch = {"rs_48_16": (48000, 16000, 1), "rs_16_48": (16000, 48000, 1),
                        "rs_441_16": (44100, 16000, 2)}[case]
        pairs = [(trs.LinearResampler(src, dst, 960, ch).process(g[case + "_in"]), g[case + "_out"])]
    elif case == "rsru_48_441":
        r = trs.RubatoResampler(48000, 44100, 960, 1)
        pairs = [(np.concatenate([r.process(g["rsru_48_441_in"]), r.flush()]), g["rsru_48_441_out"])]
    elif case == "rsru_441_16":
        x, r, outs, pos = g["rsru_441_16_in"], trs.RubatoResampler(44100, 16000, 960, 2), [], 0
        for n in (1000, 3332, 778, 10**9):
            piece = x[pos : pos + min(n - n % 2, len(x) - pos)]
            pos += len(piece)
            outs.append(r.process(piece))
            if pos >= len(x):
                break
        pairs = [(np.concatenate(outs), g["rsru_441_16_out"])]
    else:
        pairs = [(trs.RubatoResampler(48000, 16000, 960, 1).process(g["rs_48_16_in"]), g["rsru_48_16_out"])]
    for got, want in pairs:
        assert same_bits(want, got), case
