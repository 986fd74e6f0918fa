# SPDX-License-Identifier: Apache-2.0
"""Port parity: log-mel frontend and PCM conversions against the JAX package
on the CPU (same numpy inputs into both)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from streamkit_tpu.ops import dsp as jdsp
from streamkit_tpu.ops import mel as jmel
from streamkit_tpu_torch.ops import dsp as tdsp
from streamkit_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

ATOL = 1e-4  # f32 DFT/mel matmuls in a different summation order


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_jax(n_mels):
    rng = np.random.RandomState(n_mels)
    audio = (rng.randn(3, 16000) * 0.1).astype(np.float32)
    audio[2, 9000:] = 0.0  # zero-tail row (the clamp at max-8 bites)
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels))
    got = tmel.log_mel_spectrogram(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (3, 100, n_mels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_filterbank_and_framing_match_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(128), jmel.mel_filterbank(128))
    x = np.arange(3 * 2000, dtype=np.float32).reshape(3, 2000)
    want = np.asarray(jmel.frame_signal(jnp.asarray(x), 10, offset=40))
    got = tmel.frame_signal(torch.from_numpy(x), 10, offset=40).numpy()
    np.testing.assert_array_equal(got, want)


def test_pcm_conversions_bit_exact():
    rng = np.random.RandomState(0)
    x = np.concatenate(
        [rng.uniform(-1.2, 1.2, 4096), np.array([0.5 / 32768, -0.5 / 32768, 1.5 / 32768, -1.0, 1.0])]
    ).astype(np.float32)
    np.testing.assert_array_equal(
        tdsp.f32_to_s16le(torch.from_numpy(x)).numpy(), np.asarray(jdsp.f32_to_s16le(jnp.asarray(x)))
    )
    s = rng.randint(-32768, 32768, 4096).astype(np.int16)
    np.testing.assert_array_equal(
        tdsp.s16le_to_f32(torch.from_numpy(s)).numpy(), np.asarray(jdsp.s16le_to_f32(jnp.asarray(s)))
    )
