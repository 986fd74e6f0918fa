# SPDX-License-Identifier: Apache-2.0
"""The port's ``utils/realspeech.py`` against the JAX package's, on the
repo's own Ogg/Opus speech samples: the decoded arrays are equal bit for bit
(both run the same libopus and the same numpy), capped and uncapped, and so
are the seeded slices, the wrap-around past the recording's end included."""

import os

import numpy as np
import pytest
import torch

from streamkit_tpu.nodes.codecs.opus import OpusLib
from streamkit_tpu.utils import realspeech as jrs
from streamkit_tpu_torch.utils import realspeech as trs

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

MEDIA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "samples", "media")
SPEECH_10M = os.path.join(MEDIA, "speech_10m.ogg")
SPEECH_30S = os.path.join(MEDIA, "speech_30s.ogg")
MISSING = os.path.join(MEDIA, "no_such_recording.ogg")


def _have_opus() -> bool:
    try:
        OpusLib.get()
    except OSError:
        return False
    return True


needs_opus = pytest.mark.skipif(not _have_opus(), reason="libopus does not load")


@needs_opus
@pytest.mark.parametrize("path, secs", [(SPEECH_10M, 3.0), (SPEECH_10M, 4.5), (SPEECH_30S, None)],
                         ids=["10m_capped_3s", "10m_capped_4.5s", "30s_uncapped"])
def test_load_opus_16k_is_bit_equal(path, secs):
    want = jrs.load_opus_16k(path, secs=secs)
    got = trs.load_opus_16k(path, secs=secs)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    if secs is not None:  # whole packets up to the cap
        assert secs * 16000 <= len(got) < (secs + 0.1) * 16000


@needs_opus
@pytest.mark.parametrize("seconds", [2.5, 12.0, 45.0], ids=["2.5s", "12s", "45s_wraps"])
def test_real_speech_16k_is_bit_equal_over_seeds(seconds):
    full = trs.load_opus_16k(SPEECH_30S)
    for seed in (0, 1, 7, 2024):
        want = jrs.real_speech_16k(seconds, seed=seed, path=SPEECH_30S)
        got = trs.real_speech_16k(seconds, seed=seed, path=SPEECH_30S)
        assert got.shape == (int(seconds * 16000),)
        assert np.array_equal(got, want), seed
    if seconds * 16000 > len(full):  # the wrap-around starts the recording again
        assert np.array_equal(got[len(full) : 2 * len(full)][: len(got) - len(full)], full[: len(got) - len(full)])


def test_missing_recording_gives_none_in_both():
    for mod in (jrs, trs):
        assert mod.real_speech_available(MISSING) is False
        assert mod.load_opus_16k(MISSING) is None
        assert mod.real_speech_16k(1.0, path=MISSING) is None


def test_default_sample_is_the_references():
    assert trs.DEFAULT_SAMPLE == jrs.DEFAULT_SAMPLE
    assert trs.real_speech_available(SPEECH_30S) == jrs.real_speech_available(SPEECH_30S) == _have_opus()
