# SPDX-License-Identifier: Apache-2.0
"""Serving engine parts ported so far: the continuous batcher and the
device-resident session audio rings."""

from .audio_ring import SessionAudioRing
from .batcher import BatchKind, DeviceBatcher
