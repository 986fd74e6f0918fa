# SPDX-License-Identifier: Apache-2.0
"""Serving engine parts ported so far: the continuous batcher, the
device-resident session audio rings, the native ingest pool and the dense
streaming STT engine."""

from .audio_ring import SessionAudioRing, get_audio_ring
from .batcher import BatchKind, DeviceBatcher
from .ingest import IngestPool
from .stt_serving import SttServingEngine
