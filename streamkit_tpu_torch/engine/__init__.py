# SPDX-License-Identifier: Apache-2.0
"""Execution engines and serving parts ported so far: the oneshot engine
(request → response) with its graph builder, the continuous batcher, the
device-resident session audio rings, the native ingest pool and the dense
streaming STT engine."""

from .audio_ring import SessionAudioRing, get_audio_ring
from .batcher import BatchKind, DeviceBatcher
from .graph_builder import WiredGraph, wire_and_spawn_graph
from .ingest import IngestPool
from .oneshot import OneshotResult, run_oneshot_pipeline
from .stt_serving import SttServingEngine
