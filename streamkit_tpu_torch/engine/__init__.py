# SPDX-License-Identifier: Apache-2.0
"""Execution engines and serving parts ported so far: the oneshot engine
(request → response) with its graph builder, the dynamic engine (live,
patchable sessions) with its pin distributor, the continuous batcher, the
device-resident slot tables and session audio rings, the native ingest pool
and the dense streaming STT engine."""

from .audio_ring import SessionAudioRing, get_audio_ring
from .batcher import BatchKind, DeviceBatcher
from .dynamic import DynamicEngine, DynamicEngineConfig, DynamicEngineHandle, start_dynamic_engine
from .graph_builder import WiredGraph, wire_and_spawn_graph
from .ingest import IngestPool
from .oneshot import OneshotResult, run_oneshot_pipeline
from .slots import SlotTable
from .stt_serving import SttServingEngine
