# SPDX-License-Identifier: Apache-2.0
"""Core abstractions: packets, pins, nodes, registry, state, stats, telemetry.

Counterpart of the reference's ``crates/core`` layer; a host-only copy
of the JAX package's ``core/`` (no module here touches the device).
"""

from .channel import Channel, ChannelClosed, ChannelFull, channel
from .control import ConnectionMode, EngineControlMessage, NodeControlMessage
from .errors import (
    ConfigurationError,
    NetworkError,
    PluginError,
    ResourceError,
    RuntimeNodeError,
    StreamKitError,
    ValidationFailure,
)
from .frame_pool import AudioFramePool
from .helpers import (
    batch_packets_greedy,
    parse_config_optional,
    parse_config_required,
    require_param,
)
from .node import NodeContext, OutputSender, ProcessorNode
from .node_config import NodeBufferConfig, get_buffer_config, set_buffer_config
from .packet_meta import can_connect, can_connect_any, packet_type_registry
from .pins import InputPin, OutputPin, PinCardinality, PinManagementMessage, PinUpdate
from .registry import NodeDefinition, NodeRegistry
from .resource_manager import ResourceKey, ResourceManager, ResourcePolicy
from .state import NodeState, NodeStateKind, NodeStateUpdate, StopReason, emit_state
from .stats import NodeStats, NodeStatsTracker, NodeStatsUpdate
from .telemetry import TELEMETRY_TYPE_ID, TelemetryEmitter, TelemetryEvent
from .types import (
    AudioFormat,
    AudioFrame,
    CustomPacketData,
    Packet,
    PacketMetadata,
    PacketType,
    SampleFormat,
    TranscriptionData,
    TranscriptionSegment,
)
