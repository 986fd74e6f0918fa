# SPDX-License-Identifier: Apache-2.0
"""Engine tuning constants (parity: reference ``engine/src/constants.rs:31-130``).

Latency math: a bounded channel of capacity N holds up to N×20 ms of audio at
the standard Opus frame size, so per-hop worst-case queueing = capacity × 20 ms.
The server's perf profiles scale these (low-latency / balanced / high-throughput,
reference ``apps/skit/src/config.rs:21-47``).
"""

PACKET_BATCH_SIZE = 32

# dynamic engine
NODE_INPUT_CAPACITY = 128
PIN_DISTRIBUTOR_CAPACITY = 64
CONTROL_CHANNEL_CAPACITY = 32
ENGINE_CONTROL_CAPACITY = 128
SUBSCRIBER_CHANNEL_CAPACITY = 128
STATE_CHANNEL_CAPACITY = 256
STATS_CHANNEL_CAPACITY = 256
TELEMETRY_CHANNEL_CAPACITY = 256

# oneshot engine
ONESHOT_MEDIA_CAPACITY = 256
ONESHOT_IO_CAPACITY = 16

# codecs / demuxers
CODEC_HANDOFF_CAPACITY = 32
DEMUX_STREAM_CAPACITY = 8
DEMUX_BUFFER_SIZE = 64 * 1024
MOQ_PEER_CAPACITY = 100

# shutdown ladders (reference dynamic_actor.rs:809-1028)
NODE_GRACEFUL_SHUTDOWN_SECS = 5.0
ENGINE_GRACEFUL_SHUTDOWN_SECS = 2.0
ENGINE_ABORT_GRACE_SECS = 1.0
HANDLE_SHUTDOWN_TIMEOUT_SECS = 10.0

# passthrough type-inference iteration bound (graph_builder.rs:135-210)
MAX_TYPE_INFERENCE_ITERATIONS = 100
