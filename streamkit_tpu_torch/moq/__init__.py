# SPDX-License-Identifier: Apache-2.0
"""Media-over-QUIC data plane: in-process relay, wire framing, transports.

The reference splits this across an external relay plus client nodes
(``crates/transport/moq``); TPU-side we host the relay *in-process* so
media fan-out stays on the serving host (no extra hop before the device),
and bind external transports (WebSocket today, WebTransport/QUIC) onto the
same relay.
"""

from .relay import Broadcast, BroadcastConsumer, Frame, MoqRelay, get_moq_relay, init_moq_relay

__all__ = [
    "Broadcast",
    "BroadcastConsumer",
    "Frame",
    "MoqRelay",
    "get_moq_relay",
    "init_moq_relay",
]
