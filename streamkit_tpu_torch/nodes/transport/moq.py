# SPDX-License-Identifier: Apache-2.0
"""MoQ transport nodes: bidirectional peer, subscriber, publisher.

Parity targets (``nodes/src/transport/moq/``):

* ``transport::moq::peer`` (``peer.rs:105-141``) — bidirectional in-server
  endpoint: registers ``{gateway_path}/input`` (one publisher slot, optional
  reconnect) and ``{gateway_path}/output`` (N subscribers, broadcast) with
  the server's gateway. The only node kind allowed in YAML cycles.
* ``transport::moq::subscriber`` (``pull.rs:22-42``) — client-side
  subscribe producing Opus packets.
* ``transport::moq::publisher`` (``push.rs:18-37``) — client-side publish
  with ``group_duration_ms`` (40) and ``initial_delay_ms`` playout offset.

Transport is the gateway's WebSocket binding (framed media messages,
``core/moq_gateway.py``, served at ``/moq/{path}``); the node logic is
transport-agnostic, so a QUIC/WebTransport acceptor can bind the same
gateway when it is ported.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from ...core import (
    ChannelClosed,
    ChannelFull,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    ProcessorNode,
    parse_config_optional,
    require_param,
)
from ...core.channel import Channel
from ...core.moq_gateway import (
    MoqConnection,
    decode_media_frame,
    encode_media_frame,
    get_moq_gateway,
)
from ...core.state import NodeState, StopReason


class MoqPeerNode(ProcessorNode):
    """Bidirectional in-server MoQ endpoint (``transport::moq::peer``)."""

    KIND = "transport::moq::peer"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "gateway_path": None,
                "input_broadcast": "input",
                "output_broadcast": "output",
                "allow_reconnect": True,
                "group_duration_ms": 40,
            },
        )
        if params is not None:
            require_param(params, "gateway_path")
        self.gateway_path = cfg["gateway_path"]
        self.allow_reconnect = bool(cfg["allow_reconnect"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.opus_audio()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.opus_audio())]

    async def run(self, ctx: NodeContext) -> None:
        gateway = get_moq_gateway()
        if gateway is None:
            raise ConfigurationError("MoQ gateway not initialized (server not running?)")
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        in_route = await gateway.register_route(f"{self.gateway_path}/input")
        out_route = await gateway.register_route(f"{self.gateway_path}/output")
        ctx.emit_state(NodeState.running())

        subscribers: List[MoqConnection] = []
        publisher: Dict[str, Optional[MoqConnection]] = {"conn": None}

        async def accept_loop() -> None:
            """Admit publishers (one slot) and subscribers (broadcast set)."""

            async def watch(route: Channel, is_input: bool) -> None:
                while True:
                    conn = await route.recv_optional()
                    if conn is None:
                        return
                    if is_input:
                        if publisher["conn"] is not None and not self.allow_reconnect:
                            conn.close()
                            continue
                        if publisher["conn"] is not None:
                            publisher["conn"].close()
                        publisher["conn"] = conn
                    else:
                        subscribers.append(conn)

            await asyncio.gather(watch(in_route, True), watch(out_route, False))

        async def ingest_loop() -> None:
            """Publisher frames → node output pin."""
            seq = 0
            while not ctx.cancelled:
                conn = publisher["conn"]
                if conn is None:
                    await asyncio.sleep(0.02)
                    continue
                frame = await conn.incoming.recv_optional()
                if frame is None:
                    if publisher["conn"] is conn:
                        publisher["conn"] = None  # reconnect slot opens
                    continue
                payload, ts_us, _key = decode_media_frame(frame)
                meta = PacketMetadata(timestamp_us=ts_us, sequence=seq)
                seq += 1
                await ctx.output.send(
                    "out", Packet.new_binary(payload, content_type="audio/opus", metadata=meta)
                )
                stats.packet_sent()

        async def egress_loop() -> None:
            """Node input pin → all subscriber connections (best-effort)."""
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    return
                stats.packet_received()
                if pkt.binary is None:
                    continue
                ts = pkt.metadata.timestamp_us if pkt.metadata and pkt.metadata.timestamp_us else 0
                frame = encode_media_frame(pkt.binary, ts)
                for conn in list(subscribers):
                    try:
                        conn.outgoing.try_send(frame)
                    except ChannelClosed:
                        subscribers.remove(conn)
                    except ChannelFull:
                        pass  # best-effort fan-out: drop for slow subscribers

        accept_task = asyncio.ensure_future(accept_loop())
        ingest_task = asyncio.ensure_future(ingest_loop())
        try:
            await egress_loop()
        except ChannelClosed:
            pass
        finally:
            accept_task.cancel()
            ingest_task.cancel()
            await gateway.unregister_route(f"{self.gateway_path}/input")
            await gateway.unregister_route(f"{self.gateway_path}/output")
            if publisher["conn"] is not None:
                publisher["conn"].close()
            for conn in subscribers:
                conn.close()
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))


class MoqSubscriberNode(ProcessorNode):
    """Subscribes to a broadcast, emits Opus packets (``transport::moq::subscriber``).

    Two sources (reference ``pull.rs:22-42`` subscribes to an external relay
    broadcast; our relay is in-process):

    * ``broadcast`` — subscribe to the named broadcast on the in-process
      relay (meets ``transport::moq::publisher`` nodes and external
      WebTransport/WS publishers bridged onto the relay). A reference-style
      ``url`` param is accepted and ignored (the relay is local).
    * ``gateway_path`` — legacy: register an external gateway route and
      consume frames from a remote publisher connection.
    """

    KIND = "transport::moq::subscriber"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {"gateway_path": None, "broadcast": None, "url": None, "backoff_cap": None, "max_retries": None},
        )
        self.gateway_path = cfg["gateway_path"]
        self.broadcast = cfg["broadcast"]
        if params is not None and not (self.gateway_path or self.broadcast):
            raise ConfigurationError(
                "transport::moq::subscriber requires 'broadcast' or 'gateway_path'"
            )

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.opus_audio())]

    async def _emit(self, ctx, stats, payload: bytes, ts_us: int, seq: int) -> None:
        await ctx.output.send(
            "out",
            Packet.new_binary(
                payload,
                content_type="audio/opus",
                metadata=PacketMetadata(timestamp_us=ts_us, sequence=seq),
            ),
        )
        stats.packet_sent()

    async def _run_relay(self, ctx: NodeContext, stats: NodeStatsTracker) -> None:
        from ...moq import get_moq_relay

        relay = get_moq_relay()
        ctx.emit_state(NodeState.running())
        seq = 0
        consumer = await relay.subscribe(self.broadcast)
        try:
            if consumer is None:
                raise ConfigurationError(
                    f"broadcast {self.broadcast!r} was not announced within the wait window"
                )
            while not ctx.cancelled:
                frame = await consumer.recv()
                if frame is None:
                    break
                await self._emit(ctx, stats, frame.payload, frame.timestamp_us, seq)
                seq += 1
        finally:
            if consumer is not None:
                consumer.close()

    async def _run_gateway(self, ctx: NodeContext, stats: NodeStatsTracker) -> None:
        gateway = get_moq_gateway()
        if gateway is None:
            raise ConfigurationError("MoQ gateway not initialized")
        route = await gateway.register_route(self.gateway_path)
        ctx.emit_state(NodeState.running())
        seq = 0
        try:
            while not ctx.cancelled:
                conn = await route.recv_optional()
                if conn is None:
                    break
                while True:
                    frame = await conn.incoming.recv_optional()
                    if frame is None:
                        break
                    payload, ts_us, _key = decode_media_frame(frame)
                    await self._emit(ctx, stats, payload, ts_us, seq)
                    seq += 1
        finally:
            await gateway.unregister_route(self.gateway_path)

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        try:
            if self.broadcast:
                await self._run_relay(ctx, stats)
            else:
                await self._run_gateway(ctx, stats)
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))


class MoqPublisherNode(ProcessorNode):
    """Publishes Opus packets to subscribers on a path (``transport::moq::publisher``)."""

    KIND = "transport::moq::publisher"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "gateway_path": None,
                "broadcast": None,
                "url": None,
                "group_duration_ms": 40,
                "initial_delay_ms": 0,
            },
        )
        self.gateway_path = cfg["gateway_path"]
        self.broadcast = cfg["broadcast"]
        if params is not None and not (self.gateway_path or self.broadcast):
            raise ConfigurationError(
                "transport::moq::publisher requires 'broadcast' or 'gateway_path'"
            )
        self.group_duration_us = max(0, int(cfg["group_duration_ms"])) * 1000
        self.initial_delay = float(cfg["initial_delay_ms"]) / 1000.0

    def input_pins(self) -> List[InputPin]:
        # Binary too: live_captions.yml publishes core::json_serialize's
        # lines here. The JAX package's pin takes Opus only, so its dynamic
        # engine refuses that connection (a type mismatch) and the sample
        # cannot run there as written. The frames are opaque bytes either way.
        return [InputPin("in", [PacketType.opus_audio(), PacketType.binary()])]

    async def _run_relay(self, ctx: NodeContext, stats: NodeStatsTracker) -> None:
        """Publish into the in-process relay (reference push.rs:18-37 group
        cadence: a new group starts every group_duration_ms)."""
        from ...moq import get_moq_relay

        relay = get_moq_relay()
        b = relay.announce(self.broadcast)
        ctx.emit_state(NodeState.running())
        if self.initial_delay > 0:
            await asyncio.sleep(self.initial_delay)
        group_start_ts: Optional[int] = None
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is None:
                    continue
                ts = pkt.metadata.timestamp_us if pkt.metadata and pkt.metadata.timestamp_us else 0
                key = False
                if group_start_ts is None or (
                    self.group_duration_us and ts - group_start_ts >= self.group_duration_us
                ):
                    key = True
                    group_start_ts = ts
                b.publish(pkt.binary, ts, key=key)
        finally:
            b.end()

    async def _run_gateway(self, ctx: NodeContext, stats: NodeStatsTracker) -> None:
        gateway = get_moq_gateway()
        if gateway is None:
            raise ConfigurationError("MoQ gateway not initialized")
        route = await gateway.register_route(self.gateway_path)
        ctx.emit_state(NodeState.running())
        subscribers: List[MoqConnection] = []

        async def accept_loop() -> None:
            while True:
                conn = await route.recv_optional()
                if conn is None:
                    return
                subscribers.append(conn)

        accept_task = asyncio.ensure_future(accept_loop())
        if self.initial_delay > 0:
            await asyncio.sleep(self.initial_delay)
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.binary is None:
                    continue
                ts = pkt.metadata.timestamp_us if pkt.metadata and pkt.metadata.timestamp_us else 0
                frame = encode_media_frame(pkt.binary, ts)
                for conn in list(subscribers):
                    try:
                        conn.outgoing.try_send(frame)
                    except ChannelClosed:
                        subscribers.remove(conn)
                    except ChannelFull:
                        pass
        finally:
            accept_task.cancel()
            await gateway.unregister_route(self.gateway_path)
            for conn in subscribers:
                conn.close()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        if self.broadcast:
            await self._run_relay(ctx, stats)
        else:
            await self._run_gateway(ctx, stats)
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
