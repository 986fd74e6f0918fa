# SPDX-License-Identifier: Apache-2.0
"""HTTP(S) fetcher source node.

Parity target: ``transport::http::fetcher`` (``nodes/src/transport/http.rs:
35-40``): fetches a URL as a Binary stream; waits for Start like other
sources. The request goes through the port's own client
(:class:`~..server.http.ClientSession`, standard library only), its body
streamed in ``chunk_size`` pieces within ``timeout_secs``.
"""

from __future__ import annotations

from typing import List, Optional

from ...core import (
    ChannelClosed,
    ConfigurationError,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    RuntimeNodeError,
    parse_config_optional,
    require_param,
)
from ...core.state import NodeState, StopReason

# optional global allowlist, installed by the server (script/security config)
_URL_ALLOWLIST: List[str] = []


def set_url_allowlist(prefixes: List[str]) -> None:
    global _URL_ALLOWLIST
    _URL_ALLOWLIST = list(prefixes)


class HttpFetcherNode(ProcessorNode):
    """URL → Binary chunks (``transport::http::fetcher``)."""

    KIND = "transport::http::fetcher"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params, {"url": None, "chunk_size": 65536, "timeout_secs": 30.0}
        )
        if params is not None:
            require_param(params, "url")
        self.url = cfg["url"]
        self.chunk_size = int(cfg["chunk_size"])
        self.timeout = float(cfg["timeout_secs"])
        if self.url and not self.url.startswith(("http://", "https://")):
            raise ConfigurationError("url must be http(s)")
        if _URL_ALLOWLIST and self.url and not any(
            self.url.startswith(p) for p in _URL_ALLOWLIST
        ):
            raise ConfigurationError(f"url not in allowlist: {self.url}")

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.binary())]

    async def run(self, ctx: NodeContext) -> None:
        from ...server.http import ClientError, ClientSession

        ctx.emit_state(NodeState.ready())
        if not await ctx.wait_for_start():
            ctx.emit_state(NodeState.stopped(StopReason.SHUTDOWN))
            return
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        try:
            async with ClientSession(timeout=self.timeout) as session:
                async with session.get(self.url) as resp:
                    if resp.status >= 400:
                        raise RuntimeNodeError(f"HTTP {resp.status} fetching {self.url}")
                    ctype = resp.headers.get("Content-Type")
                    async for chunk in resp.iter_chunked(self.chunk_size):
                        if ctx.cancelled:
                            break
                        await ctx.output.send(
                            "out", Packet.new_binary(chunk, content_type=ctype)
                        )
                        stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        except ClientError as e:
            raise RuntimeNodeError(f"fetch failed: {e}") from e
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.COMPLETED))
