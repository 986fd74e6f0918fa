# SPDX-License-Identifier: Apache-2.0
"""Oneshot pipeline runner: stateless request → response batch execution.

Parity with reference ``engine/src/oneshot.rs:62-376``:

* role detection — ``streamkit::http_input`` / ``streamkit::http_output`` /
  ``core::file_reader`` (``oneshot.rs:116-173``),
* node instantiation via registry, graph wiring via
  :func:`wire_and_spawn_graph`,
* ``Start`` control signals to source (file-reader) nodes,
* input pump: request body chunks → http_input channel,
* response content-type negotiation: configured > node-static > input >
  ``application/octet-stream`` (``oneshot.rs:357-371``),
* returns a streaming result: the output channel yields response bytes as
  the pipeline produces them.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import AsyncIterator, Dict, Optional

from ..api.messages import Pipeline
from ..core import (
    Channel,
    ChannelClosed,
    NodeControlMessage,
    NodeRegistry,
    Packet,
    StreamKitError,
    ValidationFailure,
)
from . import constants
from .graph_builder import WiredGraph, wire_and_spawn_graph

log = logging.getLogger(__name__)

__all__ = ["OneshotResult", "run_oneshot_pipeline", "HTTP_INPUT_KIND", "HTTP_OUTPUT_KIND"]

HTTP_INPUT_KIND = "streamkit::http_input"
HTTP_OUTPUT_KIND = "streamkit::http_output"
FILE_READER_KIND = "core::file_reader"


@dataclass
class OneshotResult:
    """Streaming pipeline output (reference ``OneshotPipelineResult``)."""

    content_type: str
    output: Channel  # yields bytes chunks; closed = end of response
    graph: WiredGraph
    _pump_task: Optional[asyncio.Task] = None
    _pump_error: Optional[BaseException] = None

    async def read_all(self) -> bytes:
        chunks = []
        while True:
            chunk = await self.output.recv_optional()
            if chunk is None:
                break
            chunks.append(chunk)
        await self.wait()
        return b"".join(chunks)

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        while True:
            chunk = await self.output.recv_optional()
            if chunk is None:
                break
            yield chunk
        await self.wait()

    async def wait(self) -> None:
        """Join all node tasks; raise the first pump or node failure."""
        if self._pump_task is not None:
            try:
                await self._pump_task
            except Exception as e:  # noqa: BLE001
                self._pump_error = e
        results = await self.graph.join()
        for name, err in results.items():
            if err is not None:
                raise StreamKitError(f"node {name!r} failed: {err}") from err
        if self._pump_error is not None:
            raise StreamKitError(
                f"input stream failed: {self._pump_error}"
            ) from self._pump_error

    def cancel(self) -> None:
        """Abort the pipeline (client disconnected): cancel nodes + pump."""
        if self._pump_task is not None:
            self._pump_task.cancel()
        self.graph.cancel()
        self.output.close()


async def run_oneshot_pipeline(
    registry: NodeRegistry,
    pipeline: Pipeline,
    *,
    input_stream: Optional[AsyncIterator[bytes]] = None,
    input_content_type: Optional[str] = None,
    configured_content_type: Optional[str] = None,
    resources=None,
    audio_pool=None,
    batcher=None,
) -> OneshotResult:
    """Instantiate, wire, and start a oneshot pipeline.

    ``input_stream`` feeds the ``streamkit::http_input`` node (HTTP body);
    the returned result streams bytes from ``streamkit::http_output``.
    """
    if pipeline.mode != "oneshot":
        raise ValidationFailure("run_oneshot_pipeline requires mode: oneshot")

    # ---- role detection (oneshot.rs:116-173)
    http_inputs = [n for n, d in pipeline.nodes.items() if d.kind == HTTP_INPUT_KIND]
    http_outputs = [n for n, d in pipeline.nodes.items() if d.kind == HTTP_OUTPUT_KIND]
    file_readers = [n for n, d in pipeline.nodes.items() if d.kind == FILE_READER_KIND]
    if len(http_inputs) > 1 or len(http_outputs) > 1:
        raise ValidationFailure("at most one http_input and one http_output allowed")
    if not http_outputs:
        raise ValidationFailure("oneshot pipeline requires a streamkit::http_output node")
    if not http_inputs and not file_readers:
        raise ValidationFailure("oneshot pipeline requires an input (http_input or file_reader)")

    # ---- node instantiation (oneshot.rs:214-267)
    nodes = {}
    for name, d in pipeline.nodes.items():
        nodes[name] = await registry.create_node_async(d.kind, d.params, resources=resources)

    # ---- io channels
    io_channels: Dict = {}
    body_rx: Optional[Channel] = None
    if http_inputs:
        body_rx = Channel(constants.ONESHOT_IO_CAPACITY, name="http_body")
        io_channels[(http_inputs[0], "in")] = body_rx
    out_ch = Channel(constants.ONESHOT_IO_CAPACITY, name="http_response")
    io_channels[(http_outputs[0], "out")] = out_ch

    if http_inputs:
        nodes[http_inputs[0]].input_content_type = input_content_type  # type: ignore[attr-defined]

    graph = await wire_and_spawn_graph(
        nodes,
        pipeline,
        io_channels=io_channels,
        resources=resources,
        audio_pool=audio_pool,
        batcher=batcher,
    )

    # ---- Start signals to file readers (oneshot.rs:294-316)
    for name in file_readers:
        graph.control_txs[name].try_send(NodeControlMessage.start())

    # ---- input pump (oneshot.rs:318-355)
    pump_task: Optional[asyncio.Task] = None
    if http_inputs and input_stream is not None:
        assert body_rx is not None

        async def pump() -> None:
            try:
                async for chunk in input_stream:
                    await body_rx.send(chunk)
            except ChannelClosed:
                pass  # pipeline stopped consuming — fine
            finally:
                body_rx.close()

        pump_task = asyncio.ensure_future(pump())  # errors surface in wait()
    elif body_rx is not None:
        body_rx.close()

    # ---- content-type negotiation (oneshot.rs:357-371)
    out_node = nodes[http_outputs[0]]
    content_type = (
        configured_content_type
        or out_node.content_type()
        or _upstream_content_type(nodes, pipeline, http_outputs[0])
        or input_content_type
        or "application/octet-stream"
    )

    return OneshotResult(content_type=content_type, output=out_ch, graph=graph, _pump_task=pump_task)


def _upstream_content_type(nodes, pipeline: Pipeline, output_node: str) -> Optional[str]:
    """Static content-type of the node feeding http_output (e.g. a muxer)."""
    for c in pipeline.connections:
        if c.to_node == output_node:
            return nodes[c.from_node].content_type()
    return None
