# SPDX-License-Identifier: Apache-2.0
"""YAML pipeline compiler: user-facing formats → explicit Pipeline.

Behavioral parity with reference ``crates/api/src/yaml.rs:103-340``:

* **Steps format** — ``steps: [{kind, params}, ...]`` → nodes named
  ``step_N`` chained ``out``→``in``.
* **DAG format** — ``nodes: {name: {kind, params, needs}}`` where ``needs``
  is a node name, ``{node, mode}`` object, or list thereof. Multi-input nodes
  get numbered pins ``in_0``, ``in_1``, …; per-edge ``mode: best_effort``.
* DFS cycle detection; cycles through bidirectional kinds
  (``transport::moq::peer``) are allowed (``yaml.rs:146-160``).
* ``audio::mixer`` ``num_inputs`` auto-injection for non-dynamic pipelines
  (``yaml.rs:310-340``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core.control import ConnectionMode
from ..core.errors import ConfigurationError
from .messages import Connection, Pipeline, PipelineNode

__all__ = ["compile_yaml", "compile_pipeline_dict", "BIDIRECTIONAL_NODE_KINDS"]

BIDIRECTIONAL_NODE_KINDS = ("transport::moq::peer",)


def compile_yaml(text: str) -> Pipeline:
    """Parse + compile a user YAML pipeline. PyYAML is imported here only,
    so :func:`compile_pipeline_dict` works where it is not installed."""
    import yaml

    try:
        doc = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise ConfigurationError(f"invalid YAML: {e}") from e
    if not isinstance(doc, dict):
        raise ConfigurationError("pipeline YAML must be a mapping")
    return compile_pipeline_dict(doc)


def compile_pipeline_dict(doc: dict) -> Pipeline:
    name = doc.get("name")
    description = doc.get("description")
    mode = str(doc.get("mode", "dynamic")).lower()
    if mode not in ("oneshot", "dynamic"):
        raise ConfigurationError(f"invalid mode {mode!r} (expected oneshot|dynamic)")

    has_steps = "steps" in doc
    has_nodes = "nodes" in doc
    if has_steps == has_nodes:
        raise ConfigurationError("pipeline must have exactly one of 'steps' or 'nodes'")

    if has_steps:
        p = _compile_steps(name, description, mode, doc["steps"])
    else:
        p = _compile_dag(name, description, mode, doc["nodes"])
    # operator fusion (the accelerator-framework move applied to the host data
    # plane): `optimize: false` keeps the literal graph
    if doc.get("optimize", True):
        _fuse_decode_resample(p)
    return p


# opus decoders natively synthesize at these rates (RFC 6716 §2) — see
# OpusDecoderNode.sample_rate
_OPUS_NATIVE_RATES = (8000, 12000, 16000, 24000, 48000)


def _fuse_decode_resample(p: Pipeline) -> None:
    """Fuse ``audio::opus::decoder → audio::resampler`` into one decoder
    running natively at the resampler's target rate.

    Valid only when the pair is exclusively wired out→in, the target is an
    Opus-native rate, the decoder is at its default 48 kHz, and the
    resampler does no frame-size regularization (``output_frame_size: 0``
    — with the default 960 it re-chunks the stream, which the decoder's
    per-packet output would not preserve). Saves the resample stage and a
    per-packet channel hop per session — measured as a material share of
    the 1-core ingress budget at 128 live sessions (PERF_NOTES round 4)."""
    while True:
        fused = False
        for c in list(p.connections):
            a = p.nodes.get(c.from_node)
            b = p.nodes.get(c.to_node)
            if (
                a is None or b is None
                or a.kind != "audio::opus::decoder"
                or b.kind != "audio::resampler"
                or c.from_pin != "out" or c.to_pin != "in"
            ):
                continue
            ap = a.params or {}
            bp = b.params or {}
            target = bp.get("target_sample_rate")
            if (
                target not in _OPUS_NATIVE_RATES
                or int(ap.get("sample_rate", 48000)) != 48000
                or int(bp.get("output_frame_size", 960)) != 0
            ):
                continue
            # exclusivity: decoder.out feeds only this resampler; the
            # resampler has no other inputs
            outs = [x for x in p.connections if x.from_node == c.from_node]
            ins = [x for x in p.connections if x.to_node == c.to_node]
            if len(outs) != 1 or len(ins) != 1:
                continue
            a.params = dict(ap, sample_rate=int(target))
            p.connections.remove(c)
            for x in p.connections:
                if x.from_node == c.to_node:
                    x.from_node = c.from_node
            del p.nodes[c.to_node]
            fused = True
            break
        if not fused:
            return


# ---------------------------------------------------------------------------
def _compile_steps(name, description, mode, steps) -> Pipeline:
    if not isinstance(steps, list):
        raise ConfigurationError("'steps' must be a list")
    nodes: Dict[str, PipelineNode] = {}
    connections: List[Connection] = []
    for i, step in enumerate(steps):
        if not isinstance(step, dict) or "kind" not in step:
            raise ConfigurationError(f"step {i} must be a mapping with a 'kind'")
        node_name = f"step_{i}"
        if i > 0:
            connections.append(Connection(f"step_{i-1}", "out", node_name, "in"))
        nodes[node_name] = PipelineNode(kind=step["kind"], params=step.get("params"))
    return Pipeline(name, description, mode, nodes, connections)


# ---------------------------------------------------------------------------
def _parse_needs(needs) -> List[Tuple[str, ConnectionMode]]:
    """Normalize needs: None | str | {node, mode} | list of those."""
    if needs is None:
        return []
    if isinstance(needs, str):
        return [(needs, ConnectionMode.RELIABLE)]
    if isinstance(needs, dict):
        return [(needs["node"], ConnectionMode(needs.get("mode", "reliable")))]
    if isinstance(needs, list):
        out: List[Tuple[str, ConnectionMode]] = []
        for n in needs:
            out.extend(_parse_needs(n))
        return out
    raise ConfigurationError(f"invalid 'needs' value: {needs!r}")


def _detect_cycles(user_nodes: Dict[str, dict]) -> None:
    """DFS cycle detection with bidirectional exemption (``yaml.rs:146-255``)."""
    adjacency: Dict[str, List[str]] = {n: [] for n in user_nodes}
    for node_name, node_def in user_nodes.items():
        for dep_name, _ in _parse_needs(node_def.get("needs")):
            if dep_name in user_nodes:
                adjacency[dep_name].append(node_name)  # data flows dep → node

    visited: set = set()
    rec_stack: set = set()
    path: List[str] = []

    def dfs(node: str) -> Optional[Tuple[List[str], str]]:
        visited.add(node)
        rec_stack.add(node)
        path.append(node)
        for nb in adjacency.get(node, ()):
            if nb not in visited:
                found = dfs(nb)
                if found:
                    rec_stack.discard(node)
                    path.pop()
                    return found
            elif nb in rec_stack:
                start = path.index(nb) if nb in path else 0
                cycle_nodes = path[start:]
                desc = f"Circular dependency detected: {' -> '.join(cycle_nodes)} -> {nb}"
                rec_stack.discard(node)
                path.pop()
                return (cycle_nodes, desc)
        rec_stack.discard(node)
        path.pop()
        return None

    for node_name in user_nodes:
        if node_name not in visited:
            found = dfs(node_name)
            if found:
                cycle_nodes, desc = found
                has_bidir = any(
                    user_nodes.get(n, {}).get("kind") in BIDIRECTIONAL_NODE_KINDS
                    for n in cycle_nodes
                )
                if not has_bidir:
                    raise ConfigurationError(desc)


def _compile_dag(name, description, mode, user_nodes) -> Pipeline:
    if not isinstance(user_nodes, dict):
        raise ConfigurationError("'nodes' must be a mapping")
    for node_name, node_def in user_nodes.items():
        if not isinstance(node_def, dict) or "kind" not in node_def:
            raise ConfigurationError(f"node {node_name!r} must be a mapping with a 'kind'")

    _detect_cycles(user_nodes)

    connections: List[Connection] = []
    for node_name, node_def in user_nodes.items():
        deps = _parse_needs(node_def.get("needs"))
        for idx, (dep_name, dep_mode) in enumerate(deps):
            if dep_name not in user_nodes:
                raise ConfigurationError(
                    f"Node '{node_name}' references non-existent node '{dep_name}' in 'needs' field"
                )
            to_pin = f"in_{idx}" if len(deps) > 1 else "in"
            connections.append(Connection(dep_name, "out", node_name, to_pin, dep_mode))

    incoming: Dict[str, int] = {}
    for c in connections:
        incoming[c.to_node] = incoming.get(c.to_node, 0) + 1

    nodes: Dict[str, PipelineNode] = {}
    for node_name, node_def in user_nodes.items():
        params = node_def.get("params")
        # mixer num_inputs auto-injection for static pipelines (yaml.rs:310-340)
        if node_def["kind"] == "audio::mixer" and mode != "dynamic":
            count = incoming.get(node_name, 0)
            if count > 1:
                if params is None:
                    params = {"num_inputs": count}
                elif isinstance(params, dict) and params.get("num_inputs") is None:
                    params = dict(params)
                    params["num_inputs"] = count
        nodes[node_name] = PipelineNode(kind=node_def["kind"], params=params)

    return Pipeline(name, description, mode, nodes, connections)
