# SPDX-License-Identifier: Apache-2.0
"""Node registry: kind string → factory, plus API-facing definitions.

Parity with reference ``crates/core/src/registry.rs:77-420``:

* ``register(kind, factory)`` with optional description/schema/resource hook,
* ``create_node(kind, params)`` (sync) and ``create_node_async`` which first
  resolves shared resources (model weights) via the ResourceManager,
* ``definitions()`` instantiates each kind with ``params=None`` to read pins
  for the ``/api/v1/schema/nodes`` endpoint (reference ``registry.rs:369``).
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .errors import ConfigurationError
from .node import NodeFactory, ProcessorNode


def derive_param_schema(node_cls: type) -> Optional[dict]:
    """Best-effort JSON schema from a node class's ``parse_config_*`` call.

    The reference publishes a ``param_schema`` per node (node metadata,
    consumed by the UI inspector and docs); our nodes declare their params
    as the defaults dict passed to :func:`helpers.parse_config_optional` /
    ``parse_config_required`` — this introspects that dict from the
    ``__init__`` source and maps defaults to JSON-schema property types.
    Returns None when no declaration is found (e.g. native/wasm wrappers,
    whose schema comes from the plugin itself)."""
    import inspect
    import re

    try:
        src = inspect.getsource(node_cls.__init__)
    except (OSError, TypeError):
        return None
    src = re.sub(r"#[^\n]*", "", src)
    required: List[str] = []
    m = re.search(r"parse_config_required\(\s*params,\s*(\[.*?\])\s*,\s*(\{.*?\})\s*,?\s*\)", src, re.S)
    if m:
        try:
            required = eval(m.group(1), {"__builtins__": {}}, {})  # noqa: S307
            defaults = eval(m.group(2), {"__builtins__": {}}, {})  # noqa: S307
        except Exception:
            return None
    else:
        m = re.search(r"parse_config_optional\(\s*params,\s*(\{.*?\})\s*,?\s*\)", src, re.S)
        if not m:
            return None
        try:
            defaults = eval(m.group(1), {"__builtins__": {}}, {})  # noqa: S307
        except Exception:
            return None
    props: Dict[str, dict] = {}
    for name, default in defaults.items():
        prop: dict = {}
        if isinstance(default, bool):
            prop["type"] = "boolean"
        elif isinstance(default, int):
            prop["type"] = "integer"
        elif isinstance(default, float):
            prop["type"] = "number"
        elif isinstance(default, str):
            prop["type"] = "string"
        elif isinstance(default, (list, tuple)):
            prop["type"] = "array"
        elif isinstance(default, dict):
            prop["type"] = "object"
        if default is not None and name not in required:
            prop["default"] = list(default) if isinstance(default, tuple) else default
        props[name] = prop
    schema: dict = {"type": "object", "properties": props, "additionalProperties": False}
    if required:
        schema["required"] = sorted(required)
    return schema

__all__ = ["NodeRegistry", "NodeDefinition", "RegisteredNode"]


@dataclass
class RegisteredNode:
    kind: str
    factory: NodeFactory
    description: str = ""
    # Optional: (params) -> resource spec consumed by ResourceManager before
    # node construction (reference register_dynamic_with_resource).
    resource_loader: Optional[Callable[[Optional[dict], Any], Any]] = None
    param_schema: Optional[dict] = None  # JSON schema for params


@dataclass
class NodeDefinition:
    """API-facing node description (reference ``registry.rs:369-420``)."""

    kind: str
    description: str
    input_pins: List[dict]
    output_pins: List[dict]
    param_schema: Optional[dict] = None
    supports_dynamic_pins: bool = False

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "description": self.description,
            "input_pins": self.input_pins,
            "output_pins": self.output_pins,
            "param_schema": self.param_schema,
            "supports_dynamic_pins": self.supports_dynamic_pins,
        }


class NodeRegistry:
    """Thread-safe name→factory map."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: Dict[str, RegisteredNode] = {}

    def register(
        self,
        kind: str,
        factory: NodeFactory,
        description: str = "",
        resource_loader: Optional[Callable] = None,
        param_schema: Optional[dict] = None,
    ) -> None:
        with self._lock:
            self._nodes[kind] = RegisteredNode(
                kind, factory, description, resource_loader, param_schema
            )

    def register_node_class(self, cls, description: str = "", **kw) -> None:
        """Register a ProcessorNode subclass whose __init__ takes (params)."""
        kind = cls.KIND
        if not kind:
            raise ConfigurationError(f"{cls.__name__} has no KIND")
        self.register(kind, lambda params: cls(params), description or (cls.__doc__ or "").strip().splitlines()[0] if (description or cls.__doc__) else "", **kw)

    def unregister(self, kind: str) -> bool:
        with self._lock:
            return self._nodes.pop(kind, None) is not None

    def contains(self, kind: str) -> bool:
        with self._lock:
            return kind in self._nodes

    def kinds(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    # -- construction -----------------------------------------------------------
    def create_node(self, kind: str, params: Optional[dict] = None) -> ProcessorNode:
        with self._lock:
            entry = self._nodes.get(kind)
        if entry is None:
            raise ConfigurationError(f"unknown node kind: {kind!r}")
        node = entry.factory(params)
        node.KIND = kind
        return node

    async def create_node_async(
        self, kind: str, params: Optional[dict] = None, resources: Any = None
    ) -> ProcessorNode:
        """Resolve shared resources first, then construct (reference ``registry.rs:332``)."""
        with self._lock:
            entry = self._nodes.get(kind)
        if entry is None:
            raise ConfigurationError(f"unknown node kind: {kind!r}")
        if entry.resource_loader is not None and resources is not None:
            loaded = entry.resource_loader(params, resources)
            if asyncio.iscoroutine(loaded):
                loaded = await loaded
            params = dict(params or {})
            params["_resource"] = loaded
        node = entry.factory(params)
        node.KIND = kind
        return node

    # -- introspection -----------------------------------------------------------
    def definitions(self) -> List[NodeDefinition]:
        defs: List[NodeDefinition] = []
        for kind in self.kinds():
            with self._lock:
                entry = self._nodes[kind]
            try:
                probe = entry.factory(None)
            except Exception:
                continue  # kinds that can't instantiate param-free are skipped
            schema = entry.param_schema
            if schema is None:
                schema = derive_param_schema(type(probe))
            defs.append(
                NodeDefinition(
                    kind=kind,
                    description=entry.description,
                    input_pins=[p.to_json() for p in probe.input_pins()],
                    output_pins=[p.to_json() for p in probe.output_pins()],
                    param_schema=schema,
                    supports_dynamic_pins=probe.supports_dynamic_pins(),
                )
            )
        return defs
