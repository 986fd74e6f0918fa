# SPDX-License-Identifier: Apache-2.0
"""The server layer: HTTP + WebSocket control plane (skit equivalent), on the
port's own standard-library HTTP/1.1 and WebSocket layer (:mod:`.http`).

The names below resolve at first use: importing a submodule such as
:mod:`.http` (the CLI's client) loads neither the app nor torch."""

import importlib

__all__ = [
    "AppState",
    "create_app",
    "run_server",
    "ServerConfig",
    "load_config",
    "Permissions",
    "RoleStore",
    "Session",
    "SessionManager",
]

_HOME = {
    "AppState": "app",
    "create_app": "app",
    "run_server": "app",
    "ServerConfig": "config",
    "load_config": "config",
    "Permissions": "permissions",
    "RoleStore": "permissions",
    "Session": "sessions",
    "SessionManager": "sessions",
}


def __getattr__(name: str):
    module = _HOME.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value
