# SPDX-License-Identifier: Apache-2.0
"""The server layer: HTTP + WebSocket control plane (skit equivalent), on the
port's own standard-library HTTP/1.1 and WebSocket layer (:mod:`.http`)."""

from .app import AppState, create_app, run_server
from .config import ServerConfig, load_config
from .permissions import Permissions, RoleStore
from .sessions import Session, SessionManager
