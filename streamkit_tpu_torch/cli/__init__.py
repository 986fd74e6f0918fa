# SPDX-License-Identifier: Apache-2.0
"""Client CLI (skit-cli equivalent) on the port's own HTTP / WebSocket client."""

from .client import SkitClient
