# SPDX-License-Identifier: Apache-2.0
"""Role-based access control.

Parity with reference ``apps/skit/src/permissions.rs:20-107`` +
``role_extractor.rs:87``: boolean capabilities plus glob allowlists for node
kinds / plugins / samples / assets; role chosen by a trusted header when
configured, else the default role.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Permissions", "RoleStore", "PermissionDenied"]


class PermissionDenied(Exception):
    def __init__(self, capability: str) -> None:
        super().__init__(f"permission denied: {capability}")
        self.capability = capability


_CAPABILITIES = [
    "create_sessions",
    "destroy_sessions",
    "list_sessions",
    "modify_sessions",
    "tune_nodes",
    "load_plugins",
    "delete_plugins",
    "list_nodes",
    "list_samples",
    "read_samples",
    "write_samples",
    "delete_samples",
    "access_all_sessions",
    "upload_assets",
    "delete_assets",
]


@dataclass
class Permissions:
    create_sessions: bool = False
    destroy_sessions: bool = False
    list_sessions: bool = False
    modify_sessions: bool = False
    tune_nodes: bool = False
    load_plugins: bool = False
    delete_plugins: bool = False
    list_nodes: bool = False
    list_samples: bool = False
    read_samples: bool = False
    write_samples: bool = False
    delete_samples: bool = False
    access_all_sessions: bool = False
    upload_assets: bool = False
    delete_assets: bool = False
    allowed_nodes: List[str] = field(default_factory=lambda: ["*"])
    allowed_plugins: List[str] = field(default_factory=lambda: ["*"])
    allowed_samples: List[str] = field(default_factory=lambda: ["*"])
    allowed_assets: List[str] = field(default_factory=lambda: ["*"])

    @staticmethod
    def admin() -> "Permissions":
        p = Permissions()
        for cap in _CAPABILITIES:
            setattr(p, cap, True)
        return p

    @staticmethod
    def from_dict(d: dict) -> "Permissions":
        p = Permissions()
        for cap in _CAPABILITIES:
            setattr(p, cap, bool(d.get(cap, False)))
        for key in ("allowed_nodes", "allowed_plugins", "allowed_samples", "allowed_assets"):
            if key in d:
                setattr(p, key, list(d[key]))
        return p

    def check(self, capability: str) -> None:
        if not getattr(self, capability, False):
            raise PermissionDenied(capability)

    def node_allowed(self, kind: str) -> bool:
        return any(fnmatch.fnmatch(kind, pat) for pat in self.allowed_nodes)

    def sample_allowed(self, name: str) -> bool:
        return any(fnmatch.fnmatch(name, pat) for pat in self.allowed_samples)

    def to_json(self) -> dict:
        return {cap: getattr(self, cap) for cap in _CAPABILITIES}


class RoleStore:
    """role name → Permissions, with header-based extraction."""

    def __init__(
        self,
        roles: Optional[Dict[str, dict]] = None,
        default_role: str = "admin",
        role_header: Optional[str] = None,
    ) -> None:
        self.roles: Dict[str, Permissions] = {"admin": Permissions.admin()}
        for name, d in (roles or {}).items():
            self.roles[name] = Permissions.from_dict(d)
        self.default_role = default_role
        self.role_header = role_header

    def extract(self, headers) -> tuple:
        """(role_name, Permissions) for a request (reference role_extractor)."""
        role = self.default_role
        if self.role_header:
            role = headers.get(self.role_header, self.default_role)
        perms = self.roles.get(role)
        if perms is None:
            perms = Permissions()  # unknown role: no capabilities
        return role, perms
