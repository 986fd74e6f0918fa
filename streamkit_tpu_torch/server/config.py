# SPDX-License-Identifier: Apache-2.0
"""Server configuration: TOML + env overrides, perf profiles.

Parity with reference ``apps/skit/src/config.rs:21-47,553+``: profiles map to
channel-capacity presets; env vars override file values (``SK_`` prefix).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["ServerConfig", "EngineProfile", "load_config", "PROFILES"]


@dataclass
class EngineProfile:
    node_input_capacity: int
    pin_distributor_capacity: int


# reference config.rs:33-47
PROFILES: Dict[str, EngineProfile] = {
    "low-latency": EngineProfile(8, 4),
    "balanced": EngineProfile(32, 16),
    "high-throughput": EngineProfile(128, 64),
}


@dataclass
class ServerConfig:
    address: str = "127.0.0.1"
    port: int = 8080
    max_body_size: int = 512 * 1024 * 1024
    base_path: str = ""
    cors_origins: List[str] = field(default_factory=list)
    allowed_origins: List[str] = field(default_factory=list)  # Origin header guard
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None

    engine_profile: str = "high-throughput"
    packet_batch_size: int = 32
    oneshot_concurrency_limit: int = 0  # 0 = unlimited

    log_level: str = "info"

    # resources (reference [resources])
    keep_models_loaded: bool = True
    max_model_memory_mb: int = 0
    prewarm: List[dict] = field(default_factory=list)

    # security (reference [security])
    allowed_file_paths: List[str] = field(default_factory=list)
    allowed_write_paths: List[str] = field(default_factory=list)

    # script policy (reference [script], config.rs:440-510): fetch allowlist
    # rules {url, methods} and secrets {name: {env, allowed_fetch_urls}}
    script_fetch_allowlist: List[dict] = field(default_factory=list)
    script_secrets: Dict[str, dict] = field(default_factory=dict)

    # permissions
    default_role: str = "admin"
    role_header: Optional[str] = None
    roles: Dict[str, dict] = field(default_factory=dict)
    # global admission limits (reference permissions.rs:316-321; None =
    # unlimited). Sessions REJECT at the limit ("Maximum concurrent sessions
    # limit reached"); oneshots QUEUE (the reference's ConcurrencyLimitLayer
    # waits, server.rs:1854-1856)
    max_concurrent_sessions: Optional[int] = None
    max_concurrent_oneshots: Optional[int] = None

    # MoQ WebTransport acceptor (reference [moq]: server.rs:1975-2085)
    moq_enabled: bool = True
    moq_host: str = "127.0.0.1"
    moq_port: int = 4443

    # telemetry (reference [telemetry]/OTEL_* env: OTLP push, telemetry.rs)
    otlp_endpoint: Optional[str] = None
    otlp_interval_secs: float = 5.0
    otlp_headers: Dict[str, str] = field(default_factory=dict)

    # storage
    samples_dir: str = "samples"
    assets_dir: str = "samples/audio"
    plugins_dir: str = "plugins"

    @property
    def profile(self) -> EngineProfile:
        return PROFILES.get(self.engine_profile, PROFILES["high-throughput"])

    def to_json(self) -> dict:
        return {
            "server": {
                "address": self.address,
                "port": self.port,
                "max_body_size": self.max_body_size,
                "base_path": self.base_path,
            },
            "engine": {
                "profile": self.engine_profile,
                "packet_batch_size": self.packet_batch_size,
            },
            "resources": {
                "keep_models_loaded": self.keep_models_loaded,
                "max_memory_mb": self.max_model_memory_mb,
            },
            "security": {
                "allowed_file_paths": self.allowed_file_paths,
                "allowed_write_paths": self.allowed_write_paths,
            },
            "permissions": {
                "default_role": self.default_role,
                "roles": list(self.roles),
                "max_concurrent_sessions": self.max_concurrent_sessions,
                "max_concurrent_oneshots": self.max_concurrent_oneshots,
            },
        }


def load_config(path: Optional[str] = None) -> ServerConfig:
    """Load TOML config with ``SK_*`` env overrides."""
    cfg = ServerConfig()
    doc: Dict[str, Any] = {}
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            doc = tomllib.load(f)
    server = doc.get("server", {})
    engine = doc.get("engine", {})
    resources = doc.get("resources", {})
    security = doc.get("security", {})
    permissions = doc.get("permissions", {})
    storage = doc.get("storage", {})

    cfg.address = server.get("address", cfg.address)
    cfg.port = int(server.get("port", cfg.port))
    cfg.max_body_size = int(server.get("max_body_size", cfg.max_body_size))
    cfg.base_path = server.get("base_path", cfg.base_path)
    cfg.cors_origins = server.get("cors_origins", cfg.cors_origins)
    cfg.allowed_origins = server.get("allowed_origins", cfg.allowed_origins)
    cfg.tls_cert = server.get("tls_cert", cfg.tls_cert)
    cfg.tls_key = server.get("tls_key", cfg.tls_key)
    cfg.engine_profile = engine.get("profile", cfg.engine_profile)
    cfg.packet_batch_size = int(engine.get("packet_batch_size", cfg.packet_batch_size))
    cfg.oneshot_concurrency_limit = int(
        engine.get("oneshot_concurrency_limit", cfg.oneshot_concurrency_limit)
    )
    cfg.keep_models_loaded = bool(resources.get("keep_models_loaded", cfg.keep_models_loaded))
    cfg.max_model_memory_mb = int(resources.get("max_memory_mb", cfg.max_model_memory_mb))
    cfg.prewarm = resources.get("prewarm", cfg.prewarm)
    cfg.allowed_file_paths = security.get("allowed_file_paths", cfg.allowed_file_paths)
    cfg.allowed_write_paths = security.get("allowed_write_paths", cfg.allowed_write_paths)
    script = doc.get("script", {})
    cfg.script_fetch_allowlist = script.get(
        "global_fetch_allowlist", cfg.script_fetch_allowlist
    )
    cfg.script_secrets = script.get("secrets", cfg.script_secrets)
    cfg.default_role = permissions.get("default_role", cfg.default_role)
    cfg.role_header = permissions.get("role_header", cfg.role_header)
    cfg.roles = permissions.get("roles", cfg.roles)
    if permissions.get("max_concurrent_sessions") is not None:
        cfg.max_concurrent_sessions = int(permissions["max_concurrent_sessions"])
    if permissions.get("max_concurrent_oneshots") is not None:
        cfg.max_concurrent_oneshots = int(permissions["max_concurrent_oneshots"])
    moq = doc.get("moq", {})
    cfg.moq_enabled = bool(moq.get("enabled", cfg.moq_enabled))
    cfg.moq_host = moq.get("host", cfg.moq_host)
    cfg.moq_port = int(moq.get("port", cfg.moq_port))
    telemetry = doc.get("telemetry", {})
    cfg.otlp_endpoint = telemetry.get("otlp_endpoint", cfg.otlp_endpoint)
    cfg.otlp_interval_secs = float(
        telemetry.get("otlp_interval_secs", cfg.otlp_interval_secs)
    )
    cfg.otlp_headers = telemetry.get("otlp_headers", cfg.otlp_headers)
    cfg.samples_dir = storage.get("samples_dir", cfg.samples_dir)
    cfg.assets_dir = storage.get("assets_dir", cfg.assets_dir)
    cfg.plugins_dir = storage.get("plugins_dir", cfg.plugins_dir)

    # env overrides (figment-style SK_ prefix)
    env = os.environ
    cfg.address = env.get("SK_SERVER_ADDRESS", cfg.address)
    cfg.port = int(env.get("SK_SERVER_PORT", cfg.port))
    cfg.default_role = env.get("SK_ROLE", cfg.default_role)
    cfg.engine_profile = env.get("SK_ENGINE_PROFILE", cfg.engine_profile)
    return cfg
