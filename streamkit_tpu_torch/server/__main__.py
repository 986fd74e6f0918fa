# SPDX-License-Identifier: Apache-2.0
"""``python -m streamkit_tpu_torch.server`` — serve command (reference ``skit serve``).

``serve --device cuda`` (the default) runs the nodes on the card; ``--device
cpu`` on the CPU. ``--port 0`` binds an ephemeral port; the log names it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from .config import ServerConfig, load_config


def _config_schema() -> dict:
    """JSON schema derived from the ServerConfig dataclass (reference
    generates its config schema for docs, config.rs:553+)."""
    import dataclasses
    import typing

    def field_schema(tp):
        origin = typing.get_origin(tp)
        if tp is bool:
            return {"type": "boolean"}
        if tp is int:
            return {"type": "integer"}
        if tp is float:
            return {"type": "number"}
        if tp is str:
            return {"type": "string"}
        if origin in (list, typing.List):
            return {"type": "array"}
        if origin in (dict, typing.Dict):
            return {"type": "object"}
        if origin is typing.Union:
            non_none = [a for a in typing.get_args(tp) if a is not type(None)]
            if len(non_none) == 1:
                inner = field_schema(non_none[0])
                inner["nullable"] = True
                return inner
        return {}

    hints = typing.get_type_hints(ServerConfig)
    props = {}
    for f in dataclasses.fields(ServerConfig):
        sch = field_schema(hints.get(f.name, str))
        if f.default is not dataclasses.MISSING:
            sch["default"] = f.default
        props[f.name] = sch
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "title": "ServerConfig",
        "type": "object",
        "properties": props,
    }


def _default_toml() -> str:
    """Default config rendered as commented TOML (reference `config default`)."""
    c = ServerConfig()
    return f"""\
[server]
address = "{c.address}"
port = {c.port}
max_body_size = {c.max_body_size}
base_path = "{c.base_path}"
# tls_cert = "cert.pem"
# tls_key = "key.pem"

[engine]
profile = "{c.engine_profile}"  # low-latency | balanced | high-throughput
packet_batch_size = {c.packet_batch_size}
oneshot_concurrency_limit = {c.oneshot_concurrency_limit}

[resources]
keep_models_loaded = {str(c.keep_models_loaded).lower()}
max_memory_mb = {c.max_model_memory_mb}

[security]
allowed_file_paths = []
allowed_write_paths = []

[permissions]
default_role = "{c.default_role}"
# role_header = "x-skit-role"

[moq]
enabled = {str(c.moq_enabled).lower()}
host = "{c.moq_host}"
port = {c.moq_port}

[telemetry]
# otlp_endpoint = "http://localhost:4318"
otlp_interval_secs = {c.otlp_interval_secs}

[storage]
samples_dir = "{c.samples_dir}"
assets_dir = "{c.assets_dir}"
plugins_dir = "{c.plugins_dir}"
"""


class _JsonFormatter(logging.Formatter):
    """Structured log lines (reference logging.rs JSON layer)."""

    def format(self, record):
        import time as _t

        doc = {
            "ts": _t.strftime("%Y-%m-%dT%H:%M:%S", _t.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            doc["exception"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def _setup_logging(level: str, log_file, log_format: str) -> None:
    """Console + optional file layer, text or JSON (reference
    logging.rs:88-171); SK_LOG env-filter overrides the level."""
    level = (os.environ.get("SK_LOG") or level).upper()
    root = logging.getLogger()
    root.setLevel(getattr(logging, level, logging.INFO))
    fmt = (
        _JsonFormatter()
        if log_format == "json"
        else logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
    )
    console = logging.StreamHandler()
    console.setFormatter(fmt)
    root.addHandler(console)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="skit-tpu", description="StreamKit server (PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="command")

    serve = sub.add_parser("serve", help="start the server")
    serve.add_argument("--config", "-c", default=None, help="TOML config file")
    serve.add_argument("--address", default=None)
    serve.add_argument("--port", "-p", type=int, default=None)
    serve.add_argument("--log-level", default="info")
    serve.add_argument("--log-file", default=None, help="also log to this file")
    serve.add_argument("--log-format", default="text", choices=["text", "json"])
    serve.add_argument(
        "--device",
        default=os.environ.get("SK_DEVICE", "cuda"),
        help="where the nodes compute: 'cuda' (default; refuses to start without a card), "
        "'cuda:N' or 'cpu'",
    )

    cfg_cmd = sub.add_parser("config", help="config utilities")
    cfg_sub = cfg_cmd.add_subparsers(dest="config_command")
    dflt = cfg_sub.add_parser("default", help="print the default config (TOML)")
    dflt.add_argument("--json", action="store_true")
    cfg_sub.add_parser("schema", help="print the config JSON schema")

    args = parser.parse_args(argv)
    if args.command == "config":
        if args.config_command == "schema":
            print(json.dumps(_config_schema(), indent=2))
            return 0
        if getattr(args, "json", False):
            print(json.dumps(ServerConfig().to_json(), indent=2))
        else:
            print(_default_toml())
        return 0
    if args.command in (None, "serve"):
        config = load_config(getattr(args, "config", None))
        if getattr(args, "address", None):
            config.address = args.address
        if getattr(args, "port", None) is not None:
            config.port = args.port
        _setup_logging(
            getattr(args, "log_level", "info"),
            getattr(args, "log_file", None),
            getattr(args, "log_format", "text"),
        )
        from .app import run_server

        run_server(config, device=getattr(args, "device", None))
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
