# SPDX-License-Identifier: Apache-2.0
"""TypeScript bindings generator for the WS/HTTP API contract.

Parity target: reference ``api/src/bin/generate_ts_types.rs`` (``ts_rs``
export consumed by the React UI). Run:

    python -m streamkit_tpu_torch.api.gen_ts_types > bindings.ts
"""

from __future__ import annotations

from .messages import PERMISSION_FIELDS

HEADER = "// Generated by streamkit_tpu_torch.api.gen_ts_types — do not edit.\n"

STATIC_TYPES = """
export type MessageType = "request" | "response" | "event";
export type ConnectionMode = "reliable" | "best_effort";
export type EngineMode = "oneshot" | "dynamic";

export interface Message<T> {
  type: MessageType;
  correlation_id?: string;
  payload: T;
}

export interface Connection {
  from_node: string;
  from_pin: string;
  to_node: string;
  to_pin: string;
  mode?: ConnectionMode;
}

export interface Node {
  kind: string;
  params?: Record<string, unknown> | null;
  state?: NodeState | null;
}

export type NodeState =
  | "initializing" | "ready" | "running"
  | { recovering: { attempt: number; max_attempts: number } }
  | { degraded: { reason: string } }
  | { failed: { reason: string } }
  | { stopped: { reason: string } };

export interface NodeStats {
  received: number;
  sent: number;
  discarded: number;
  errored: number;
  duration_secs: number;
}

export interface Pipeline {
  name?: string;
  description?: string;
  mode: EngineMode;
  nodes: Record<string, Node>;
  connections: Connection[];
}

export interface SessionInfo {
  id: string;
  name?: string;
  created_at: string;
}

export interface NodeDefinition {
  kind: string;
  description: string;
  input_pins: unknown[];
  output_pins: unknown[];
  param_schema?: unknown;
  supports_dynamic_pins: boolean;
}

export type BatchOperation =
  | { action: "addnode"; node_id: string; kind: string; params?: Record<string, unknown> }
  | { action: "removenode"; node_id: string }
  | { action: "connect"; from_node: string; from_pin: string; to_node: string; to_pin: string; mode?: ConnectionMode }
  | { action: "disconnect"; from_node: string; from_pin: string; to_node: string; to_pin: string };

export type RequestPayload =
  | { action: "createsession"; name?: string }
  | { action: "destroysession"; session_id: string }
  | { action: "listsessions" }
  | { action: "listnodes" }
  | { action: "addnode"; session_id: string; node_id: string; kind: string; params?: Record<string, unknown> }
  | { action: "removenode"; session_id: string; node_id: string }
  | { action: "connect"; session_id: string; from_node: string; from_pin: string; to_node: string; to_pin: string; mode?: ConnectionMode }
  | { action: "disconnect"; session_id: string; from_node: string; from_pin: string; to_node: string; to_pin: string }
  | { action: "tunenode"; session_id: string; node_id: string; message: NodeControlMessage }
  | { action: "tunenodeasync"; session_id: string; node_id: string; message: NodeControlMessage }
  | { action: "getpipeline"; session_id: string }
  | { action: "validatebatch"; session_id: string; operations: BatchOperation[] }
  | { action: "applybatch"; session_id: string; operations: BatchOperation[] }
  | { action: "getpermissions" };

export type NodeControlMessage =
  | { type: "update_params"; params: Record<string, unknown> }
  | { type: "start" }
  | { type: "shutdown" };

export type ResponsePayload =
  | { action: "sessioncreated"; session_id: string; name?: string; created_at: string }
  | { action: "sessiondestroyed"; session_id: string }
  | { action: "sessionslisted"; sessions: SessionInfo[] }
  | { action: "nodeslisted"; nodes: NodeDefinition[] }
  | { action: "pipeline"; pipeline: Pipeline }
  | { action: "validationresult"; errors: ValidationError[] }
  | { action: "batchapplied"; success: boolean; errors: string[] }
  | { action: "permissions"; role: string; permissions: PermissionsInfo }
  | { action: "success" }
  | { action: "error"; message: string };

export interface ValidationError {
  error_type: "error" | "warning";
  message: string;
  node_id?: string | null;
  connection_id?: string | null;
}

export type EventPayload =
  | { event: "nodestatechanged"; session_id: string; node_id: string; state: NodeState; timestamp: string }
  | { event: "nodestatsupdated"; session_id: string; node_id: string; stats: NodeStats; timestamp: string }
  | { event: "nodeparamschanged"; session_id: string; node_id: string; params: Record<string, unknown> }
  | { event: "sessioncreated"; session_id: string; name?: string; created_at: string }
  | { event: "sessiondestroyed"; session_id: string }
  | { event: "nodeadded"; session_id: string; node_id: string; kind: string; params?: Record<string, unknown> }
  | { event: "noderemoved"; session_id: string; node_id: string }
  | { event: "connectionadded"; session_id: string; from_node: string; from_pin: string; to_node: string; to_pin: string }
  | { event: "connectionremoved"; session_id: string; from_node: string; from_pin: string; to_node: string; to_pin: string }
  | { event: "nodetelemetry"; session_id: string; node_id: string; type_id: string; data: Record<string, unknown>; timestamp_us?: number; timestamp: string };
"""


def generate() -> str:
    perms = "\n".join(f"  {field}: boolean;" for field in PERMISSION_FIELDS)
    return HEADER + STATIC_TYPES + f"\nexport interface PermissionsInfo {{\n{perms}\n}}\n"


if __name__ == "__main__":
    print(generate())
