# SPDX-License-Identifier: Apache-2.0
"""API contract: WS message envelope, pipeline model, YAML compiler."""

from .messages import (
    Connection,
    Pipeline,
    PipelineNode,
    make_event,
    make_request,
    make_response,
    parse_message,
)
from .yaml_compiler import compile_pipeline_dict, compile_yaml
