# SPDX-License-Identifier: Apache-2.0
"""Model family ``whisper`` (a configuration's ``"model_type": "whisper"``):
Whisper's sizes and the program's ``WhisperConfig``, the CPU rehearsal's
size, the native sources a Whisper cell reaches, and the weights drawn from
the seed (:mod:`weights`) built into the program's parameters."""

from __future__ import annotations

import weights


def attributes(cfg: dict) -> dict:
    """What a traffic driver reads of the model on its ``ctx``: ``dims``
    (the sizes under the names the code uses), ``port_cfg`` (the program's
    ``WhisperConfig``) and ``port_size`` (the program's size name)."""
    return {"dims": weights.dims(cfg), "port_cfg": weights.port_config(cfg), "port_size": cfg["port_size"]}


def dry_config(cfg: dict) -> dict:
    """The configuration at two layers of width 256 (four heads of 64): the
    CPU rehearsal's size."""
    return dict(cfg, d_model=256, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                decoder_attention_heads=4, encoder_ffn_dim=1024, decoder_ffn_dim=1024)


def sources() -> list:
    """The native sources a Whisper cell can reach: K1 (the oneshot
    encoder's attention), K2, K3 and K4 (the fused live step) and the
    engine's ingest shim."""
    from streamkit_tpu_torch.engine import ingest
    from streamkit_tpu_torch.ops import attention, cache_write, decode_attention, stream_attention

    return [attention.SOURCE, cache_write.SOURCE, stream_attention.SOURCE, decode_attention.SOURCE, ingest.SOURCE]


def draw(cfg: dict, seed: int, device) -> dict:
    """The weight tree the reference reads, drawn on ``device`` from ``seed``."""
    return weights.draw(cfg, seed, device)


def build(tree: dict):
    """The program's parameters of ``tree``."""
    from streamkit_tpu_torch.models.whisper.model import build_params

    return build_params(tree)
