# SPDX-License-Identifier: Apache-2.0
"""Whisper weight loading into the port's :class:`~.model.Params`.

Port of ``streamkit_tpu/models/whisper/load.py``: an HF
``WhisperForConditionalGeneration`` state dict converts to the parameter
tree (``transformers`` is imported only by :func:`load_pretrained`). Beside
it, :func:`params_from_numpy` carries a parameter tree of numpy arrays (for
example the JAX package's, fetched to the host) across unchanged, so both
packages compute with the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...device import resolve_device
from .config import WhisperConfig
from .model import Params, build_params, init_params

__all__ = [
    "config_from_hf",
    "params_from_hf_state_dict",
    "params_from_numpy",
    "load_pretrained",
    "init_params",
]


def config_from_hf(hf_config) -> WhisperConfig:
    return WhisperConfig(
        n_mels=hf_config.num_mel_bins,
        n_audio_ctx=hf_config.max_source_positions,
        n_audio_state=hf_config.d_model,
        n_audio_head=hf_config.encoder_attention_heads,
        n_audio_layer=hf_config.encoder_layers,
        n_vocab=hf_config.vocab_size,
        n_text_ctx=hf_config.max_target_positions,
        n_text_state=hf_config.d_model,
        n_text_head=hf_config.decoder_attention_heads,
        n_text_layer=hf_config.decoder_layers,
    )


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree, cfg: WhisperConfig, dtype=torch.float32, device=None) -> Params:
    """Nested dict/list of arrays in the reference's layout → :class:`Params`
    on ``device`` (default ``cuda``). Values are copied, then cast."""
    dev = resolve_device(device)
    params = build_params(
        _tree_map(tree, lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev).to(dtype))
    )
    if len(params["enc"]["layers"]) != cfg.n_audio_layer or len(params["dec"]["layers"]) != cfg.n_text_layer:
        raise ValueError("parameter tree does not match the config's layer counts")
    return params


def params_from_hf_state_dict(
    sd: Dict[str, np.ndarray], cfg: WhisperConfig, dtype=torch.float32, device=None
) -> Params:
    """Convert an HF state dict (numpy arrays) to the parameter tree."""

    def t(name):
        return np.asarray(sd[name], np.float32)

    def lin(prefix, bias=True):
        p = {"w": t(f"{prefix}.weight").T}
        if bias:
            p["b"] = t(f"{prefix}.bias")
        return p

    def ln(prefix):
        return {"g": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    def attn(prefix):
        return {
            "q": lin(f"{prefix}.q_proj"),
            "k": lin(f"{prefix}.k_proj", bias=False),
            "v": lin(f"{prefix}.v_proj"),
            "o": lin(f"{prefix}.out_proj"),
        }

    def enc_layer(i):
        p = f"model.encoder.layers.{i}"
        return {
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "attn": attn(f"{p}.self_attn"),
            "ln2": ln(f"{p}.final_layer_norm"),
            "mlp1": lin(f"{p}.fc1"),
            "mlp2": lin(f"{p}.fc2"),
        }

    def dec_layer(i):
        p = f"model.decoder.layers.{i}"
        return {
            "ln1": ln(f"{p}.self_attn_layer_norm"),
            "attn": attn(f"{p}.self_attn"),
            "ln_x": ln(f"{p}.encoder_attn_layer_norm"),
            "xattn": attn(f"{p}.encoder_attn"),
            "ln2": ln(f"{p}.final_layer_norm"),
            "mlp1": lin(f"{p}.fc1"),
            "mlp2": lin(f"{p}.fc2"),
        }

    tree = {
        "enc": {
            # HF conv weight layout: [out, in, k] → the reference's [k, in, out]
            "conv1": {"w": t("model.encoder.conv1.weight").transpose(2, 1, 0),
                      "b": t("model.encoder.conv1.bias")},
            "conv2": {"w": t("model.encoder.conv2.weight").transpose(2, 1, 0),
                      "b": t("model.encoder.conv2.bias")},
            "pos": t("model.encoder.embed_positions.weight"),
            "layers": [enc_layer(i) for i in range(cfg.n_audio_layer)],
            "ln_post": ln("model.encoder.layer_norm"),
        },
        "dec": {
            "tok_emb": t("model.decoder.embed_tokens.weight"),
            "pos_emb": t("model.decoder.embed_positions.weight"),
            "layers": [dec_layer(i) for i in range(cfg.n_text_layer)],
            "ln": ln("model.decoder.layer_norm"),
        },
    }
    return params_from_numpy(tree, cfg, dtype, device)


def load_pretrained(model_path: str, dtype=torch.bfloat16, device=None):
    """Load an HF Whisper checkpoint directory → (config, params)."""
    import transformers

    hf_cfg = transformers.WhisperConfig.from_pretrained(model_path)
    model = transformers.WhisperForConditionalGeneration.from_pretrained(model_path)
    sd = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}
    cfg = config_from_hf(hf_cfg)
    return cfg, params_from_hf_state_dict(sd, cfg, dtype, device)
