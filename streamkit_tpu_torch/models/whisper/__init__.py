# SPDX-License-Identifier: Apache-2.0
"""Whisper in PyTorch: config, model, weight conversion, greedy decode and
the streaming (live-partials) slot table."""

from .config import WHISPER_CONFIGS, WHISPER_LANGUAGES, WhisperConfig, language_index
from .decode import (
    detect_language_ring,
    detect_language_window,
    greedy_decode,
    pad_or_trim,
    transcribe_ring,
    transcribe_window,
)
from .load import config_from_hf, load_pretrained, params_from_hf_state_dict, params_from_numpy
from .model import decode_logits, decode_step, encode, init_kv_cache, init_params, seeded_params
from .streaming import StreamTable, get_stream_table
from .tokenizer import WhisperDetokenizer
