# SPDX-License-Identifier: Apache-2.0
"""Minimal byte-level BPE detokenizer for Whisper output.

Loads ``vocab.json`` (token → id) from a local checkpoint directory when
available (same files HF tokenizers use); decoding token ids to text only
needs the id → bytes table, not the merge rules. Falls back to a numeric
``<id>`` rendering when no vocab is present (offline test environments).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

__all__ = ["WhisperDetokenizer"]


@lru_cache()
def _byte_decoder() -> Dict[str, int]:
    """Inverse of GPT-2's bytes→unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class WhisperDetokenizer:
    def __init__(self, vocab_path: Optional[str] = None, n_special_start: int = 50257) -> None:
        self.id_to_bytes: Dict[int, bytes] = {}
        self.n_special_start = n_special_start
        if vocab_path and os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                vocab = json.load(f)
            bd = _byte_decoder()
            for token, idx in vocab.items():
                try:
                    self.id_to_bytes[idx] = bytes(bd[ch] for ch in token)
                except KeyError:
                    self.id_to_bytes[idx] = token.encode()

    @staticmethod
    def from_model_dir(model_dir: str) -> "WhisperDetokenizer":
        return WhisperDetokenizer(os.path.join(model_dir, "vocab.json"))

    def decode(self, ids: Sequence[int]) -> str:
        if not self.id_to_bytes:
            return "".join(f"<{i}>" for i in ids)
        out = b"".join(self.id_to_bytes.get(int(i), b"") for i in ids if int(i) < self.n_special_start)
        return out.decode("utf-8", errors="replace")

    # -- suppression sets (openai/whisper tokenizer.py:non_speech_tokens) ----

    def token_id(self, text: str) -> Optional[int]:
        """Exact single-token lookup (inverse of the byte table)."""
        if not self.id_to_bytes:
            return None
        if not hasattr(self, "_bytes_to_id"):
            self._bytes_to_id = {v: k for k, v in self.id_to_bytes.items()}
        return self._bytes_to_id.get(text.encode("utf-8"))

    def _first_token_of(self, text: str) -> Optional[int]:
        """First BPE sub-token of ``text``: the longest vocab entry that is
        a prefix of its utf-8 bytes (greedy byte-BPE approximation — the
        merges file isn't needed for the leading token of short symbol
        strings)."""
        if not self.id_to_bytes:
            return None
        if not hasattr(self, "_bytes_to_id"):
            self._bytes_to_id = {v: k for k, v in self.id_to_bytes.items()}
        data = text.encode("utf-8")
        for n in range(len(data), 0, -1):
            tid = self._bytes_to_id.get(data[:n])
            if tid is not None:
                return tid
        return None

    def non_speech_tokens(self) -> List[int]:
        """Token ids whisper suppresses as "non-speech" (bracket/symbol/music
        markers — the whisper.cpp ``suppress_nst`` set, following
        openai/whisper ``tokenizer.non_speech_tokens``: single-token symbol
        forms, plus the FIRST sub-token of " -", " '" and the music
        miscellany even when they encode to multiple tokens). Empty when no
        vocab is loaded (numeric fallback mode)."""
        if not self.id_to_bytes:
            return []
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for text in (" -", " '"):
            tid = self._first_token_of(text)
            if tid is not None:
                result.add(tid)
        for symbol in symbols + list(miscellaneous):
            for form in (symbol, " " + symbol):
                if symbol in miscellaneous:
                    tid = self._first_token_of(form)
                else:
                    tid = self.token_id(form)
                if tid is not None:
                    result.add(tid)
        return sorted(result)

    def blank_token(self) -> Optional[int]:
        return self.token_id(" ")
