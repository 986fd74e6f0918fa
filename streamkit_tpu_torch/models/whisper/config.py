# SPDX-License-Identifier: Apache-2.0
"""Whisper model configurations.

A framework-free copy of ``streamkit_tpu/models/whisper/config.py`` (the
port imports nothing of the JAX package). Dimensions follow the published
OpenAI Whisper family.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["WhisperConfig", "WHISPER_CONFIGS"]


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500  # 30 s of mel frames after conv stride 2
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    # special tokens (multilingual vocab layout)
    @property
    def token_eot(self) -> int:
        return self.n_vocab - 51865 + 50256 if self.n_vocab >= 51865 else 50256

    @property
    def n_languages(self) -> int:
        """Size of the language-token block (large-v3's 51866 vocab adds
        yue as the 100th entry; see WHISPER_LANGUAGES)."""
        return 100 if self.n_vocab == 51866 else 99

    @property
    def token_sot(self) -> int:
        return self.token_eot + 1  # <|startoftranscript|>

    @property
    def token_translate(self) -> int:
        return self.token_sot + 100 + 1 + 58 if self.n_vocab == 51866 else self.token_sot + 100 + 58

    @property
    def token_transcribe(self) -> int:
        return self.token_translate + 1

    @property
    def token_no_timestamps(self) -> int:
        return self.token_transcribe + 3

    def token_language(self, lang_index: int = 0) -> int:
        """<|en|> is sot+1, then one token per language."""
        return self.token_sot + 1 + lang_index

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


# Whisper's language-token order (the multilingual tokenizer's language
# block, <|en|> first — openai/whisper tokenizer layout; the reference
# accepts any of these codes via whisper.cpp's set_language,
# plugins/native/whisper/src/lib.rs:249-253,625). "yue" (Cantonese) is the
# 100th entry, present only in large-v3's 51866-token vocab; token_language
# indexes past the 99-language block correctly for that vocab.
WHISPER_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue"
).split()
_LANG_INDEX = {code: i for i, code in enumerate(WHISPER_LANGUAGES)}


def language_index(code: str) -> int:
    """Language code → index into the language-token block. Unknown codes
    fall back to English (the reference forwards unknown codes to
    whisper.cpp, which does the same)."""
    return _LANG_INDEX.get((code or "en").lower(), 0)


WHISPER_CONFIGS = {
    "tiny": WhisperConfig(),
    "base": WhisperConfig(
        n_audio_state=512, n_audio_head=8, n_audio_layer=6,
        n_text_state=512, n_text_head=8, n_text_layer=6,
    ),
    "small": WhisperConfig(
        n_audio_state=768, n_audio_head=12, n_audio_layer=12,
        n_text_state=768, n_text_head=12, n_text_layer=12,
    ),
    "medium": WhisperConfig(
        n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
        n_text_state=1024, n_text_head=16, n_text_layer=24,
    ),
    "large-v2": WhisperConfig(
        n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
        n_text_state=1280, n_text_head=20, n_text_layer=32,
    ),
    "large-v3": WhisperConfig(
        n_mels=128, n_vocab=51866,
        n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
        n_text_state=1280, n_text_head=20, n_text_layer=32,
    ),
}
