# SPDX-License-Identifier: Apache-2.0
"""Device ops ported so far: PCM conversion, gain, mix and channel
conversion, the streaming resampler, log-mel, flash attention (forward and backward), VAD, the
streaming caches' windowed write and int8-history attention."""

from .attention import (
    FlashAttention,
    attention_backward_reference,
    attention_reference,
    flash_attention,
    flash_attention_backward,
)
from .cache_write import windowed_write, windowed_write_groups, windowed_write_many
from .stream_attention import history_attention
from .dsp import apply_gain, convert_channels, f32_to_s16le, mix_frames, s16le_to_f32
from .mel import log_mel_spectrogram, mel_filterbank
from .resample import LinearResampler, RubatoResampler, max_output_frames, resample_chunk
from .vad import VAD_CONTEXT, VAD_FRAME, VadState, vad_frame_probs, vad_init_state
