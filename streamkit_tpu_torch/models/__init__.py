# SPDX-License-Identifier: Apache-2.0
"""Device model families ported so far: Whisper STT and the learned VAD."""
