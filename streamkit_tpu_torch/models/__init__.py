# SPDX-License-Identifier: Apache-2.0
"""Device model families ported so far: Whisper STT, the learned VAD, NLLB and
Marian translation, VITS and the FastSpeech + HiFi-GAN TTS stack."""

import numpy as np
import torch

__all__ = ["params_to_torch"]


def params_to_torch(tree, dtype: torch.dtype, device, keep_f32=()):
    """A nested dict/list of numpy arrays → the same tree of tensors on
    ``device`` in ``dtype`` (leaves named in ``keep_f32`` stay float32; other
    leaves, such as strings, are kept as they are). Values are copied, then
    moved, then cast, so every device gets the same bits."""

    def conv(x, name=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            t = torch.from_numpy(np.array(x, np.float32)).to(device)
            return t if name in keep_f32 else t.to(dtype)
        return x

    return conv(tree)
