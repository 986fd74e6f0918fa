# SPDX-License-Identifier: Apache-2.0
"""Device model families of the port: Whisper STT, the learned VAD, NLLB and
Marian translation, VITS, the FastSpeech + HiFi-GAN TTS stack, Kokoro,
Matcha and SenseVoice."""

import numpy as np
import torch

__all__ = ["params_to_torch", "override_leaves"]


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


def override_leaves(tree, flat, what: str, prefix: str = ""):
    """Leaves of ``tree`` (numpy, the reference's layout) replaced by the
    arrays of ``flat`` under their '/'-joined paths where present, each
    checked against the leaf's shape; ``what`` names the file in errors."""
    if isinstance(tree, dict):
        return {k: override_leaves(v, flat, what, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [override_leaves(v, flat, what, f"{prefix}/{i}") for i, v in enumerate(tree)]
    if prefix in flat:
        arr = np.asarray(flat[prefix], np.float32)
        if arr.shape != tuple(tree.shape):
            raise ValueError(f"{what}[{prefix}] shape {arr.shape} != {tuple(tree.shape)}")
        return arr
    return tree
