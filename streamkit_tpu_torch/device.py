# SPDX-License-Identifier: Apache-2.0
"""Device resolution and the float32 precision policy.

Entry points that create device state take ``device=``. It defaults to
``cuda``: without a card they raise instead of quietly running on the CPU.
The CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do). Functions that take tensors compute where those tensors live.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "strict_fp32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises.

    The result names one physical device one way: ``cuda`` becomes
    ``cuda:{current device}`` and ``cpu:0`` becomes ``cpu``, so state kept per
    device (audio rings, stream tables, model caches, resampler tables) is
    one object per device whichever alias the caller used."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        strict_fp32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unsupported device {dev}")
    return dev


def strict_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    The reference computes its mel and parity paths at ``Precision.HIGHEST``;
    cuDNN would otherwise run float32 convolutions in TF32 (about three
    decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

