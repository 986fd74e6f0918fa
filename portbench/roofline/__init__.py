# SPDX-License-Identifier: Apache-2.0
"""Operations and bytes of each kernel and of each whole model step, from
the shapes of the call as the plain function needs them, and the table of
the card's peaks (``peaks.json``). The counts do not depend on what
implements the kernel."""

from __future__ import annotations

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``); KeyError for a card not in the table."""
    with open(_PEAKS, encoding="utf-8") as f:
        return json.load(f)[kind]


def least_seconds(flops: float, nbytes: float, peak: dict, flops_key: str = "bf16_flops") -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate and the bytes over the memory bandwidth."""
    return max(flops / peak[flops_key], nbytes / peak["hbm_bytes_per_s"])
