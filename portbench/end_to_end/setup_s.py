# SPDX-License-Identifier: Apache-2.0
"""Seconds from the process's start to the measured window's: imports, the
weights drawn on the card, the engine or pipeline started, every shape of
the cell warmed up."""

META = {
    "unit": "s",
    "better": "lower",
    "bound": 0.25,
    "source": "host_clock",
}


def read(rec):
    return rec["setup_s"]
