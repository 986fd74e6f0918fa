# SPDX-License-Identifier: Apache-2.0
"""On the card (marker ``cuda``; skips without one): each cell at its own
size and window (``run_seconds``: a shorter window closes no final that
the logit check can judge), the program's readings within the cell's
limits, and the float8 control, judged in the program's place, not correct
on the VAD and on the encoder and decoder each.

Run on the card: ``python -m pytest --noconftest -m cuda portbench/tests``
(about 90 s a cell)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE]

import spec  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(spec.workloads()))
def test_the_program_passes_and_the_float8_control_fails_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    seconds = str(spec.settings()["run_seconds"])
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", cell, "--seed", "2718281828",
                           "--seconds", seconds, "--control"], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    limits = spec.workloads()[cell]["limits"]
    assert all(out["readings"][k] <= v for k, v in limits.items()), out["readings"]
    assert out["readings"]["finals_judged"] > 0, out["readings"]
    assert out["correct"] is False, out["checks"]
    for name, check in out["checks"].items():
        assert check["value"] > check["limit"], (name, out["checks"])
