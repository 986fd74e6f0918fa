# SPDX-License-Identifier: Apache-2.0
"""A run with the timed path broken underneath comes out not correct.

Each case rehearses the large-v3 live cell on the CPU (``run.py
--dry-run``, which skips the look for a card and drives the rest of a run)
with one fault planted in the program by a wrapper, and reads
``correct: false`` with the number that caught it."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)

FAULTS = {
    # the fused step's encoder leaves the rows' positions where they were
    "state_unchanged": ("schedule_mismatches", """
import streamkit_tpu_torch.models.whisper.streaming as s
orig = s._encode_core
def broken(*a, **k):
    pos = a[9] if len(a) > 9 else k["pos_rows"]
    orig(*a, **k)
    return pos
s._encode_core = broken
"""),
    # every token the continuation decoder appends is replaced by the next id
    "token_altered": ("logit_gap_f32", """
import streamkit_tpu_torch.models.whisper.streaming as s
orig = s._decode_core
def broken(*a, **k):
    tok, fed, n = orig(*a, **k)
    tok = tok.clone()
    tok[:, 4:] = (tok[:, 4:] + 1) % a[0]["dec"]["tok_emb"].shape[0]
    return tok, fed, n
s._decode_core = broken
"""),
    # the segmenter closes every segment one silent frame late
    "segment_late": ("segment_mismatches", """
import streamkit_tpu_torch.nodes.ml.vad_node as v
orig = v.SpeechSegmenter.__init__
def broken(self, *a, **k):
    orig(self, *a, **k)
    self.min_silence_frames += 1
v.SpeechSegmenter.__init__ = broken
"""),
    # the VAD's answer is off by 0.01 where it is produced
    "vad_altered": ("vad_f32", """
import streamkit_tpu_torch.engine.audio_ring as r
orig = r._vad_append
def broken(*a, **k):
    ring, probs = orig(*a, **k)
    return ring, probs + 0.01
r._vad_append = broken
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    number, patch = FAULTS[fault]
    code = (f"import sys; sys.path[:0] = [{HERE!r}, {REPO!r}]\n{patch}\nimport run\n"
            "sys.exit(run.main(['--workload', 'live64.whisper-large-v3', '--seed', '41', '--seconds', '8',"
            " '--dry-run']))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]
