# SPDX-License-Identifier: Apache-2.0
"""Evaluate both VAD backends on real speech.

Port of ``tools/eval_vad.py``. Decodes the held-out OpenSpeech excerpt
(``SK_VAD_EVAL_SPEECH``, default the reference checkout's
``samples/audio/system/speech_2m.opus``; training uses ``speech_10m``)
and prints, per backend, the mean probability over the loudest and the
quietest energy deciles of frames, the share of frames over 0.5 and the
``SpeechSegmenter`` segments; then the learned backend's recall on the
frames the spectral teacher calls speech (over 0.8), by energy quintile,
and its recall and false accepts (teacher under 0.2) with the whole signal
at -12 / -20 / -26 dB.

:func:`evaluate` computes these numbers from any 16 kHz array on a given
device (``cuda`` unless the caller passes ``device="cpu"``) with the
learned weights it is given. It calls the two backends' functions
directly, so it never changes ``ops/vad.py``'s process-wide backend.

    python -m streamkit_tpu_torch.tools.eval_vad [--device cpu]

``SK_VAD_WEIGHTS`` names other learned weights than the bundled file.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import silero_vad as sv
from ..nodes.ml.vad_node import SpeechSegmenter
from ..ops.vad import VAD_FRAME, _bundled_weights_path, _spectral_frame_probs, _spectral_init_state

__all__ = ["evaluate", "report", "load_16k", "main", "SAMPLE"]

SAMPLE = os.environ.get("SK_VAD_EVAL_SPEECH", "/root/reference/samples/audio/system/speech_2m.opus")
ATTENUATIONS_DB = (-12.0, -20.0, -26.0)
SCORE_BLOCK = 50  # frames per backend call, as a serving block would feed them
TEACHER_BLOCK = 256


def load_16k(path: str, secs: float = 110.0) -> np.ndarray:
    from ..utils.realspeech import load_opus_16k

    audio = load_opus_16k(path, secs=secs)
    if audio is None:
        raise FileNotFoundError(f"fixture or libopus unavailable: {path}")
    return audio


def _scores(frames: np.ndarray, block: int, score, state) -> np.ndarray:
    """Frames through ``score(state, x) → (probs, state)`` in blocks."""
    out = []
    with torch.no_grad():
        for i in range(0, len(frames), block):
            p, state = score(state, frames[i : i + block])
            out.append(p.cpu().numpy())
    return np.concatenate(out)


def _segments(frames: np.ndarray, probs: np.ndarray) -> list:
    seg = SpeechSegmenter(threshold=0.5, min_silence_ms=700.0, max_segment_secs=30.0)
    segments = []
    for frame, prob in zip(frames, probs):
        for kind, _s, s_f, e_f in seg.push(frame, float(prob)):
            if kind == "speech_end":
                segments.append((s_f, e_f))
    for kind, _s, s_f, e_f in seg.flush():
        if kind == "speech_end":
            segments.append((s_f, e_f))
    return segments


def evaluate(audio: np.ndarray, device=None, weights: Optional[str] = None) -> dict:
    """Score 16 kHz mono ``audio`` with the learned backend (``weights``,
    default ``SK_VAD_WEIGHTS`` or the bundled file) and the spectral one on
    ``device`` → the evaluator's numbers and each backend's frame probs."""
    dev = resolve_device(device)
    path = weights or os.environ.get("SK_VAD_WEIGHTS") or _bundled_weights_path()
    params = {k: torch.from_numpy(v).to(dev) for k, v in sv.load_params(path).items()}
    n = len(audio) // VAD_FRAME
    frames = np.ascontiguousarray(audio[: n * VAD_FRAME].reshape(n, VAD_FRAME), np.float32)
    rms = np.sqrt((frames**2).mean(axis=1))
    order = np.argsort(rms)
    k = max(1, n // 10)

    def learned(gain: float = 1.0) -> np.ndarray:
        return _scores(frames, SCORE_BLOCK,
                       lambda st, x: sv.apply(params, st, torch.from_numpy(x * gain).to(dev)),
                       sv.init_state((), dev))

    def spectral(block: int) -> np.ndarray:
        return _scores(frames, block, lambda st, x: _spectral_frame_probs(st, torch.from_numpy(x).to(dev)),
                       _spectral_init_state((), dev))

    result = {"frames": n, "seconds": n * VAD_FRAME / 16000, "weights": path, "backends": {}}
    for name, probs in (("learned", learned()), ("spectral", spectral(SCORE_BLOCK))):
        result["backends"][name] = {
            "probs": probs,
            "loud_decile": float(probs[order[-k:]].mean()),
            "quiet_decile": float(probs[order[:k]].mean()),
            "over_half": float((probs > 0.5).mean()),
            "segments": _segments(frames, probs),
        }
    # quiet-speech recall: the teacher's confident speech frames (> 0.8) at
    # the original level, the learned backend's recall per energy quintile
    # and with the whole signal attenuated
    tp = spectral(TEACHER_BLOCK)
    speech = tp > 0.8
    probs = result["backends"]["learned"]["probs"]
    sidx = np.where(speech)[0]
    qorder = sidx[np.argsort(rms[sidx])]
    kq = len(qorder) // 5
    result["recall_by_quintile"] = [float((probs[qorder[q * kq : (q + 1) * kq]] > 0.5).mean()) for q in range(5)]
    result["attenuated"] = {}
    for att_db in ATTENUATIONS_DB:
        pa = learned(10 ** (att_db / 20))
        result["attenuated"][att_db] = {"recall": float((pa[speech] > 0.5).mean()),
                                        "false_accept": float((pa[tp < 0.2] > 0.5).mean())}
    return result


def report(result: dict, label: str) -> None:
    """Print ``result`` as the reference evaluator's lines."""
    print(f"# {label}: {result['seconds']:.1f}s, {result['frames']} frames")
    for backend, r in result["backends"].items():
        durs = [(e - s) * VAD_FRAME / 16000 for s, e in r["segments"]]
        print(
            f"{backend:9s} loud-decile {r['loud_decile']:.3f}  "
            f"quiet-decile {r['quiet_decile']:.3f}  "
            f">0.5 {r['over_half']:.2%}  "
            f"segments {len(r['segments'])} "
            f"(mean {np.mean(durs):.1f}s, cover {sum(durs):.0f}s)"
            if durs
            else f"{backend:9s} loud {r['loud_decile']:.3f} quiet "
            f"{r['quiet_decile']:.3f} — NO SEGMENTS",
        )
    print(
        "learned speech-frame recall by energy quintile (quiet→loud): "
        + "  ".join(f"{r:.3f}" for r in result["recall_by_quintile"])
    )
    for att_db, r in result["attenuated"].items():
        print(f"learned @ {att_db:+.0f} dB: speech recall {r['recall']:.3f}  "
              f"nonspeech false-accept {r['false_accept']:.3f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m streamkit_tpu_torch.tools.eval_vad")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv if argv is not None else [])
    result = evaluate(load_16k(SAMPLE), device=args.device)
    report(result, SAMPLE)
    return result


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
