# SPDX-License-Identifier: Apache-2.0
"""The benchmark's harness on the CPU: its files against ``BENCHMARK.json``
and the benchmark's rules, the arithmetic of its numbers, its import
boundary, and a rehearsal of each cell at a small size.

Run: ``python -m pytest portbench/tests -q`` (the card's tests: ``-m cuda``
on a machine with a card)."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]

import spec  # noqa: E402
import stats  # noqa: E402
from roofline import k1, k2, k3, least_seconds, peaks  # noqa: E402
from roofline import whisper as wr  # noqa: E402

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")
UNIT_CHARS = NAME_CHARS | set("/%")


def test_files_load_and_benchmark_json_matches_them():
    assert spec.problems() == []
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as f:
        assert json.load(f) == spec.benchmark()


def test_benchmark_json_keeps_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith("portbench/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert spec.NAME.match(name) and set(name) <= NAME_CHARS, name
    for cfg in b["configs"]:
        assert cfg["file"].startswith("portbench/") and cfg["source"].startswith("https://")
        assert cfg["reduced"] == [] or all(set(k) <= NAME_CHARS for k in cfg["reduced"])
    cells = {w["name"]: w for w in b["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for w in cells.values():
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher") and 1 <= len(m["unit"]) <= 16 and set(m["unit"]) <= UNIT_CHARS
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["workloads"] and 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert m["moves"] in spec.workloads()[cell]["end_to_end"]
    assert len(json.dumps(b)) < 64 * 1024
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__", "*.npz"))
    cell = spec.load_json(os.path.join(HERE, "workloads", "live64.whisper-medium.json"))
    cell = dict(cell, why="a cell added as a file", per_layer=cell["per_layer"] + ["calls.added"])
    (root / "workloads" / "added.whisper-medium.json").write_text(json.dumps(dict(cell, mix="added")))
    mix = spec.load_json(os.path.join(HERE, "mixes", "live64.json"))
    (root / "mixes" / "added.json").write_text(json.dumps(dict(mix, sessions=8)))
    (root / "layer_metrics" / "calls.added.py").write_text(
        'META = {"unit": "calls", "better": "lower", "source": "program_counter", "layer": "engine/batcher.py",'
        ' "moves": "device_ms_per_audio_s"}\n\n\ndef read(rec):\n    return rec["live"]["calls"]\n')
    assert spec.problems(str(root)) == []
    b = spec.benchmark(str(root))
    added = next(w for w in b["workloads"] if w["name"] == "added.whisper-medium")
    assert added["traffic"] == "added" and added["config"] == "whisper-medium"
    metric = next(m for m in b["per_layer"] if m["name"] == "calls.added")
    assert metric["workloads"] == ["added.whisper-medium"]
    assert spec.layer_metrics(str(root))["calls.added"].read({"live": {"calls": 7}}) == 7
    assert "added.whisper-medium" in next(m for m in b["per_layer"] if m["name"] == "fused_call_ms.live")["workloads"]


def test_rate_and_percentile_arithmetic():
    # a span's work spreads over its time: half of [0, 2] lies in [1, 3]
    assert stats.windowed_work([(0.0, 2.0, 10.0), (1.5, 2.5, 4.0), (4.0, 5.0, 1.0)], 1.0, 3.0) == 9.0
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
    assert stats.union_length([(0, 1), (0.5, 2), (3, 4)]) == 3.0
    assert stats.gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]


def test_roofline_counts_at_known_shapes():
    # K1 at the ring decode's [4, 20, 1500, 64] bf16: the numbers PERF.md's kernel table uses
    assert k1.flops(4, 20, 1500, 64) == 4 * 4 * 20 * 1500 * 1500 * 64 == 46_080_000_000
    assert k1.nbytes(4, 20, 1500, 64) == 4 * 4 * 20 * 1500 * 64 * 2
    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert least_seconds(k1.flops(4, 20, 1500, 64), k1.nbytes(4, 20, 1500, 64), h100) == pytest.approx(
        46.08e9 / 989e12)
    # K3 at [8, 20, 16, 64, 512] with histories 0..512 (chip_smoke's k3 case)
    pos = [round(i * 512 / 7) for i in range(8)]
    hist = sum(pos)
    assert k3.flops(20, 16, 64, pos) == 4 * 20 * 16 * 64 * (hist + 8 * 16)
    assert k3.nbytes(20, 16, 64, pos) == (8 * 20 * 16 * 64 * 2 + 8 * 20 * 16 * 64 * 4 + 32
                                          + 20 * hist * 136 + 8 * 20 * 16 * 136)
    # K2: two rows writing 16 and 0 columns of one int8 cache of 32 layers x 1280
    assert k2.nbytes([(32, 1280, 1, 16)], [16, 0]) == 16 + 2 * 32 * 1280 * 16
    # a fused call's useful work: one row committing one chunk at position 0 and feeding one column
    m = {"d": 4, "enc_ffn": 16, "dec_ffn": 16, "enc_layers": 1, "dec_layers": 1, "n_mels": 2, "n_vocab": 10}
    got = wr.stream_call(m, [(0, 8, [(0, 8)])])
    enc = sum(wr.encoder_position(4, 16, 8) for _ in range(8))
    assert got == (enc + wr.conv_frontend(2, 4, 19, 8) + wr.cross_kv(4, 8, 1) + wr.decoder_token(4, 16, 1, 8)
                   + wr.logits(4, 10))


def test_the_continuation_decoder_is_followed_step_by_step():
    sys.path.insert(0, os.path.join(HERE, "traffic"))
    live = spec.traffic_driver("live")
    # fresh segment: the prefix (4 tokens) fed over the first call's 3 steps, no token yet
    assert live._decode_steps(0, 4, 4, 16, 3, 64) == ([(0, 16), (1, 16), (2, 16)], 3, True, 3)
    # next call: feeds the prefix's last token, then two new tokens (appended 3)
    assert live._decode_steps(3, 4, 7, 24, 3, 64) == ([(3, 24), (4, 24), (5, 24)], 6, True, 3)
    # eot proposed at once: the last token was fed again and nothing appended
    assert live._decode_steps(7, 7, 7, 32, 3, 64) == ([(6, 32)], 7, True, 1)
    # more tokens than the steps allow is inconsistent
    assert live._decode_steps(3, 4, 9, 24, 3, 64)[2] is False


def _imports(path: str):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_and_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "streamkit_tpu"}, path
        if os.sep + "reference" + os.sep in path:
            assert "streamkit_tpu_torch" not in tops, path


def _dry_run(cell: str, *extra: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload", cell, "--seed",
                           "3000000017", "--seconds", "8", "--dry-run", *extra],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(spec.workloads()))
def test_each_cell_rehearses_on_the_cpu(cell):
    out = _dry_run(cell)
    assert out["dry_run"] and "metrics" not in out
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0 and out["readings"]["finals_judged"] > 0


def test_the_float8_control_fails_the_check():
    out = _dry_run("live64.whisper-large-v3", "--control")
    limits = spec.workloads()["live64.whisper-large-v3"]["limits"]
    # the program's own readings, taken in the same run, pass
    assert all(out["readings"][k] <= v for k, v in limits.items()), out["readings"]
    # the control, judged in the program's place, does not
    assert out["correct"] is False
    assert set(out["checks"]) == {"vad_f32", "logit_gap_f32"}
    assert out["checks"]["vad_f32"]["value"] > out["checks"]["vad_f32"]["limit"], out["checks"]
    # at this size the encoder and decoder read the control's gap above the
    # program's but below the cell's limit; the card's test holds the control's
    # gap against the limit at the cell's own size
    assert out["readings"]["logit_gap_fp8"] > out["readings"]["logit_gap_f32"], out["readings"]
