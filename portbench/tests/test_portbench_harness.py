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
from roofline import k1, k2, k3, k4, least_seconds, peaks  # noqa: E402
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


# A model family that is not Whisper, added with its configuration, a
# traffic kind, a mix and a cell as new files only: a two-layer MLP drawn
# from the seed, served in bfloat16 and judged against a float32 forward pass.
TOY_FAMILY = """
import torch


def attributes(cfg):
    return {"dims": {"d": cfg["hidden_size"]}}


def dry_config(cfg):
    return cfg


def sources():
    return []


def draw(cfg, seed, device):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(2 * d * f + f + d, device=device).uniform_(-1.0, 1.0, generator=gen)
    w1, w2, b1, b2 = torch.split(flat, [d * f, f * d, f, d])
    return {"w1": w1.view(d, f) * d ** -0.5, "b1": b1 * 0.02, "w2": w2.view(f, d) * f ** -0.5, "b2": b2 * 0.02}


def build(tree):
    return {k: v.to(torch.bfloat16) for k, v in tree.items()}
"""

TOY_TRAFFIC = """
import time

import torch

FAMILIES = ("toy_mlp",)


def forward(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


async def run(ctx):
    gen = torch.Generator().manual_seed(ctx.seed)
    xs = torch.randn(ctx.mix["calls"], ctx.mix["rows"], ctx.dims["d"], generator=gen)
    ctx.window_start()
    ys = [forward(ctx.params, x.to(torch.bfloat16)).float() for x in xs]
    ctx.t_end = ctx.t_host = time.monotonic()
    return {"xs": xs, "ys": ys}


def trace_readings(ctx, rec, trace):
    return {}


def judge(ctx, rec, precisions=("f32",)):
    ctx.drop_program()
    ref = {k: v.float() for k, v in ctx.tree.items()}
    return {"err_f32": max(float((forward(ref, x) - y).abs().max()) for x, y in zip(rec["xs"], rec["ys"]))}


def counts(rec):
    return len(rec["ys"]), 0


def counts_detail(rec):
    return {"calls": len(rec["ys"])}
"""


@pytest.fixture
def toy_root(tmp_path):
    """A copy of the benchmark with the toy family's files added."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__", "*.npz"))
    (root / "families" / "toy_mlp.py").write_text(TOY_FAMILY)
    (root / "traffic" / "toy.py").write_text(TOY_TRAFFIC)
    (root / "configs" / "toy-mlp.json").write_text(json.dumps({
        "source": "https://example.org/toy-mlp", "reduced": [], "why": "a two-layer MLP", "model_type": "toy-mlp",
        "hidden_size": 32, "intermediate_size": 64}))
    (root / "mixes" / "toy.json").write_text(json.dumps({"kind": "toy", "calls": 4, "rows": 8}))
    (root / "workloads" / "toy.toy-mlp.json").write_text(json.dumps({
        "config": "toy-mlp", "mix": "toy", "chips": 1, "why": "a family added as files",
        "end_to_end": ["device_ms_per_audio_s", "setup_s"], "per_layer": ["device_idle.live"],
        "limits": {"err_f32": 0.05}}))
    return root


def test_a_family_added_as_files_rehearses_to_correct(toy_root):
    assert spec.problems(str(toy_root)) == []
    assert "toy.toy-mlp" in [w["name"] for w in spec.benchmark(str(toy_root))["workloads"]]
    proc = subprocess.run([sys.executable, str(toy_root / "run.py"), "--workload", "toy.toy-mlp", "--seed",
                           "3000000017", "--seconds", "1", "--dry-run"],
                          capture_output=True, text=True, timeout=300, cwd=str(toy_root.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["attempted"] == 4 and out["failed"] == 0, out
    assert 0 < out["checks"]["err_f32"]["value"] <= 0.05, out["checks"]


@pytest.mark.parametrize("mistake", ["family_missing", "family_unused", "family_not_served"])
def test_a_family_mismatch_is_refused(toy_root, mistake):
    if mistake == "family_missing":
        (toy_root / "families" / "toy_mlp.py").unlink()
        want = "config toy-mlp: no family module families/toy_mlp.py"
    elif mistake == "family_unused":
        (toy_root / "families" / "orphan.py").write_text(TOY_FAMILY)
        want = "family orphan is used by no config"
    else:
        (toy_root / "traffic" / "toy.py").write_text(TOY_TRAFFIC.replace('("toy_mlp",)', '("whisper",)'))
        want = "toy.toy-mlp: traffic kind toy does not serve the family 'toy_mlp'"
    assert any(p.startswith(want) for p in spec.problems(str(toy_root))), spec.problems(str(toy_root))


def _leaves(x, path=""):
    """``(path, tensor)`` of a nested dict/list, or of a module's parameters."""
    if hasattr(x, "named_parameters"):
        yield from x.named_parameters()
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, x


def test_the_whisper_family_draws_and_builds_what_the_old_path_did():
    import torch
    import weights

    from streamkit_tpu_torch.models.whisper.model import build_params

    cfg = spec.configs()["whisper-large-v3"]
    fam = spec.family(cfg)
    small = fam.dry_config(cfg)
    # the CPU rehearsal's size as run.py set it before the families
    assert small == dict(cfg, d_model=256, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
                         decoder_attention_heads=4, encoder_ffn_dim=1024, decoder_ffn_dim=1024)
    got = fam.attributes(small)
    assert got["dims"] == weights.dims(small) and got["port_cfg"] == weights.port_config(small)
    assert got["port_size"] == "large-v3"
    cpu = torch.device("cpu")
    tree, old_tree = fam.draw(small, 3000000017, cpu), weights.draw(small, 3000000017, cpu)
    params, old_params = fam.build(tree), build_params(old_tree)
    assert [(n, type(m)) for n, m in params.named_modules()] == [(n, type(m)) for n, m in old_params.named_modules()]
    for new, old in ((tree, old_tree), (params, old_params)):
        a, b = list(_leaves(new)), list(_leaves(old))
        assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 50
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), path


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


def test_k4_roofline_counts_at_a_known_shape():
    # large-v3's 20 heads of 64 over 512 columns: a row not yet encoded reads
    # one column, a horizon past T reads T
    horizons = [0, 100, 512, 600]
    cols = 1 + 100 + 512 + 512
    assert k4.columns(horizons, 512) == cols
    assert k4.flops(20, 64, horizons, 512) == 4 * 20 * 64 * cols
    assert k4.nbytes(20, 64, horizons, 512) == 4 * 20 * 64 * 2 + 4 * 20 * 64 * 4 + 16 + 20 * cols * (2 * 64 + 8)
    # bound by bytes at 3.35 TB/s, not by the f32 CUDA cores' 67 TFLOP/s
    h100 = peaks("NVIDIA H100 80GB HBM3")
    assert least_seconds(k4.flops(20, 64, horizons, 512), k4.nbytes(20, 64, horizons, 512), h100,
                         "f32_flops") == pytest.approx(k4.nbytes(20, 64, horizons, 512) / 3.35e12)


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


def test_run_py_names_no_model():
    # the model comes through its family module (families/<model_type>.py)
    names = set(_imports(os.path.join(HERE, "run.py")))
    assert not {n for n in names if n.startswith("streamkit_tpu_torch.models")}, names
    assert not names & {"weights", "reference.whisper", "reference"}, names


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
