# SPDX-License-Identifier: Apache-2.0
"""The port's native build (streamkit_tpu_torch/ops/_build.py): a library is
named by its source, every local header it includes and the flags, so a
reused build directory never loads a stale library; the compiler's report
is kept beside it. No compiler runs here."""

import os

import pytest
import torch

from streamkit_tpu_torch.ops import _build

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4fwd1Pf' for 'sm_90a'
ptxas info    : Function properties for _Z4fwd1Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4fwd2Pf' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Function properties for _Z4fwd2Pf
    32 bytes stack frame, 40 bytes spill stores, 72 bytes spill loads
ptxas info    : Used 56 registers, 380 bytes cmem[0]
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source tree: a.cu includes x.cuh (which includes y.cuh) and a
    system header; z.cuh is included by nothing."""
    root = tmp_path / "csrc"
    root.mkdir()
    (root / "a.cu").write_text('#include <cuda_bf16.h>\n#include "x.cuh"\nint main() { return 0; }\n')
    (root / "x.cuh").write_text('#pragma once\n  #  include "y.cuh"\n')
    (root / "y.cuh").write_text("#pragma once\n")
    (root / "z.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(root))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return root


def test_headers_are_the_local_includes_transitively(csrc):
    assert _build.Source("a.cu", "nvcc").headers() == [str(csrc / "x.cuh"), str(csrc / "y.cuh")]


def test_library_name_is_stable_while_nothing_changes(csrc):
    src = _build.Source("a.cu", "nvcc")
    name = src.library()
    (csrc / "z.cuh").write_text("#pragma once\nint unrelated;\n")  # included by nothing
    assert src.library() == name == _build.Source("a.cu", "nvcc").library()
    assert os.path.basename(name).startswith("libsk_a_")


@pytest.mark.parametrize("header", ["x.cuh", "y.cuh"])
def test_library_name_follows_every_included_header(csrc, header):
    src = _build.Source("a.cu", "nvcc")
    before = src.library()
    (csrc / header).write_text((csrc / header).read_text() + "// changed\n")
    assert src.library() != before


def test_library_name_follows_the_flags(csrc, monkeypatch):
    plain = _build.Source("a.cu", "nvcc").library()
    assert _build.Source("a.cu", "g++").library() != plain
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    assert _build.Source("a.cu", "nvcc").library() != plain


def test_nvcc_command_asks_for_the_ptxas_report(csrc, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.Source("a.cu", "nvcc").command("out.so")
    assert cmd == ["nvcc", *_build.NVCC_FLAGS, "-o", "out.so", str(csrc / "a.cu")]
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"


def test_report_reads_the_log_beside_the_library(csrc):
    src = _build.Source("a.cu", "nvcc")
    assert _build.report(src) == ""  # not built
    os.makedirs(_build.BUILD_DIR)
    with open(src.library() + ".log", "w") as f:
        f.write(PTXAS)
    assert _build.report(src) == PTXAS


def test_ptxas_summary_per_kernel():
    fwd1, fwd2 = _build.ptxas_summary(PTXAS)
    assert fwd1 == {"kernel": "_Z4fwd1Pf", "registers": 168, "smem": 1024, "stack": 0, "spill_stores": 0,
                    "spill_loads": 0, "warnings": []}
    assert (fwd2["registers"], fwd2["smem"], fwd2["stack"], fwd2["spill_stores"], fwd2["spill_loads"]) == (
        56, 0, 32, 40, 72)
    assert len(fwd2["warnings"]) == 1 and "serialized" in fwd2["warnings"][0]
