# SPDX-License-Identifier: Apache-2.0
"""Write ``BENCHMARK.json`` from the benchmark's files (``spec.benchmark``).

    python3 portbench/make_benchmark.py           # write it
    python3 portbench/make_benchmark.py --check   # exit 1 if it differs
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import spec  # noqa: E402

OUT = os.path.join(spec.REPO, "BENCHMARK.json")


def render() -> str:
    return json.dumps(spec.benchmark(), indent=2) + "\n"


def main(argv) -> int:
    bad = spec.problems()
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    text = render()
    if "--check" in argv:
        with open(OUT, encoding="utf-8") as f:
            same = f.read() == text
        if not same:
            print("BENCHMARK.json differs from the benchmark's files", file=sys.stderr)
        return 0 if same else 1
    with open(OUT, "w", encoding="utf-8") as f:
        f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
