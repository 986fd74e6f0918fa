# SPDX-License-Identifier: Apache-2.0
"""The benchmark's definition, read from its files.

Each configuration, traffic mix, cell and metric is a file of its own,
found by name, so a later change adds one by adding files:

* ``configs/<config>.json``: a model configuration as it is run; its
  ``model_type`` names its family;
* ``families/<model_type>.py`` (``-`` read as ``_``): a model family: its
  sizes and the program's config object, the CPU rehearsal's size, the native
  sources to build in set-up, its weights and the program's parameters;
* ``mixes/<mix>.json``: a traffic mix, ``{"kind": <driver>, ...}``, read by
  ``traffic/<kind>.py``, which names the families it serves (``FAMILIES``);
* ``workloads/<cell>.json``: a cell: its config, mix, chips, ``why``, the
  metrics it reports and the limits of its correctness check;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: a metric's
  ``META`` and its ``read(record)``;
* ``settings.json``: the command, the paths and ``run_seconds``.

:func:`benchmark` assembles ``BENCHMARK.json`` from them
(``python3 portbench/make_benchmark.py`` writes it).
"""

from __future__ import annotations

import ast
import glob
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _by_name(folder: str, ext: str, root: str = HERE) -> Dict[str, str]:
    out = {}
    for path in sorted(glob.glob(os.path.join(root, folder, "*" + ext))):
        name = os.path.basename(path)[: -len(ext)]
        if not name.startswith("_"):
            out[name] = path
    return out


def settings(root: str = HERE) -> dict:
    return load_json(os.path.join(root, "settings.json"))


def configs(root: str = HERE) -> Dict[str, dict]:
    return {n: load_json(p) for n, p in _by_name("configs", ".json", root).items()}


def mixes(root: str = HERE) -> Dict[str, dict]:
    return {n: load_json(p) for n, p in _by_name("mixes", ".json", root).items()}


def workloads(root: str = HERE) -> Dict[str, dict]:
    return {n: load_json(p) for n, p in _by_name("workloads", ".json", root).items()}


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modules(folder: str, root: str) -> Dict[str, ModuleType]:
    return {n: load_module(p, f"portbench_{folder}_{n.replace('.', '_').replace('-', '_')}")
            for n, p in _by_name(folder, ".py", root).items()}


def end_to_end(root: str = HERE) -> Dict[str, ModuleType]:
    return _modules("end_to_end", root)


def layer_metrics(root: str = HERE) -> Dict[str, ModuleType]:
    return _modules("layer_metrics", root)


def family_name(cfg: dict) -> str:
    """The family of a configuration: its ``model_type``, ``-`` read as ``_``."""
    return str(cfg.get("model_type", "")).replace("-", "_")


def family(cfg: dict, root: str = HERE) -> ModuleType:
    """The family module of a configuration (``families/<model_type>.py``)."""
    name = family_name(cfg)
    path = os.path.join(root, "families", f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no family {name!r} (portbench/families/{name}.py)")
    return load_module(path, f"portbench_family_{name}")


def served_families(kind: str, root: str = HERE) -> tuple:
    """The families a traffic driver serves: its top-level ``FAMILIES``,
    read from the source without importing the driver (empty: none)."""
    with open(os.path.join(root, "traffic", f"{kind}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "FAMILIES"
                                                for t in node.targets):
            return tuple(str(x).replace("-", "_") for x in ast.literal_eval(node.value))
    return ()


def traffic_driver(kind: str, root: str = HERE) -> ModuleType:
    path = os.path.join(root, "traffic", f"{kind}.py")
    if not os.path.exists(path):
        raise KeyError(f"no traffic driver {kind!r} (portbench/traffic/{kind}.py)")
    return load_module(path, f"portbench_traffic_{kind}")


def benchmark(root: str = HERE) -> dict:
    """``BENCHMARK.json``'s content, assembled from the files under ``root``."""
    st = settings(root)
    cfgs, cells = configs(root), workloads(root)
    e2e, layers = end_to_end(root), layer_metrics(root)
    rel = lambda p: os.path.relpath(p, os.path.dirname(root))  # noqa: E731
    out = {"command": st["command"], "paths": st["paths"], "run_seconds": st["run_seconds"], "configs": [],
           "workloads": [], "end_to_end": [], "per_layer": []}
    cfg_files = _by_name("configs", ".json", root)
    for name, c in cfgs.items():
        out["configs"].append({"name": name, "source": c["source"], "file": rel(cfg_files[name]),
                               "reduced": c["reduced"], "why": c["why"]})
    for name, w in cells.items():
        out["workloads"].append({"name": name, "config": w["config"], "traffic": w["mix"], "chips": w["chips"],
                                 "why": w["why"]})

    def users(key: str, metric: str):
        return [n for n, w in cells.items() if metric in w[key]]

    for name, mod in e2e.items():
        entry = {"name": name, **{k: mod.META[k] for k in ("unit", "better", "bound", "source")}}
        cells_of = users("end_to_end", name)
        if len(cells_of) != len(cells):
            entry["workloads"] = cells_of
        out["end_to_end"].append(entry)
    for name, mod in layers.items():
        out["per_layer"].append({"name": name, **{k: mod.META[k] for k in ("unit", "better", "source", "layer",
                                                                             "moves")},
                                 "workloads": users("per_layer", name)})
    return out


def problems(root: str = HERE) -> list:
    """What in the files breaks the benchmark's own rules (empty: none)."""
    bad = []
    cfgs, mx, cells = configs(root), mixes(root), workloads(root)
    e2e, layers = end_to_end(root), layer_metrics(root)
    for name in list(cfgs) + list(mx) + list(cells) + list(e2e) + list(layers):
        if not NAME.match(name):
            bad.append(f"bad name {name!r}")
    fams = _by_name("families", ".py", root)
    for name, c in cfgs.items():
        if family_name(c) not in fams:
            bad.append(f"config {name}: no family module families/{family_name(c)}.py for its model_type "
                       f"{c.get('model_type')!r}")
    for name, w in cells.items():
        if w["config"] not in cfgs:
            bad.append(f"{name}: no config {w['config']!r}")
        kind = mx[w["mix"]]["kind"] if w["mix"] in mx else None
        if kind is None:
            bad.append(f"{name}: no mix {w['mix']!r}")
        elif not os.path.exists(os.path.join(root, "traffic", kind + ".py")):
            bad.append(f"{name}: no traffic driver for {kind!r}")
        elif w["config"] in cfgs and family_name(cfgs[w["config"]]) not in served_families(kind, root):
            bad.append(f"{name}: traffic kind {kind} does not serve the family "
                       f"{family_name(cfgs[w['config']])!r} of config {w['config']}")
        if "setup_s" not in w["end_to_end"] or len(w["end_to_end"]) < 2 or not w["per_layer"]:
            bad.append(f"{name}: needs setup_s, another end-to-end metric and a per-layer metric")
        for m in w["end_to_end"]:
            if m not in e2e:
                bad.append(f"{name}: no end-to-end metric {m!r}")
        for m in w["per_layer"]:
            if m not in layers:
                bad.append(f"{name}: no per-layer metric {m!r}")
            elif layers[m].META["moves"] not in w["end_to_end"]:
                bad.append(f"{name}: {m} moves {layers[m].META['moves']}, which the cell does not report")
    used = {w["config"] for w in cells.values()}
    bad += [f"config {c} is used by no cell" for c in cfgs if c not in used]
    used_fams = {family_name(c) for c in cfgs.values()}
    bad += [f"family {f} is used by no config" for f in fams if f not in used_fams]
    used_mixes = {w["mix"] for w in cells.values()}
    bad += [f"mix {m} is used by no cell" for m in mx if m not in used_mixes]
    kinds = {mx[m]["kind"] for m in used_mixes if m in mx}
    bad += [f"traffic kind {k} is used by no cell" for k in _by_name("traffic", ".py", root) if k not in kinds]
    for key, metrics in (("end_to_end", e2e), ("per_layer", layers)):
        reported = {m for w in cells.values() for m in w[key]}
        bad += [f"metric {m} is reported by no cell" for m in metrics if m not in reported]
    return bad
