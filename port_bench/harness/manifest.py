"""``BENCHMARK.json`` and the benchmark's files, found by name.

Everything that belongs to one configuration, cell, traffic mix or metric
sits in a file of its own, and this module finds it from the name that
``BENCHMARK.json`` gives:

- a configuration: the ``file`` of its entry (``configs/<config>.json``);
- a cell: ``workloads/<cell>.json`` (its configuration, traffic and chips);
- a traffic mix: ``traffic/<traffic>.json`` (its parameters and the name
  of the driver that generates it);
- a driver: ``drivers/<driver>.py``;
- a metric, end to end or per layer: ``metrics/<metric>.py``, whose
  ``read(run)`` returns the number or None.

So a later change adds a configuration, a cell or a metric by adding files
and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH_RE = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
E2E_SOURCES = {"host_clock", "device_trace"}
LAYER_SOURCES = {"device_trace", "program_counter", "host_clock"}
BENCH_DIR = "port_bench"


class ManifestError(ValueError):
    """``BENCHMARK.json`` or a file it names breaks the contract."""


def _line(text, what, limit=200):
    if (not isinstance(text, str) or not 1 <= len(text) <= limit
            or "\n" in text or "\t" in text):
        raise ManifestError(f"{what}: 1 to {limit} characters on one line, "
                            f"no tab (got {text!r})")


def _name(text, what):
    if not isinstance(text, str) or not NAME_RE.match(text):
        raise ManifestError(f"{what}: not a name ({text!r}): a letter, digit "
                            "or _ first, then at most 63 of letters, digits, "
                            "_, . and -")


def _keys(entry, allowed, what, optional=()):
    if not isinstance(entry, dict):
        raise ManifestError(f"{what}: not an object")
    missing = allowed - set(entry)
    extra = set(entry) - allowed - set(optional)
    if missing or extra:
        raise ManifestError(f"{what}: keys missing {sorted(missing)}, not "
                            f"allowed {sorted(extra)}")


def _metric(m, keys, sources, what, workload_names, e2e_names=None):
    _keys(m, keys, what, optional=("workloads",))
    _name(m["name"], f"{what} name")
    if not isinstance(m["unit"], str) or not UNIT_RE.match(m["unit"]):
        raise ManifestError(f"{what} unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        raise ManifestError(f"{what} better: lower or higher")
    if m["source"] not in sources:
        raise ManifestError(f"{what} source {m['source']!r} not in "
                            f"{sorted(sources)}")
    cells = m.get("workloads")
    if cells is not None:
        if not cells or any(c not in workload_names for c in cells):
            raise ManifestError(f"{what} workloads {cells}: each a cell")
    if e2e_names is not None:
        _line(m["layer"], f"{what} layer")
        if m["moves"] not in e2e_names:
            raise ManifestError(f"{what} moves {m['moves']!r}: not an "
                                "end-to-end metric")


def validate(bench: dict) -> None:
    """Raise :class:`ManifestError` where ``bench`` breaks the contract's
    limits on keys, names, units, counts and references."""
    _keys(bench, TOP_KEYS, "BENCHMARK.json")
    cmd = bench["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise ManifestError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise ManifestError(f"command word {word!r} leaves the repo")
    paths = bench["paths"]
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise ManifestError("paths: 1 to 16 directories")
    for p in paths:
        if (not isinstance(p, str) or not PATH_RE.match(p)
                or p.startswith("/") or ".." in p.split("/")):
            raise ManifestError(f"path {p!r}")
    secs = bench["run_seconds"]
    if not isinstance(secs, int) or not 1 <= secs <= 51:
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    configs = bench["configs"]
    if not isinstance(configs, list) or not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24 entries")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config name")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        if (not isinstance(c["reduced"], list) or len(c["reduced"]) > 16):
            raise ManifestError(f"config {c['name']} reduced: at most 16")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            raise ManifestError(f"config {c['name']} file outside paths")
        if c["file"] in files:
            raise ManifestError(f"config file {c['file']} used twice")
        files.add(c["file"])
    config_names = [c["name"] for c in configs]

    cells = bench["workloads"]
    if not isinstance(cells, list) or not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24 cells")
    pairs = set()
    for w in cells:
        _keys(w, WORKLOAD_KEYS, "workload")
        _name(w["name"], "workload name")
        _name(w["config"], f"workload {w['name']} config")
        _name(w["traffic"], f"workload {w['name']} traffic")
        _line(w["why"], f"workload {w['name']} why")
        if w["config"] not in config_names:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips 1 or 4")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            raise ManifestError(f"workload {w['name']}: {pair} again")
        pairs.add(pair)
    cell_names = [w["name"] for w in cells]
    four = sum(w["chips"] == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        raise ManifestError(f"{four} cells on 4 chips of {len(cells)}")
    unused = set(config_names) - {w["config"] for w in cells}
    if unused:
        raise ManifestError(f"configs used by no cell: {sorted(unused)}")

    e2e = bench["end_to_end"]
    if not isinstance(e2e, list) or not 1 <= len(e2e) <= 16:
        raise ManifestError("end_to_end: 1 to 16 metrics")
    for m in e2e:
        _metric(m, E2E_KEYS, E2E_SOURCES, f"end_to_end {m.get('name')}",
                cell_names)
        b = m["bound"]
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            raise ManifestError(f"bound of {m['name']}: 0.01 to 0.25")
    e2e_names = [m["name"] for m in e2e]
    if "setup_s" not in e2e_names:
        raise ManifestError("end_to_end has no setup_s")
    layer = bench["per_layer"]
    if not isinstance(layer, list) or not 1 <= len(layer) <= 128:
        raise ManifestError("per_layer: 1 to 128 metrics")
    for m in layer:
        _metric(m, LAYER_KEYS, LAYER_SOURCES, f"per_layer {m.get('name')}",
                cell_names, e2e_names)
    names = e2e_names + [m["name"] for m in layer]
    for kind, seq in (("metric", names), ("cell", cell_names),
                      ("config", config_names)):
        if len(set(seq)) != len(seq):
            raise ManifestError(f"two {kind}s share a name")

    for w in cells:
        mine = [m for m in e2e if _reports(m, w["name"])]
        if len(mine) < 2:
            raise ManifestError(f"cell {w['name']}: setup_s and one more "
                                "end-to-end metric")
        moves = {m["name"] for m in mine}
        for m in layer:
            if w["name"] in m.get("workloads", ()) and m["moves"] not in moves:
                raise ManifestError(f"{m['name']} in {w['name']} moves "
                                    f"{m['moves']}, which it does not report")
        if not any(_reports(m, w["name"], moves) for m in layer):
            raise ManifestError(f"cell {w['name']}: no per-layer metric")
    if len(json.dumps(bench).encode()) > 64 * 1024:
        raise ManifestError("BENCHMARK.json over 64 KiB")


def _reports(metric: dict, cell: str, moves=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or without
    a list every cell (a per-layer metric: every cell that reports the
    end-to-end metric it moves, ``moves``)."""
    cells = metric.get("workloads")
    if cells is not None:
        return cell in cells
    return moves is None or metric["moves"] in moves


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it leads to."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise ManifestError(f"no BENCHMARK.json in {self.root}")
        self.data = json.loads(path.read_text())
        validate(self.data)
        self.dir = self.root / BENCH_DIR

    def cell(self, name: str) -> dict:
        """The cell ``name``: its BENCHMARK.json entry, its workload file's
        keys, its configuration and its traffic."""
        entries = {w["name"]: w for w in self.data["workloads"]}
        if name not in entries:
            raise ManifestError(f"no cell {name!r}; cells: "
                                f"{sorted(entries)}")
        entry = entries[name]
        work = self._json(self.dir / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if work.get(key) != entry[key]:
                raise ManifestError(f"workloads/{name}.json {key} "
                                    f"{work.get(key)!r} differs from "
                                    f"BENCHMARK.json's {entry[key]!r}")
        config_entry = {c["name"]: c for c in self.data["configs"]}[
            entry["config"]]
        traffic = self._json(self.dir / "traffic" / f"{entry['traffic']}.json")
        return {"name": name, "entry": entry, "workload": work,
                "config": self._json(self.root / config_entry["file"]),
                "config_entry": config_entry, "traffic": traffic,
                "driver": work.get("driver", traffic.get("driver"))}

    def metrics(self, cell: str):
        """(end-to-end, per-layer) metric entries that ``cell`` reports."""
        e2e = [m for m in self.data["end_to_end"] if _reports(m, cell)]
        moves = {m["name"] for m in e2e}
        layer = [m for m in self.data["per_layer"]
                 if _reports(m, cell, moves)]
        return e2e, layer

    def driver(self, name: str):
        return load_module(self.dir / "drivers" / f"{name}.py",
                           f"port_bench_driver_{name}")

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "port_bench_metric_" + metric.replace(".", "_")
                           .replace("-", "_"))

    def data_file(self, *parts) -> dict:
        return self._json(self.dir.joinpath(*parts))

    @staticmethod
    def _json(path: Path) -> dict:
        if not path.is_file():
            raise ManifestError(f"missing file {path}")
        return json.loads(path.read_text())


def load_module(path: Path, module_name: str):
    """The module at ``path`` (a driver or a metric's reader)."""
    if not path.is_file():
        raise ManifestError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
