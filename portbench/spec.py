"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

Every function takes the benchmark's folder (``root``) and its
``BENCHMARK.json``, so that a copy of the folder with files added is read
the same way as the folder itself.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> dict:
    """Everything one cell runs with: its ``BENCHMARK.json`` entry
    (``name``, ``config``, ``traffic``, ``chips``), its own file
    (``workloads/<name>.json``), its configuration's and its traffic's
    files, and the names of its end-to-end and per-layer metrics."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(entries)})")
    w = entries[name]
    return {
        **w,
        "cell": load_json(root / "workloads" / f"{name}.json"),
        "config_file": load_json(root / "configs" / f"{w['config']}.json"),
        "traffic_file": load_json(root / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": metrics_of(bench, "end_to_end", name),
        "per_layer": metrics_of(bench, "per_layer", name),
    }


def metrics_of(bench: dict, kind: str, cell_name: str) -> list[dict]:
    """The metrics of ``kind`` that ``cell_name`` reports: those with no
    ``workloads`` key and those that list it."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def listing(root: Path = ROOT, bench: dict | None = None) -> dict:
    """Each kind of file the harness finds, by name, for every entry of
    ``BENCHMARK.json``: raises where a named file is missing."""
    bench = benchmark() if bench is None else bench
    out = {"configs": {}, "workloads": {}, "traffic": {}, "entries": {}, "metrics": {}}
    for c in bench["configs"]:
        out["configs"][c["name"]] = load_json(root / "configs" / f"{c['name']}.json")
    for w in bench["workloads"]:
        spec = cell(w["name"], root, bench)
        out["workloads"][w["name"]] = spec["cell"]
        out["traffic"][w["traffic"]] = spec["traffic_file"]
        out["entries"][spec["cell"]["entry"]] = module(root / "entries" / f"{spec['cell']['entry']}.py")
    for m in bench["per_layer"]:
        out["metrics"][m["name"]] = reader(m["name"], root)
    return out


def module(path: Path):
    """The Python file at ``path`` as a module (a metric's name holds dots,
    so its file is loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """A per-layer metric's ``read(ctx)`` (``metrics/<metric>.py``)."""
    return module(root / "metrics" / f"{metric}.py").read


def entry(name: str, root: Path = ROOT):
    """A step entry's module (``entries/<name>.py``)."""
    return module(root / "entries" / f"{name}.py")
