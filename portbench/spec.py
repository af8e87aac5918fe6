"""What a cell is made of, found by the names in ``BENCHMARK.json``:

- the configuration: the file its ``configs`` entry names
  (``portbench/configs/<name>.json``);
- the traffic mix: ``portbench/traffic/<traffic>.json``;
- the limits of its correctness check: ``portbench/limits/<cell>.json``;
- each per-layer metric: the module ``portbench/metrics/<metric>.py``, whose
  ``read(reading)`` returns the number or None where it finds nothing to
  read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict = None) -> Dict[str, dict]:
    """The cell ``name``: its entry, configuration, traffic and limits."""
    bench = bench or benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    c = cells[name]
    cfg = next(x for x in bench["configs"] if x["name"] == c["config"])
    return {"cell": c, "config": _json(ROOT / cfg["file"]),
            "traffic": _json(HERE / "traffic" / f"{c['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{name}.json")["limits"]}


def metrics(bench: dict, kind: str, cell_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read`` function of the per-layer metric ``metric``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
