"""What every cell of the port's benchmark shares: finding a cell's files by
the names in ``BENCHMARK.json``, the device's description, the check that
no JAX module was loaded, and the result line.

The benchmark is driven by data. A cell names a configuration
(``configs/<config>.json``, whose ``job`` names ``jobs/<job>.py``)
and a traffic mix (``traffic/<traffic>.json``); a per-layer metric is read
by ``metrics/<metric>.py``. Each is found by its name alone, so a later
change adds a configuration, a mix or a metric as new files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that may not be loaded in a run: JAX and the JAX package, compared
# by whole top-level name (the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "satpu")


class Refused(Exception):
    """A run that cannot produce a result (exits non-zero, prints none)."""


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no BENCHMARK.json at {root}")
    return read_json(path)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    if not os.path.exists(path):
        raise Refused(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and metric lists, read from the files their names point at."""

    def __init__(self, bench: Dict[str, Any], name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.root = name, root
        self.home = os.path.join(root, bench["paths"][0])  # the benchmark's own folder
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = read_json(os.path.join(self.home, "traffic",
                                              self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, name)]
        moved = {m["name"] for m in self.end_to_end}
        # a per-layer metric without ``workloads`` is read in every cell that
        # reports the end-to-end metric it moves
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def job(self):
        return load_module(os.path.join(self.home, "jobs", self.config["job"] + ".py"),
                           "portbench_job_" + self.config["job"])

    def reader(self, metric: str):
        return load_module(os.path.join(self.home, "metrics", metric + ".py"),
                           "portbench_metric_" + metric.replace(".", "_"))


def read_layers(cell: Cell, layer: Dict[str, Any]) -> Dict[str, Any]:
    """The cell's per-layer metrics that their readers find in ``layer``
    (a reader that finds nothing leaves its metric out)."""
    found = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(layer)
        if value is not None:
            found[m["name"]] = metric(value, m["unit"])
    return found


def reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def device_info(torch, chips: int) -> Dict[str, Any]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips))}


def metric(value: float, unit: str) -> Dict[str, Any]:
    return {"value": float(value), "unit": unit}


def checks_text(checks: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a compared number: its name, value and limit."""
    return [f"check {k}: {v['value']!r} limit {v['limit']!r} -> "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}" for k, v in checks.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
                device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None, extra: Optional[Dict] = None
                ) -> str:
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = checks  # last: the numbers compared beside their limits
    return json.dumps(out)
