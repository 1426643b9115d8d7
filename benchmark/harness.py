"""What every cell shares: the spec and the files found by name, the guard
against the JAX package, the device's description and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix's ``kind`` names the
driver that runs it (``drivers/<kind>.py``); each per-layer metric is read
by ``metrics/<name>.py``.  A new cell, mix or metric is new files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dragposer_tpu")
IMPORTED = time.time()      # the interpreter's own start-up ends about here


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or now
    where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The workload ``name`` with its configuration and traffic files and
    the metrics it reports."""
    bench = bench or spec()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(ROOT, conf["file"])
    traffic = load_json(HERE, "traffic", w["traffic"] + ".json")

    def reports(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py`` (the name may hold dots) as a module."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec_ = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> List[str]:
    """Modules of the JAX side in this process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Limit:
    """A number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def checks(workload: str, gaps: dict, departures: list) -> List[Limit]:
    """The judge's numbers held to ``limits/<workload>.json``, and the
    program's departures from the configuration (none allowed)."""
    lim = load_json(HERE, "limits", workload + ".json")
    out = [Limit(k, float(gaps[k]), float(v)) for k, v in lim.items()]
    out.append(Limit("config_departures", float(len(departures)), 0.0))
    for d in departures:
        print("departs from the configuration: " + d, file=sys.stderr)
    return out


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics (``--trace 0``) or
    the recording the per-layer readers read (``--trace 1``), the checks,
    and the device's figures."""

    attempted: int
    failed: int
    metrics: Dict[str, float] = field(default_factory=dict)
    recording: Any = None
    checks: List[Limit] = field(default_factory=list)
    device: Dict[str, Any] = field(default_factory=dict)
    breakdown: Optional[dict] = None


def device_description(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def result_line(c: Cell, out: Outcome, trace: bool) -> dict:
    """The last line of standard output."""
    correct = bool(out.checks) and all(x.ok for x in out.checks)
    metrics = {}
    if trace:
        for m in c.per_layer:
            value = metric_reader(m["name"]).read(out.recording)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["compared"] = {x.name: {"value": x.value, "limit": x.limit}
                        for x in out.checks}
    return line
