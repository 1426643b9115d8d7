"""BENCHMARK.json keeps to its contract, and every configuration, traffic
mix and per-layer metric is found by name from files of its own."""

import json
import os
import re
import shutil
import subprocess
import sys

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_spec_keeps_to_the_contract():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith(
        "benchmark/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) <= set(conf) and len(c["reduced"]) <= 16
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    cells = {w["name"]: w for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers",
                                           kind + ".py"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits",
                                           w["name"] + ".json"))

        def reports(m, name=w["name"]):
            return name in m.get("workloads", [name])

        got = [m["name"] for m in b["end_to_end"] if reports(m)]
        assert "setup_s" in got and len(got) >= 2
        assert any(reports(m) for m in b["per_layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells)


def test_a_new_config_mix_and_metric_are_files_only(tmp_path):
    """A later change adds a cell, its configuration, its mix and a metric
    by adding files and entries: nothing that is there is edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load()
    bench = tmp_path / "benchmark"
    shutil.copy(bench / "configs" / "dancedb_6trk.json",
                bench / "configs" / "later_config.json")
    traffic = json.loads((bench / "traffic" / "ragged_corpus.json")
                         .read_text())
    traffic["lanes"] = 4096
    (bench / "traffic" / "later_mix.json").write_text(json.dumps(traffic))
    (bench / "limits" / "later_cell.json").write_text(
        (bench / "limits" / "offline_6trk_mixed.json").read_text())
    (bench / "metrics" / "later.metric.py").write_text(
        "def read(rec):\n    return rec.get('later')\n")
    b["configs"].append(dict(b["configs"][0], name="later_config",
                             file="benchmark/configs/later_config.json"))
    b["workloads"].append(dict(name="later_cell", config="later_config",
                               traffic="later_mix", chips=1, why="later"))
    b["per_layer"].append(dict(b["per_layer"][0], name="later.metric",
                               workloads=["later_cell"]))
    b["end_to_end"][0]["workloads"].append("later_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "c = harness.cell('later_cell')\n"
        "assert c.traffic['lanes'] == 4096, c.traffic\n"
        "assert c.config['name'] == 'dancedb_6trk'\n"
        "assert harness.driver(c.traffic['kind']).__name__.endswith("
        "'offline_batch')\n"
        "assert 'later.metric' in [m['name'] for m in c.per_layer]\n"
        "r = harness.metric_reader('later.metric')\n"
        "assert r.read({'later': 3.0}) == 3.0 and r.read({}) is None\n"
        "print('found')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr
