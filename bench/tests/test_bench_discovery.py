"""The benchmark finds a cell's files and a metric's reader by name, and a
new configuration, mix, cell or metric needs new files and entries only."""
from __future__ import annotations

import json
import shutil

import pytest

from tiny import CELLS, LIMITS, ROOT
from bench import harness


def test_every_cell_and_metric_has_its_files():
    spec = harness.spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        c = harness.cell(w["name"])
        assert set(c["limits"]) == LIMITS
        assert (ROOT / "bench" / f"{c['mix']['mode']}.py").exists()
        assert any(m["name"] == "setup_s" for m in c["end_to_end"])
        assert len(c["end_to_end"]) >= 2 and c["per_layer"]
        reported = {m["name"] for m in c["end_to_end"]}
        for m in c["per_layer"]:
            assert m["moves"] in reported
    for m in spec["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
        assert m["moves"] in e2e and callable(reader.read)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_by_name(name):
    c = harness.cell(name)
    assert c["cfg"]["name"] == c["config"]
    assert c["name"] in [w["name"] for w in harness.spec()["workloads"]]
    assert c["traffic"] and c["chips"] == 1


def test_new_cell_and_metric_need_no_edit(tmp_path):
    """A copy of the checkout gains a mix, a cell and a metric by adding
    files and entries; the harness picks them up, and nothing else
    changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.spec()
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    mix = dict(harness.load_json(ROOT / "bench/traffic/train-b8s128-ndsc.json"),
               seq=256)
    (tmp_path / "bench/traffic/train-b4s256-ndsc.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench/workloads/yi6b-train-long.json").write_text(
        json.dumps({"limits": {"loss1": 1.0, "grad": 1.0, "grad2": 1.0,
                               "change": 1.0}}))
    (tmp_path / "bench/metrics/steps_traced.py").write_text(
        'LAYER = "device"\nMOVES = "train_tokens_per_s"\n\n\n'
        'def read(trace):\n    return float(trace.steps) or None\n')
    spec["workloads"].append({"name": "yi6b-train-long", "config": "yi-6b",
                              "traffic": "train-b4s256-ndsc", "chips": 1,
                              "why": "longer rows"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "1",
                              "better": "higher", "source": "device_trace",
                              "layer": "device",
                              "moves": "train_tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.cell("yi6b-train-long", tmp_path)
    assert c["mix"]["seq"] == 256 and c["cfg"]["name"] == "yi-6b"
    assert "steps_traced" in [m["name"] for m in c["per_layer"]]
    reader = harness.metric_reader("steps_traced", tmp_path)
    assert reader.MOVES == "train_tokens_per_s"
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_forbidden_modules_named_by_top_level(monkeypatch):
    import sys
    import types

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.codecs", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["repro.codecs"]
