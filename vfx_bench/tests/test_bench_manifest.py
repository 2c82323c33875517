"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import re

import pytest

from vfx_bench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert MAN["paths"] == ["vfx_bench"]
    assert all(TEXT.match(w) for w in MAN["command"]) and len(MAN["command"]) <= 32


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert TEXT.match(entry[key]), entry[key]
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_metric_entries():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:  # the cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert harness.kind_module(c.kind).setup
    assert c.limits and c.config["name"] == cell.split(".")[0]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    cfg = json.loads((harness.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("vfx_bench/") and cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"] == []
    from vfx_bench.weights import count

    assert count(cfg) == cfg["parameters"] == 1_206_978_923
    assert sum(c["file"] == conf["file"] for c in MAN["configs"]) == 1
    assert any(w["config"] == conf["name"] for w in MAN["workloads"])


def test_config_is_the_ports_default():
    """At published width and depth: the port's defaults (the released
    v4_pcg) for every architecture key."""
    import dataclasses

    from variantformer_tpu_torch.config import ModelConfig

    d = ModelConfig()
    for conf in MAN["configs"]:
        cfg = json.loads((harness.ROOT / conf["file"]).read_text())
        for group in ("window_encoder", "seq2gene", "dataset"):
            assert cfg[group] == dataclasses.asdict(getattr(d, group)), (conf["name"], group)


def test_run_budget():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (MAN["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
