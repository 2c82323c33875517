"""The harness's frame: the manifest, a cell's files found by name, the run's
record, the comparison with the limits, and the result line.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` reads
``configs/<config>.json`` (the manifest's ``file``), ``traffic/<mix>.json``
(whose ``kind`` names its module ``kinds/<kind>.py``), ``limits/<cell>.json``
(the limit of every number the comparison reads) and, for each per-layer
metric that lists the cell, ``metrics/<metric>.py``. Adding a cell, a mix or
a metric adds files and manifest entries; no file here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "variantformer_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict                  # the configuration file
    traffic: dict                 # the traffic file
    limits: dict                  # number -> limit
    chips: int
    end_to_end: list[dict]        # the manifest's metrics this cell reports
    per_layer: list[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, man: dict | None = None, base: Path = HERE) -> Cell:
    man = man or manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    return Cell(
        name=name,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((base / "limits" / f"{name}.json").read_text()),
        chips=w["chips"],
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def kind_module(kind: str):
    return importlib.import_module(f"vfx_bench.kinds.{kind}")


def reader(metric: str, base: Path = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vfx_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from variantformer_tpu_torch.config import (
        DatasetConfig,
        ModelConfig,
        PrecisionPolicy,
        Seq2GeneConfig,
        WindowEncoderConfig,
    )

    return ModelConfig(
        model_class=cfg["model_class"],
        window_encoder=WindowEncoderConfig(**cfg["window_encoder"]),
        seq2gene=Seq2GeneConfig(**cfg["seq2gene"]),
        dataset=DatasetConfig(**cfg["dataset"]),
        precision=PrecisionPolicy(**cfg["precision"]),
    )


@dataclasses.dataclass
class Run:
    """What one run of a cell hands its readers and its comparison."""

    cell: Cell
    seed: int
    seconds: float
    device: str
    scratch: Path
    counters: dict = dataclasses.field(default_factory=dict)
    end_to_end: dict = dataclasses.field(default_factory=dict)
    trace: object = None          # trace.Trace of the traced sub-window
    readings: dict = dataclasses.field(default_factory=dict)
    kept: dict = dataclasses.field(default_factory=dict)  # outputs the check judges
    attempted: int = 0
    failed: int = 0

    @property
    def cfg(self) -> dict:
        return self.cell.config


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Every number against its limit (correct: each at or under it, and a
    number with no reading is not correct)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
