"""The control (the plain reference in float8 in the program's place) comes
out as not correct: at a tiny size on the CPU against the tiny runs'
limits, and, on the card, at each cell's own size against its limits."""

import pytest

from vfx_bench import harness
from vfx_bench.harness import Run, judge, kind_module
from vfx_bench.tests import test_bench_run as runs
from vfx_bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("kind", ["forward", "query", "sweep", "finetune"])
def test_control_is_not_correct_at_a_tiny_size(kind, tmp_path):
    cell = tiny_cell(kind, dict(runs.LIMITS[kind]))
    run = Run(cell=cell, seed=runs.SEED, seconds=0, device="cpu", scratch=tmp_path)
    readings = kind_module(kind).control(run)
    readings.setdefault("token_mismatch", 0.0)  # the control rebuilds the tokens itself
    ok, checks = judge(readings, cell.limits)
    assert not ok, checks


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_is_not_correct_at_the_cells_size(cell, card, tmp_path):
    c = harness.load_cell(cell)
    run = Run(cell=c, seed=7_000_000_001, seconds=0, device="cuda", scratch=tmp_path)
    readings = kind_module(c.kind).control(run)
    readings.setdefault("token_mismatch", 0.0)
    ok, checks = judge(readings, c.limits)
    assert not ok, checks
