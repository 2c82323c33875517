"""Whole runs of every traffic kind at a tiny size on the CPU (the check for
a card skipped): the result line's schema, ``correct`` true on a sound run,
and ``correct`` false with the timed path broken underneath."""

import json
import time

import numpy as np
import pytest
import torch

from vfx_bench import harness
from vfx_bench.faults import planted
from vfx_bench.run import run_cell
from vfx_bench.tests.tiny import tiny_cell
from vfx_bench.trace import reduce_events

SEED = 2**31 + 77  # seeds run past 32 signed bits
LIMITS = {
    "forward": {"pred_gap": 1.5, "emb_gap": 0.8},
    "query": {"pred_gap": 1.0, "emb_gap": 1.0},
    "sweep": {"pred_gap": 1.0},
    "finetune": {"loss_gap": 0.005, "grad_gap": 0.05, "update_gap": 0.1, "token_mismatch": 0},
}
E2E = {"forward": "genes_per_s", "query": "query_p90_ms", "sweep": "sweep_genes_per_s",
       "finetune": "train_samples_per_s"}


def cell(kind):
    c = tiny_cell(kind, dict(LIMITS[kind]))
    c.end_to_end = [{"name": E2E[kind], "unit": "x"}, {"name": "setup_s", "unit": "s"}]
    c.per_layer = [m for m in harness.manifest()["per_layer"]]
    return c


def go(kind, trace=False, seconds=0.5):
    return run_cell(cell(kind), SEED, seconds, trace, "cpu", t_start=time.perf_counter())[0]


@pytest.mark.parametrize("kind", ["forward", "query", "sweep", "finetune"])
def test_sound_run(kind):
    line = go(kind)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {E2E[kind], "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes",
                                   "memory_reserved_peak_bytes"}
    assert line["device"]["memory_reserved_peak_bytes"] == 0  # no card
    assert set(line["checks"]) == set(LIMITS[kind])
    json.dumps(line)


def test_traced_line():
    line = go("forward", trace=True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the shares of a device are left out, not 0
    assert "kernels_roofline.genes" not in line["metrics"]
    assert "window_encoder_roofline.genes" not in line["metrics"]
    assert "launch_idle_frac.genes" not in line["metrics"]
    assert line["metrics"]["mfu.genes"]["unit"] == "%"


@pytest.mark.parametrize("kind,fault", [
    ("forward", "answer"), ("forward", "half_batch"), ("query", "answer"), ("sweep", "answer"),
    ("finetune", "unchanged"), ("finetune", "half_batch"), ("finetune", "token"),
])
def test_fault_makes_the_run_incorrect(kind, fault):
    with planted(fault):
        line = go(kind)
    assert not line["correct"], line["checks"]


def test_control_reads_above_the_program():
    """At the tiny size too, the reference in float8 in the program's place
    reads several times the program's gaps (the card's readings set the
    limits: PERF.md)."""
    from vfx_bench.harness import Run, kind_module

    c = cell("forward")
    prog = go("forward")["checks"]
    run = Run(cell=c, seed=SEED, seconds=0, device="cpu", scratch=None)
    low = kind_module("forward").control(run)
    assert low["emb_gap"] > 3 * prog["emb_gap"]["value"]


def test_trace_reduction_names_idle_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "call", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80, "dur": 5},
    ]
    t = reduce_events(ev, 1e-4)
    assert t.kernels == 2
    assert t.busy_s == pytest.approx(30e-6)
    gaps = dict(t.idle_gaps)
    assert gaps["call"] == pytest.approx(10e-6 + 15e-6)
    assert gaps["aten::copy_"] == pytest.approx(45e-6)
    assert dict(t.device_ops)["k1"] == pytest.approx(20e-6)


def test_exits_without_a_card(capsys):
    from vfx_bench import run as entry

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert entry.main(["--workload", "v4_pcg.forward_d4", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_sample_draws_from_the_seed():
    from vfx_bench.serving import sample

    assert sample(5, 100, 8, 1) == sample(5, 100, 8, 1) != sample(6, 100, 8, 1)
    assert len(set(sample(5, 100, 8, 1))) == 8 and np.max(sample(5, 3, 8, 1)) < 3
