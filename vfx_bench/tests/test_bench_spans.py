"""``spans.reduce_spans`` and the span metrics' readers on hand-made Chrome
trace events (times in us), and ``Trace.spans`` of a traced window."""

from types import SimpleNamespace

import pytest
import torch

from vfx_bench import harness
from vfx_bench.spans import reduce_spans, shares
from vfx_bench.trace import Tracer, reduce_events

MAIN, AUTOGRAD, POOL = 1, 2, 3


def span(name, tid, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "tid": tid, "ts": ts, "dur": dur}


def launch(corr, tid, ts, cat="cuda_runtime", name="cudaLaunchKernel"):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def kernel(corr, ts, dur, cat="kernel", name="k"):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur, "args": args}


def events():
    """A call on MAIN (0-1000): forward 0-600 with two stages, a backward
    launched from AUTOGRAD while MAIN holds train.backward, a pool build."""
    return [
        span("vfx_bench.fit", MAIN, 0, 1000),
        span("train.step", MAIN, 0, 900),
        span("seq2gene.forward", MAIN, 0, 600),
        span("seq2gene.window_encoder", MAIN, 0, 300),
        span("seq2gene.gene_stack", MAIN, 300, 300),
        span("train.backward", MAIN, 600, 300),
        span("sweep.host_build", POOL, 0, 1000),
        launch(1, MAIN, 10),
        launch(2, MAIN, 310, cat="cuda_driver", name="cuLaunchKernel"),
        launch(3, AUTOGRAD, 650),
        launch(4, MAIN, 950, name="cudaMemcpyAsync"),
        kernel(1, 100, 100),
        kernel(2, 400, 150),
        kernel(3, 700, 100),
        kernel(4, 960, 20, cat="gpu_memcpy"),  # launched outside every program span
        kernel(None, 990, 5),                  # no launch record
        kernel(99, 995, 5, cat="gpu_memset"),  # a correlation id with no launch
    ]


def test_attribution_by_correlation_id():
    s = reduce_spans(events())
    assert s.device_s["seq2gene.window_encoder"] == pytest.approx(100e-6)
    assert s.device_s["seq2gene.gene_stack"] == pytest.approx(150e-6)
    assert s.device_s["seq2gene.forward"] == pytest.approx(250e-6)
    assert s.kernel_s == pytest.approx(355e-6)
    assert s.kernel_launched_s == pytest.approx(350e-6)
    assert s.count == {"train.step": 1, "seq2gene.forward": 1, "seq2gene.window_encoder": 1,
                       "seq2gene.gene_stack": 1, "train.backward": 1, "sweep.host_build": 1}


def test_autograd_thread_launch_takes_the_call_threads_spans():
    s = reduce_spans(events())
    assert s.device_s["train.backward"] == pytest.approx(100e-6)
    assert s.device_s["train.step"] == pytest.approx(350e-6)
    # a thread with spans of its own keeps them: the pool's build is not the call's
    ev = events() + [launch(5, POOL, 500), kernel(5, 500, 10)]
    s = reduce_spans(ev)
    assert s.device_s["sweep.host_build"] == pytest.approx(10e-6)
    assert s.device_s["seq2gene.forward"] == pytest.approx(250e-6)


def test_idle_inside_a_span_on_the_call_thread_only():
    s = reduce_spans(events())
    # forward 0-600, busy 100-200 and 400-550: idle 600 - 250
    assert s.idle_s["seq2gene.forward"] == pytest.approx(350e-6)
    assert s.idle_s["seq2gene.window_encoder"] == pytest.approx(200e-6)
    assert s.idle_s["train.backward"] == pytest.approx(200e-6)
    assert s.idle_s["train.step"] == pytest.approx(900e-6 - 350e-6)
    assert "sweep.host_build" not in s.idle_s  # the pool's spans are not the call thread's


def test_unattributed_device_time_counted():
    s = reduce_spans(events())
    assert s.unattributed_s == pytest.approx(30e-6)
    assert s.device_total_s == pytest.approx(380e-6)
    r = shares(s)
    assert r["unattributed_share"] == pytest.approx(30 / 380)
    assert r["kernel_launched_share"] == pytest.approx(350 / 355)
    assert r["stage_share_of_forward"] == pytest.approx(1.0)
    assert read("launch_idle_frac.train", s, 1e-3) == pytest.approx(0.55)


def test_busy_union_is_the_one_reduce_events_counts():
    ev = events() + [span("seq2gene.forward", MAIN, 1000, 10)]
    t = reduce_events(ev, window_s=1.01e-3)
    s = reduce_spans(ev + [span("fit.next_batch", MAIN, 0, 1010)])
    assert s.idle_s["fit.next_batch"] == pytest.approx(1010e-6 - t.busy_s)
    assert reduce_events(ev, 1.01e-3) == t  # the trace's own fields, as before


def test_forward_readings_per_traced_gene():
    s = reduce_spans(events())
    assert read("window_encoder_ms.genes", s, 1e-3) == pytest.approx(100e-3 / 8)
    assert read("gene_stack_ms.genes", s, 1e-3) == pytest.approx(150e-3 / 8)
    assert read("cre_stack_ms.genes", s, 1e-3) is None  # the span never opened: no 0
    assert read("launch_idle_frac.genes", s, 1e-3) == pytest.approx(0.35)


# -- the readers of the span metrics ------------------------------------------------
COUNTERS = {"trace_genes": 8, "trace_calls": 2, "trace_least_s.window_encoder": 50e-6,
            "trace_least_s.cre_stack": 10e-6, "trace_least_s.gene_stack": 75e-6,
            "trace_least_s.optimizer": 30e-6}


def more():
    """``events`` and, after them, a CRE stack (40 us of device time), an
    optimizer update (60 us) and a wait for the builds with the card idle."""
    return events() + [
        span("seq2gene.cre_stack", MAIN, 1000, 100), launch(10, MAIN, 1010), kernel(10, 1020, 40),
        span("train.optimizer", MAIN, 1100, 100), launch(11, MAIN, 1110), kernel(11, 1120, 60),
        span("sweep.wait_build", MAIN, 1200, 100),
    ]


# metric -> (its span, its reading on ``more()`` over a 2 ms window)
SPAN_METRICS = {
    "window_encoder_ms.genes": ("seq2gene.window_encoder", 0.100 / 8),
    "cre_stack_ms.genes": ("seq2gene.cre_stack", 0.040 / 8),
    "gene_stack_ms.genes": ("seq2gene.gene_stack", 0.150 / 8),
    "window_encoder_roofline.genes": ("seq2gene.window_encoder", 50.0),
    "cre_stack_roofline.genes": ("seq2gene.cre_stack", 25.0),
    "gene_stack_roofline.genes": ("seq2gene.gene_stack", 50.0),
    "launch_idle_frac.genes": ("seq2gene.forward", 350e-6 / 2e-3),
    "launch_idle_frac.sweep": ("seq2gene.forward", 350e-6 / 2e-3),
    "build_wait_idle_frac.sweep": ("sweep.wait_build", 100e-6 / 2e-3),
    "launch_idle_frac.train": ("train.step", 550e-6 / 2e-3),
    "optimizer_ms.train": ("train.optimizer", 0.060 / 2),
    "optimizer_roofline.train": ("train.optimizer", 50.0),
}


def read(metric, spans, window_s, counters=COUNTERS, trace=True):
    t = SimpleNamespace(spans=spans, window_s=window_s) if trace else None
    return harness.reader(metric)(SimpleNamespace(trace=t, counters=dict(counters)))


def test_every_span_metric_is_in_the_manifest_for_its_one_cell():
    man = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for metric in SPAN_METRICS:
        assert man[metric]["source"] == "program_span" and len(man[metric]["workloads"]) == 1


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_values(metric):
    assert read(metric, reduce_spans(more()), 2e-3) == pytest.approx(SPAN_METRICS[metric][1])


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_reads_nothing_without_its_span(metric):
    name = SPAN_METRICS[metric][0]
    assert read(metric, None, 2e-3, trace=False) is None        # no trace
    assert read(metric, None, 2e-3) is None                     # a trace without spans
    without = [e for e in more() if e.get("name") != name]
    assert read(metric, reduce_spans(without), 2e-3) is None    # the span never opened
    no_device = [e for e in more() if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert read(metric, reduce_spans(no_device), 2e-3) is None  # no device work (the CPU)


def test_traced_window_sets_its_spans(tmp_path):
    tracer = Tracer(True, tmp_path)
    with tracer.window(), torch.profiler.record_function("vfx_bench.call"):
        with torch.profiler.record_function("seq2gene.forward"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with torch.profiler.record_function("sweep.wait_build"):
            pass
    t = tracer.trace
    assert t.spans.count == {"seq2gene.forward": 1, "sweep.wait_build": 1}
    assert set(t.spans.idle_s) == {"seq2gene.forward", "sweep.wait_build"}
    assert t.window_s > 0 and list(tmp_path.iterdir()) == []  # the trace file read once, gone
