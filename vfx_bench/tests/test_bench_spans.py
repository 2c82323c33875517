"""``spans.reduce_spans`` on hand-made Chrome trace events (times in us)."""

import pytest

from vfx_bench.spans import readings, reduce_spans
from vfx_bench.trace import reduce_events

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
    r = readings("finetune", s, 1e-3, {"trace_calls": 1}, {})
    assert r["unattributed_share"] == pytest.approx(30 / 380)
    assert r["kernel_launched_share"] == pytest.approx(350 / 355)
    assert r["stage_share_of_forward"] == pytest.approx(1.0)
    assert r["launch_idle_frac.train"] == pytest.approx(0.55)


def test_busy_union_is_the_one_reduce_events_counts():
    ev = events() + [span("seq2gene.forward", MAIN, 1000, 10)]
    t = reduce_events(ev, window_s=1.01e-3)
    s = reduce_spans(ev + [span("fit.next_batch", MAIN, 0, 1010)])
    assert s.idle_s["fit.next_batch"] == pytest.approx(1010e-6 - t.busy_s)
    assert reduce_events(ev, 1.01e-3) == t  # the trace's own fields, as before


def test_forward_readings_per_traced_gene():
    s = reduce_spans(events())
    r = readings("forward", s, 1e-3, {"trace_calls": 2}, {"donors": 4})
    assert r["window_encoder_ms.genes"] == pytest.approx(100e-3 / 8)
    assert r["gene_stack_ms.genes"] == pytest.approx(150e-3 / 8)
    assert r["cre_stack_ms.genes"] == 0.0
    assert r["launch_idle_frac.genes"] == pytest.approx(0.35)
