"""The port's program spans (``utils/profiling.span``) on the CPU.

Under ``torch.profiler`` a tiny forward, a genome-wide sweep on the sweeps'
genome and a ``fit`` of two steps mark their stages as ``record_function``
ranges with fixed names, nested as the program runs them; the sweep's build
pool shows its spans under ``device_trace``, which records every thread.
With no profiler running a span calls no ``record_function`` and the
``StageTimer`` totals are kept as before; an exported forward holds no
profiler op, with a profiler running or not.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.test_model_smoke import tiny_batch, tiny_config
from tests.test_torch_train import _toy_shards
from tests.test_torch_vep_host import _port_sources
from tests.test_torch_vep_model import (  # noqa: F401  (fixtures)
    _jax_native_loaded,
    _no_remote_fetch,
    model,
)
from tests.torch_port_helpers import port_batch, port_config
from variantformer_tpu_torch.api import sweeps
from variantformer_tpu_torch.api.serving import export_forward
from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
from variantformer_tpu_torch.models.init import init_seq2gene
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward
from variantformer_tpu_torch.train.loop import fit, seq2gene_shard_batches
from variantformer_tpu_torch.train.optimizer import make_optimizer
from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step
from variantformer_tpu_torch.utils import profiling
from variantformer_tpu_torch.utils.profiling import StageTimer, device_trace

STAGES = ["seq2gene.window_encoder", "seq2gene.maps", "seq2gene.cre_stack",
          "seq2gene.gene_stack", "seq2gene.heads"]
PREFIXES = ("seq2gene.", "sweep.", "scan.", "train.", "fit.")


def _spans(trace_file) -> list[tuple]:
    """The program's spans of a Chrome trace: (start, end, name, tid), by start."""
    events = json.loads(open(trace_file).read())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["tid"])
                  for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIXES))


def _profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _spans(path)


def _inside(spans, outer) -> list[str]:
    """The names of the spans on ``outer``'s thread inside it, by start."""
    a, b, _, tid = outer
    return [s[2] for s in spans if s is not outer and s[3] == tid and a <= s[0] and s[1] <= b]


def _children(spans, outer) -> list[str]:
    """The spans directly inside ``outer``, by start."""
    inner = [s for s in spans if s is not outer and s[3] == outer[3]
             and outer[0] <= s[0] and s[1] <= outer[1]]
    return [s[2] for s in inner
            if not any(o is not s and o[0] <= s[0] and s[1] <= o[1] for o in inner)]


@pytest.fixture(scope="module")
def tiny():
    cfg = port_config(tiny_config())
    batch = port_batch(tiny_batch(np.random.default_rng(0)))
    return cfg, init_seq2gene(cfg, 0, device="cpu"), batch


def test_forward_spans_its_five_stages_in_order(tiny, tmp_path):
    cfg, params, batch = tiny
    with torch.no_grad():
        spans = _profiled(lambda: seq2gene_forward(params, batch, cfg), tmp_path)
    forward = [s for s in spans if s[2] == "seq2gene.forward"]
    assert len(forward) == 1
    assert _children(spans, forward[0]) == STAGES
    assert {s[2] for s in spans} == {"seq2gene.forward", *STAGES}


@pytest.fixture()
def sweep_proc(fixture_env, model):  # noqa: F811
    cfg, params = model
    proc = VCFProcessor(sources=_port_sources(fixture_env), config=port_config(cfg),
                        device="cpu")
    proc.set_params(params)
    return proc


def test_genome_wide_spans_main_thread_and_build_pool(fixture_env, sweep_proc,  # noqa: F811
                                                      tmp_path):
    stats = {}
    with device_trace(str(tmp_path)) as prof:
        sweeps.genome_wide_expression(sweep_proc, fixture_env["vcf"], tissues=["tissue0"],
                                      batch_size=1, stats=stats)
    spans = _spans(prof.trace_file)
    main = threading.get_native_id()
    on_main = {s[2] for s in spans if s[3] == main}
    assert {"sweep.wait_build", "sweep.pack", "sweep.dispatch", "sweep.device_sync",
            "seq2gene.forward"} <= on_main
    assert "sweep.host_build" not in on_main
    builds = [s for s in spans if s[2] == "sweep.host_build"]
    assert len(builds) == stats["stages"]["host_build"]["count"] == 2
    # every forward runs inside a dispatch on the main thread
    for d in (s for s in spans if s[2] == "sweep.dispatch"):
        assert _inside(spans, d)[:1] == ["seq2gene.forward"]
    for name in ("wait_build", "pack", "dispatch", "device_sync"):
        assert sum(s[2] == f"sweep.{name}" for s in spans) == stats["stages"][name]["count"]


def test_fit_spans_train_step_parts_and_feed(tmp_path):
    _toy_shards(tmp_path, n=4)
    cfg = port_config(tiny_config())
    params = init_seq2gene(cfg, 0, device="cpu")
    opt = make_optimizer(params, learning_rate=1e-3, train_gene_tokenizer=True)
    step = make_seq2gene_train_step(cfg, opt, freeze_tokenizers=True, train_gene_tokenizer=True)
    batches = seq2gene_shard_batches(tmp_path, [0, 1, 2], batch_size=2, device="cpu")
    result = []
    spans = _profiled(lambda: result.append(fit(TrainState(params, opt, 0), step, batches)),
                      tmp_path)
    assert result[0].state.step == 2
    steps = [s for s in spans if s[2] == "train.step"]
    assert len(steps) == 2
    for s in steps:
        assert _children(spans, s) == ["train.forward", "train.backward", "train.optimizer"]
        assert "seq2gene.forward" in _inside(spans, s)
    # one feed span before each step, and the one that finds the epoch done
    top = [s[2] for s in spans if s[2] in ("fit.next_batch", "train.step")]
    assert top == ["fit.next_batch", "train.step"] * 2 + ["fit.next_batch"]


def test_spans_call_no_record_function_without_a_profiler(tiny, monkeypatch):
    cfg, params, batch = tiny
    calls = []
    real = torch.profiler.record_function

    def spy(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    timer = StageTimer("sweep")
    with torch.no_grad(), timer.stage("dispatch"):
        seq2gene_forward(params, batch, cfg)
    with timer.stage("dispatch"):
        pass
    assert calls == []
    assert timer.counts == {"dispatch": 2} and timer.totals["dispatch"] > 0
    assert profiling.span("seq2gene.forward") is profiling.span("train.step")
    # the same calls under a profiler open every span, each once
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad(), timer.stage("dispatch"):
        seq2gene_forward(params, batch, cfg)
    assert calls == ["sweep.dispatch", "seq2gene.forward", *STAGES]
    assert timer.counts == {"dispatch": 3}


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "under-a-profiler"])
def test_exported_forward_holds_no_profiler_op(tiny, tmp_path, profiled):
    cfg, params, batch = tiny
    path = tmp_path / "serving.pt2"
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            export_forward(cfg, params, batch, path, impl="xla", device="cpu")
    else:
        export_forward(cfg, params, batch, path, impl="xla", device="cpu")
    targets = {str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"}
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
