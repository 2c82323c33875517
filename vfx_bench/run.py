"""One run of one benchmark cell of ``variantformer_tpu_torch`` on the card.

    python3 -m vfx_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (imports, the seeded inputs and
weights, the program's load and a warm-up of the cell's shapes, any kernel
build) is timed as ``setup_s``; then the cell's window runs for
``--seconds``; with ``--trace 1`` a traced sub-window of whole calls
follows and the cell's per-layer metrics are printed instead of its
end-to-end ones. After the window the program's state is freed and the
plain reference judges a seeded sample of what the window produced
(``correct``). The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. Exits 2 without printing a result where the card (or the cards the
cell asks for) is missing, 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from vfx_bench import harness  # noqa: E402
from vfx_bench.trace import Tracer  # noqa: E402


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout; the
    program's own nvcc and g++ outputs stay in its ``_build/``."""
    base = harness.ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float | None = None) -> tuple[dict, harness.Run]:
    """Set up, measure, trace and judge one run; (result line, its record)."""
    import torch

    t_start = T_START if t_start is None else t_start
    scratch = Path(tempfile.mkdtemp(prefix="vfx_bench_"))
    kind = harness.kind_module(cell.kind)
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, device=device, scratch=scratch)
    try:
        state = kind.setup(run)
        setup_s = time.perf_counter() - t_start
        cuda = device.startswith("cuda")
        if cuda:
            torch.cuda.synchronize()
        kind.window(run, state)
        if trace:
            tracer = Tracer(True, scratch)
            kind.traced(run, state, tracer)
            run.trace = tracer.trace
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        kind.release(run, state)
        del state
        if cuda:
            torch.cuda.empty_cache()
        kind.check(run)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    correct, checks = harness.judge(run.readings, cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = harness.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run.end_to_end["setup_s"] = setup_s
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = checks
    return line, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    counters = {k: v for k, v in run.counters.items() if isinstance(v, (int, float))}
    print(f"counters: {json.dumps(counters)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
