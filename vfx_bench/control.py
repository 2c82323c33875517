"""Readings for the limits of ``correct``: the program's over many seeds,
and the control's (the plain reference in float8 in the program's place).

    python3 -m vfx_bench.control --workload <cell> --seeds 1,2,3 --mode program|control
        [--seconds S] [--fault NAME] [--out FILE]

``program`` runs the cell as ``vfx_bench.run`` does, with a short window,
for each seed in one process; ``control`` runs the cell kind's control on
each seed; ``--fault`` plants one of ``faults.FAULTS`` under the
program's runs. One JSON line a seed, on standard output and appended to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

from vfx_bench import harness
from vfx_bench.faults import FAULTS, planted
from vfx_bench.run import cache_dirs, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", choices=FAULTS, help="program mode: plant this fault")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cache_dirs()
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "program":
            with planted(args.fault):
                line, _ = run_cell(cell, seed, args.seconds, False, args.device, t_start=t0)
            readings = {k: c["value"] for k, c in line["checks"].items()}
            extra = {"metrics": line["metrics"], "correct": line["correct"]}
        else:
            scratch = Path(tempfile.mkdtemp(prefix="vfx_bench_"))
            try:
                run = harness.Run(cell=cell, seed=seed, seconds=args.seconds,
                                  device=args.device, scratch=scratch)
                readings = harness.kind_module(cell.kind).control(run)
            finally:
                shutil.rmtree(scratch, ignore_errors=True)
            extra = {}
        rec = {"workload": args.workload, "mode": args.mode, "fault": args.fault, "seed": seed,
               "readings": readings,
               "seconds": time.perf_counter() - t0, **extra}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
