"""Readings that set a cell's limits, on the card, in one process:

    python3 perfbench/control.py --workload <cell> --seconds <s> [--control-seconds <s>] \\
        --program-seeds 1 2 ... --control-seeds 7 8 9 [--faults stale half altered]

For each program seed, one run of the cell as the benchmark makes it; for
each control seed, the same run with the reference at TF32 in the
program's place (``faults.py``); with ``--faults``, each fault on the
control seeds.  Prints one JSON line a run: the kind, the seed, the
numbers the check compares, the posterior the program deployed and the
run's peak device memory.  The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the window of the control's and the faults' runs (default: --seconds)")
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from perfbench import bank, faults, harness, traffic

    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    cfg, asset, _ = harness.load_config(cell["config"])
    T = bank.transition(cfg, traffic.load_mix(cell["traffic"]))
    runs = [("program", s) for s in args.program_seeds]
    runs += [("control", s) for s in args.control_seeds]
    runs += [(k, s) for k in args.faults for s in args.control_seeds]
    for kind, seed in runs:
        t0 = time.perf_counter()
        secs = args.seconds if kind == "program" else (args.control_seconds or args.seconds)
        wrap = None if kind == "program" else faults.filter_wrap(kind, cfg, asset, T, "cuda")
        torch.cuda.reset_peak_memory_stats()
        out = harness.run_cell(args.workload, seed, secs, False, "cuda", t0, wrap=wrap,
                               spec=spec)
        nums = {k: v for k, v in out["numbers"].items() if isinstance(v, (int, float))}
        print(json.dumps({"kind": kind, "seed": seed, "correct": out["correct"],
                          "numbers": nums, "posterior": out["posterior"],
                          "memory_peak_bytes": out["memory_peak_bytes"],
                          "timed": out["timed"], "e2e": out["e2e"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
