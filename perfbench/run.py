"""Run one cell of the benchmark of ``gpmdm_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) that the cell
asks for.  Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number that decides ``correct`` beside its limit, which also end standard
error.  Exits non-zero and prints no result without the cards, or if JAX
or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def power_limit() -> str:
    """The card's name and power limit from nvidia-smi, or why not."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    # one host thread for the program's CPU-side tensor work: the card's
    # host shares its cores, and idle worker threads only add noise
    torch.set_num_threads(1)

    spec = harness.load_spec()
    cell = harness.cell_entry(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); found {n}",
              file=sys.stderr)
        return 2
    bad_refs = harness.check_reference_imports()
    if bad_refs:
        print(f"perfbench: perfbench/reference imports {bad_refs}", file=sys.stderr)
        return 3
    print(f"perfbench: card {power_limit()}; peaks fp32 67 TFLOP/s, HBM 3.35 TB/s (H100 SXM, "
          "700 W)", file=sys.stderr, flush=True)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0,
                           spec=spec)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    line = harness.result_line(out, "cuda", cell["chips"], bool(args.trace))
    numbers = {k: harness.nan_to_none(v) for k, v in out["numbers"].items()
               if isinstance(v, (int, float))}
    print(f"perfbench: posterior {out.get('posterior', '-')}; timed {out['timed']}; "
          f"numbers {json.dumps(numbers)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
