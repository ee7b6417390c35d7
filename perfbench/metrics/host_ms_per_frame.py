"""The host-clock time of one bank step: the median of the program's
``pf.step`` span (``gpmdm_tpu_torch.utils.profiling``) over the last 1,024
bank steps it timed, in ms.  It is the time ``pf_step_bank`` holds the
host, any wait for the card inside it included: not the host's enqueue
time alone while the step waits for the card, and that time alone once
it no longer does, so a drop from a wait taken out is not less host work.
The span's record runs on the host clock and pauses while a profiler
records, so on a traced run it ends with the untraced window.  Layer: the
filter step on the host clock (``pf_step_bank``).  Nothing to read where
the program keeps no such span."""

import statistics


def read(summary):
    if summary["kind"] != "filter":
        return None
    try:
        from gpmdm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    rec = snapshot()["spans"].get("pf.step")
    if not rec or not rec["ring"]:
        return None
    return statistics.median(rec["ring"]) * 1e-6
