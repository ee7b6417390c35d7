"""The device's idle share of a bank step: 1 - (device-busy seconds a
step in the profiled stretch) / (wall seconds a step in the untraced
window).  The busy time comes from the trace (the union of device
operations' intervals); the wall time a step from the same run's window
without the profiler, which inflates the host's side of a
launch-heavy stretch and would overstate idle time (one H100)."""


def read(summary):
    prof, timed = summary["profile"], summary["timed"]
    if summary["kind"] != "filter" or not prof["steps"] or prof["busy_s"] is None:
        return None
    if not timed["steps"] or timed["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - (prof["busy_s"] / prof["steps"]) / (timed["seconds"] / timed["steps"]))
