"""95th percentile, over every bank step of the measured window, of the
time from handing in one frame of every stream to having that frame's
class readouts on the host (closed loop: the service time a live tracker
feels).  Host clock, one step at a time.  Layer: the entry point's live
loop around ``pf_step_bank``."""


def read(summary):
    return summary["timed"].get("frame_p95_ms")
