"""The whole step's share of the card's fp32 peak: the model FLOPs of one
bank step (the exact or SGPR posteriors, the glue), times the steps of the measured
stretch, over its seconds and 67 TFLOP/s.  Counted from shapes
(``perfbench/yardstick.py``), so it bounds any kernel's gain."""


def read(summary):
    if summary["kind"] != "filter":
        return None
    timed = summary["timed"]
    if not timed["steps"] or timed["seconds"] <= 0:
        return None
    rate = summary["model_flops_per_step"] * timed["steps"] / timed["seconds"]
    return 100.0 * rate / summary["peaks"][0]
