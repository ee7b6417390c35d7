"""Kernels launched a bank step (one frame of every stream): every device
kernel in the profiled stretch, copies and fills left out, over its bank
steps.  Layer: the filter step (``pf_step_bank``)."""


def read(summary):
    from perfbench.trace import is_kernel

    prof = summary["profile"]
    if summary["kind"] != "filter" or not prof["kernels"] or not prof["steps"]:
        return None
    return sum(n for name, (n, _) in prof["kernels"].items() if is_kernel(name)) / prof["steps"]
