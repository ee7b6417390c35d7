"""K2's share of its roofline: the least time of one call at the cell's
shapes (its operations at the fp32 peak or its bytes at the HBM rate,
whichever is longer; ``yardstick.obs_work``) over K2's device
time a bank step in the profiled stretch.  Layer: the kernels
(``ops/csrc/gp_posterior.cu`` via ``ops/gp_posterior.py``).  Nothing to read
where K2 did not run."""


def read(summary):
    from perfbench.yardstick import KERNEL_NAMES, bound

    prof, work = summary["profile"], summary["work"]
    if "k2" not in work or not prof["steps"]:
        return None
    s = sum(sec for name, (_, sec) in prof["kernels"].items() if KERNEL_NAMES["k2"].search(name))
    if s <= 0:
        return None
    least_ms, _ = bound(*work["k2"], summary["peaks"])
    return 100.0 * least_ms / (1e3 * s / prof["steps"])
