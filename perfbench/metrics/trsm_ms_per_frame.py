"""Device milliseconds of triangular solves (cuBLAS trsm / trsv) a bank
step.  Layer: the sparse posterior's predictions.  Nothing to read where
no triangular solve ran."""


def read(summary):
    from perfbench.yardstick import kind_of

    prof = summary["profile"]
    if summary["kind"] != "filter" or not prof["steps"]:
        return None
    s = sum(sec for name, (_, sec) in prof["kernels"].items()
            if kind_of(name) == "triangular solve")
    return 1e3 * s / prof["steps"] if s > 0 else None
