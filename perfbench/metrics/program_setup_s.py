"""The program's part of ``setup_s``: the inclusive seconds of its spans
``io.load_model`` (the checkpoint read), ``pf.resolve_posterior`` (the
posterior deployed) and ``ops.library`` (the kernels' build or load,
once a process), none of which runs inside another.  The rest of
``setup_s`` is the benchmark's: imports, the CUDA context, the traffic,
the warm-up.  Layer: the program's set-up.  Nothing to read where the
program keeps no such span."""

SPANS = ("io.load_model", "pf.resolve_posterior", "ops.library")


def read(summary):
    if summary["kind"] != "filter":
        return None
    try:
        from gpmdm_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    spans = snapshot()["spans"]
    found = [spans[name]["incl_ns"] for name in SPANS if name in spans]
    return sum(found) * 1e-9 if found else None
