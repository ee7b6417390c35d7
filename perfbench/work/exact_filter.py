"""Work of a bank step through the exact posterior (K1, K2, K3 and the glue)."""

from perfbench import yardstick as ys


def model_flops(cfg, mix, asset):
    return ys.exact_filter_flops(mix["streams"], mix["particles"], cfg["d"], cfg["D"],
                                 cfg["n_classes"], cfg["n_max"], cfg["Ny"], cfg["dyn_back_step"])


def kernel_work(cfg, mix):
    """(flops, bytes) of each hand-written kernel's call in one bank step."""
    B, Pb, d = mix["streams"], mix["particles"], cfg["d"]
    P = B * Pb
    return {"k1": ys.posterior_work(cfg["n_max"], P, d * cfg["dyn_back_step"], d, True,
                                    cfg["n_classes"]),
            "k2": ys.obs_work(cfg["Ny"], P, d, cfg["D"], B),
            "k3": ys.rank_work(B, Pb)}
