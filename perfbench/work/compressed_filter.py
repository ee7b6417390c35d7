"""Work of a bank step through an exact model's compressed posterior (K3
and the glue; no K1, K2)."""

from perfbench import yardstick as ys


def model_flops(cfg, mix, asset):
    return ys.compressed_filter_flops(mix["streams"], mix["particles"], cfg["d"], cfg["D"],
                                      cfg["n_classes"], cfg["n_max"], cfg["Ny"], cfg["rank_y"],
                                      cfg["rank_x"], cfg["dyn_back_step"])


def kernel_work(cfg, mix):
    return {"k3": ys.rank_work(mix["streams"], mix["particles"])}
