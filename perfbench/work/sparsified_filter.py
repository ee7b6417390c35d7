"""Work of a bank step through an exact model's SGPR distillation: a sparse
model's (K3 and the glue; no K1, K2), since the FLOPs count the SGPR
prediction's mathematics, whichever variance path the program takes."""

from perfbench.work.sparse_filter import kernel_work, model_flops  # noqa: F401
