"""Distribution layer on ``torch.distributed``: meshes, a launcher of
ranks, sharded training, sharded filter banks and row-sharded predictions.

Counterpart of ``gpmdm_tpu/parallel``, less ``count_collectives_jaxpr``
(torch has no jaxpr; ``count_collectives`` counts a real run instead).
"""

from .dist_chol import chol_rowblock, tri_solve_lower_rowblock, y_nll_dist
from .inspect import COLLECTIVE_PRIMS, count_collectives
from .launch import init_distributed, launch, shutdown
from .mesh import make_mesh, make_train_mesh, replicated, round_up
from .pf_bank import (
    gather_outputs,
    pf_scan_bank_sharded,
    pf_scan_bank_sharded_masked,
    shard_bank_state,
)
from .sharded import (
    ShardedTrainContext,
    make_context,
    make_sharded_update_step,
    nll_sharded,
    pad_Y,
    train_adam_sharded,
)
from .sp_predict import predict_x_all_classes_rowsharded, predict_y_rowsharded

__all__ = [
    "COLLECTIVE_PRIMS",
    "count_collectives",
    "chol_rowblock",
    "tri_solve_lower_rowblock",
    "y_nll_dist",
    "make_mesh",
    "make_train_mesh",
    "replicated",
    "round_up",
    "gather_outputs",
    "pf_scan_bank_sharded",
    "pf_scan_bank_sharded_masked",
    "predict_y_rowsharded",
    "predict_x_all_classes_rowsharded",
    "shard_bank_state",
    "ShardedTrainContext",
    "make_context",
    "make_sharded_update_step",
    "nll_sharded",
    "pad_Y",
    "train_adam_sharded",
    "launch",
    "init_distributed",
    "shutdown",
]
