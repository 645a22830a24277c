"""Data-parallel training over DArrays: ``Trainer`` with ZeRO-1 sharded
state and its gradient sync on the collective kernels (K10, K12), its
runtime tier (checkpoints, resume, recovery, elastic relayout, fault
sites, the straggler probe, telemetry), the flat-vector optimizers and
the training tasks.  PyTorch counterpart of
``distributedarrays_tpu/train/``."""

from .optim import Optimizer, adam, sgd
from .tasks import TrainTask, mlp_task, transformer_task
from .trainer import (DeadRankError, StragglerDetector, Trainer, fit_result,
                      tree_leaves)

__all__ = [
    "Trainer", "StragglerDetector", "DeadRankError", "fit_result",
    "tree_leaves",
    "Optimizer", "adam", "sgd",
    "TrainTask", "mlp_task", "transformer_task",
]
