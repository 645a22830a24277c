"""Data-parallel training over DArrays: ``Trainer`` with ZeRO-1 sharded
state and its gradient sync on the collective kernels (K10, K12), the
flat-vector optimizers and the training tasks.  PyTorch counterpart of
``distributedarrays_tpu/train/`` without its runtime tier (checkpoints,
recovery, elastic relayout, fault sites, telemetry)."""

from .optim import Optimizer, adam, sgd
from .tasks import TrainTask, mlp_task, transformer_task
from .trainer import StragglerDetector, Trainer, fit_result, tree_leaves

__all__ = [
    "Trainer", "StragglerDetector", "fit_result", "tree_leaves",
    "Optimizer", "adam", "sgd",
    "TrainTask", "mlp_task", "transformer_task",
]
