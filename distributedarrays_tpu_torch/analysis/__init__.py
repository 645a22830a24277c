"""Runtime analyses of the port: the SPMD collective-divergence checker.

PyTorch counterpart of ``distributedarrays_tpu/analysis/divergence.py``;
the JAX package's static checker (``dalint``) and its protocol model are
not ported yet (ROADMAP queue A).
"""

from . import divergence
from .divergence import (CollectiveDivergenceError, DivergenceChecker,
                         checking, payload_signature)

__all__ = ["divergence", "CollectiveDivergenceError", "DivergenceChecker",
           "checking", "payload_signature"]
