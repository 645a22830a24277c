"""Fault tolerance: failure domains, deterministic fault injection, elastic
device sets, and a retrying executor with postmortem-driven verdicts.

PyTorch counterpart of ``distributedarrays_tpu/resilience`` (its
``__init__.py:28-33`` exports): :mod:`.domains` (the failure-domain
topology), :mod:`.faults` (the seeded chaos harness), :mod:`.elastic`
(the health ledger and the in-place re-layout onto survivors through the
reshard) and :mod:`.recovery` (bounded retry whose verdict decides the
path).
"""

from . import domains, elastic, faults, recovery  # noqa: F401
from .domains import DomainTopology, buddy_map, majority_side
from .elastic import ElasticDeviceSet, manager, relayout
from .faults import (FaultSpec, InjectedDeviceLoss, InjectedFault,
                     InjectedPartition)
from .recovery import (MinorityPartitionExit, RetryPolicy, classify,
                       fresh_mesh, resilient, run_with_recovery)

__all__ = [
    "faults", "elastic", "recovery", "domains",
    "FaultSpec", "InjectedFault", "InjectedDeviceLoss",
    "InjectedPartition",
    "DomainTopology", "buddy_map", "majority_side",
    "ElasticDeviceSet", "manager", "relayout",
    "RetryPolicy", "MinorityPartitionExit", "classify", "fresh_mesh",
    "resilient", "run_with_recovery",
]
