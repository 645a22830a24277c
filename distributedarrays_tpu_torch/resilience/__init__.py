"""resilience of the PyTorch port: the failure-domain topology so far."""

from . import domains  # noqa: F401
from .domains import DomainTopology, buddy_map, majority_side
