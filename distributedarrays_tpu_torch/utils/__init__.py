"""utils of the PyTorch port (JAX ``distributedarrays_tpu/utils/__init__.py``):
the checkpoint, debug, native and profiling modules, and ``save``, ``load``,
``OpTimer``, ``annotate`` and ``trace`` at the package's top."""
from . import checkpoint, debug, native, profiling  # noqa: F401
from .checkpoint import load, save
from .profiling import OpTimer, annotate, trace
