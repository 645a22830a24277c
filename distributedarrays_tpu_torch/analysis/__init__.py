"""Static analysis (dalint) and runtime SPMD-divergence checking over the
port's sources.

PyTorch counterpart of ``distributedarrays_tpu/analysis`` (stdlib-only:
the port keeps its own copy of each module):

- **dalint** (``engine``/``rules``/``cache``): the AST linter with JAX's
  stable rule codes DAL001-DAL012 and DAL100, per-line ``# dalint:
  disable=CODE`` suppressions, the content-hash cache
  (``build/dalint_torch_cache.json``) and the command line
  (``python -m distributedarrays_tpu_torch.analysis lint``), its framework
  rules retargeted to the port's rank sources, collectives, traced
  regions and device moves (``rules.PORT_SCOPE``).  DAL008/DAL009
  delegate to ``locks`` (the ``locks`` verb), DAL010-DAL012 to
  ``effects`` over ``callgraph``, the static SPMD divergence prover (the
  ``verify-spmd`` and ``effects`` verbs).
- **divergence**: the opt-in runtime checker
  (``DA_TPU_CHECK_DIVERGENCE=1``).

- **protocol**: the explicit-state model checker of the port's
  cross-process protocols (``ops/ring_schedules.py``: host-driven
  launches with CUDA-IPC slot stores, stream syncs, handle publications
  and store barriers, in place of JAX's Pallas RDMA semaphores and
  credits), with its mutation harness (the ``verify-protocols`` verb).
"""

from . import divergence, protocol
from .engine import (Finding, lint_source, lint_file, lint_paths,
                     iter_python_files, parse_suppressions,
                     unused_suppressions)
from .rules import PORT_SCOPE, RULES, Rule
from .divergence import (CollectiveDivergenceError, DivergenceChecker,
                         checking, payload_signature)
from .callgraph import CallGraph, Binding, FuncDef
from .effects import (analyze_paths as analyze_effects,
                      analyze_sources as analyze_effect_sources,
                      signature_for, render as render_signature,
                      EffectReport)

__all__ = [
    "divergence", "protocol",
    "Finding", "lint_source", "lint_file", "lint_paths",
    "iter_python_files", "parse_suppressions", "unused_suppressions",
    "RULES", "Rule", "PORT_SCOPE",
    "CollectiveDivergenceError", "DivergenceChecker", "checking",
    "payload_signature",
    "CallGraph", "Binding", "FuncDef",
    "analyze_effects", "analyze_effect_sources", "signature_for",
    "render_signature", "EffectReport",
]
