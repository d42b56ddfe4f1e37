"""photon-lint: static AST invariant checkers + runtime guards.

Counterpart of ``photon_ml_tpu/analysis``.  The port's contracts are
encoded twice:

- ``checkers``: AST rules over the whole ``photon_ml_torch`` package
  (thread/lock discipline, unbounded waits, swallowed exceptions,
  accumulator dtype, env hygiene, clocks, metric names, collectives in
  host branches, slow-test markers), run by
  ``python -m photon_ml_torch.analysis`` and enforced in tier-1 by
  ``tests/test_torch_analysis.py::test_port_clean``.
- ``guards``: runtime context managers (kernel builds counted through
  ``kernels._build``'s listener, synchronizations counted through
  ``torch.cuda.set_sync_debug_mode``) with budget assertions.

The reference's ``tracer_leak_guard`` and its three jit/tracer rules
have no counterpart: eager PyTorch has no jit executables, no tracers
and no ``lax.while_loop`` carry (see ``checkers.NOT_PORTED``).
"""

from photon_ml_torch.analysis.checkers import (  # noqa: F401
    RULES,
    Violation,
    check_source,
    run_checks,
)
from photon_ml_torch.analysis.guards import (  # noqa: F401
    count_compiles,
    no_implicit_transfers,
)
