"""repro_torch.analysis: the port's own contract gate.

The counterpart of the JAX package's ``repro.analysis``, kept apart from it
(the port imports nothing of ``repro``): an AST checker framework
(``core``) with the generic contracts of the JAX gate, aimed at the port
(memo-key completeness, ``device=``/``ordering=`` threading through
wrappers, shared state in ``serve/`` and ``dse/``, DESIGN.md citations,
stale suppressions), and the split MTTKRP kernel's contracts, which the
JAX gate proves from Pallas source and the port proves on the kernel's
CPU replay (``kernel-contract``, ``carry-init``, ``traffic-model-drift``;
the card's half is the kernel's audit build, ``census``).

Entry points: ``python -m repro_torch.analysis`` (the gate: exit 1 on any
active finding), or

    from repro_torch.analysis import run_analysis
    report = run_analysis(Path("."))
"""

from repro_torch.analysis.core import (
    Checker,
    Finding,
    Report,
    default_checkers,
    register,
    run_analysis,
)

__all__ = ["Checker", "Finding", "Report", "default_checkers", "register", "run_analysis"]
