"""The port's checker catalog: importing this package fills the registry.

Each module defines one checker and registers it with
:func:`repro_torch.analysis.core.register`.  ``default_checkers()`` imports
this package, so adding a checker is: write the module, import it here,
add a violating fixture and a clean twin under
``tests/torch_analysis_fixtures/``.
"""

from repro_torch.analysis.checkers import (  # noqa: F401
    carry_init,
    docs_citation,
    kernel_contract,
    kwarg_threading,
    memo_keys,
    shared_state,
    stale_suppression,
    traffic_drift,
)
