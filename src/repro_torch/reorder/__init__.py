"""Nonzero orderings, the scheduling axis of sparse MTTKRP.

The counterpart of ``repro.reorder``: the strategies (``lex``,
``degree``, ``secondary-sort``, ``blocked``) as nonzero execution
permutations (``nonzero_order``) and mode relabelings
(``reorder_tensor``).  They thread through
``build_mttkrp_plan(ordering=...)``, ``mttkrp(ordering=...)`` and the
fused executor.  The ordering benchmark (``repro.reorder.bench``) is not
ported yet.
"""

from repro_torch.reorder.strategies import (
    DEFAULT_BLOCK_ROWS,
    ORDERINGS,
    ROW_CONTIGUOUS_ORDERINGS,
    apply_nonzero_order,
    degree_reorder,
    mode_trace,
    nonzero_order,
    nonzero_order_tensor,
    prepare_execution,
    reorder_tensor,
    trace_view,
)

__all__ = [
    "DEFAULT_BLOCK_ROWS",
    "ORDERINGS",
    "ROW_CONTIGUOUS_ORDERINGS",
    "apply_nonzero_order",
    "degree_reorder",
    "mode_trace",
    "nonzero_order",
    "nonzero_order_tensor",
    "prepare_execution",
    "reorder_tensor",
    "trace_view",
]
