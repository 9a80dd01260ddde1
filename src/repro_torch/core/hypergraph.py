"""The older home of the reordering helpers (copy of ``repro.core.hypergraph``).

``degree_reorder``, ``reorder_tensor`` and ``mode_trace`` keep their
signatures; they live in ``repro_torch.reorder``.  Import from there in
new code.
"""

from repro_torch.reorder.strategies import degree_reorder, mode_trace, reorder_tensor

__all__ = ["degree_reorder", "reorder_tensor", "mode_trace"]
