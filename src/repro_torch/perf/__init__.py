"""Performance models of the port (``repro.perf``'s analytic part)."""
