"""True-negative fixture for docs-citation: DESIGN.md §1 resolves."""
