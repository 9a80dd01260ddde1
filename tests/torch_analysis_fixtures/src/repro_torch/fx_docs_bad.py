"""True-positive fixture for docs-citation: DESIGN.md §42 has no heading."""
