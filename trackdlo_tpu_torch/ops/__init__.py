"""Per-frame numerics of the port; see the package docstring."""
