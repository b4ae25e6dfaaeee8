"""Config loading (YAML with ``_target_`` keys)."""
