"""Subpackage of tt_irt_tpu_torch (see the package docstring)."""
