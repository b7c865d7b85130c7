"""Subpackage of cld_tpu_torch."""
