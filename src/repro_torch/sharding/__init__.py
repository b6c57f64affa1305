"""Logical-axis parameter specs (``repro/sharding``'s counterpart, as plain data)."""
