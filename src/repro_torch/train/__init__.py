"""train subsystem."""
