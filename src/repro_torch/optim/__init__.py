"""optim subsystem."""
