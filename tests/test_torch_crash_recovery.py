"""The port's counterpart of tests/test_crash_recovery.py: compact() and the
incremental gc killed at every fault point of the port's store
(``TorchBackend(device="cpu")``), the store reopened from disk and repaired,
each case held to the reference's retrievals and containers (see
``test_torch_lifecycle.Suite``)."""

from test_torch_lifecycle import Suite

globals().update(Suite("test_crash_recovery").tests())
