"""The port's counterpart of tests/test_codecs.py: the codec registry, the
per-thread codec runtime, the deprecation shims and the ``BitXCodec`` facade
of ``repro_torch.core`` (see ``test_torch_lifecycle.Suite``)."""

from test_torch_lifecycle import Suite

globals().update(Suite("test_codecs").tests())
