"""Storage core of the port: dedup, BitX/ZipNN codecs, clustering, lifecycle and
the ``ZLLMStore`` pipeline, with the array math on :class:`repro_torch.core.bitx.TorchBackend`."""
