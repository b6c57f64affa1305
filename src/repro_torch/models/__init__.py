"""The transformer model substrate of the port: layers, ``TransformerLM`` and
the model API (``repro/models``'s counterpart; the SSM and Whisper families
are not ported yet)."""
