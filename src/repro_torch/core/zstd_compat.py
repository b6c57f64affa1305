# Port copy of src/repro/core/zstd_compat.py: host-only, logic unchanged.
"""Entropy-coder backend shim: `zstandard` when available, zlib otherwise.

The paper's engine uses zstd for the per-plane entropy stage. Some
deployment containers (including this one) ship without the `zstandard`
wheel, so every storage module imports the compressor through this shim
instead of `import zstandard as zstd` directly:

    from repro_torch.core import zstd_compat as zstd

* With `zstandard` installed the shim re-exports the real
  ``ZstdCompressor`` / ``ZstdDecompressor`` untouched (``BACKEND == "zstd"``).
* Without it, a zlib-backed stand-in implements the same one-shot
  ``compress(data)`` / ``decompress(frame)`` subset the storage layer uses.
  zstd levels (1..22) are mapped onto zlib levels (1..9).

Frames from the two backends are NOT interchangeable, so `.bitx`
containers record the backend that wrote them (``BitXWriter`` stamps the
top-level ``"backend"`` header key) and ``BitXReader`` refuses to decode
a container written by a backend other than the active one.

Thread-safety contract (identical for both backends): compressor and
decompressor *objects* must not be shared across threads mid-operation —
the storage layer gives each worker thread its own contexts
(`repro_torch.core.codecs.CodecRuntime` holds them in thread-local storage and
asserts owner-thread on every use). The module-level classes themselves
are safe to construct from any thread.
"""

from __future__ import annotations

import zlib

__all__ = ["ZstdCompressor", "ZstdDecompressor", "BACKEND", "HAVE_ZSTD"]

try:  # pragma: no cover - depends on container contents
    import zstandard as _zstd

    HAVE_ZSTD = True
    BACKEND = "zstd"
    ZstdCompressor = _zstd.ZstdCompressor
    ZstdDecompressor = _zstd.ZstdDecompressor
except ImportError:  # zlib fallback
    HAVE_ZSTD = False
    BACKEND = "zlib"

    def _map_level(level: int) -> int:
        """Map a zstd level (1..22, default 3) onto zlib's 1..9 range."""
        if level <= 0:
            return 6  # zlib default; zstd level 0 means "default" too
        return max(1, min(9, round(level * 9 / 22) or 1))

    class ZstdCompressor:
        """zlib-backed stand-in for ``zstandard.ZstdCompressor``.

        Accepts (and records) the ``threads`` argument for API parity;
        zlib has no internal threading, so parallelism comes from the
        storage engine's worker pool instead.
        """

        def __init__(self, level: int = 3, threads: int = 0, **_kw):
            self.level = level
            self.threads = threads
            self._zlevel = _map_level(level)

        def compress(self, data) -> bytes:
            return zlib.compress(data, self._zlevel)

    class ZstdDecompressor:
        """zlib-backed stand-in for ``zstandard.ZstdDecompressor``."""

        def decompress(self, frame, max_output_size: int = 0) -> bytes:
            return zlib.decompress(frame)
