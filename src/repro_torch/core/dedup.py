# Port copy of src/repro/core/dedup.py: host-only, logic unchanged.
"""Deduplication at four granularities (paper §3.5, §4.1, §5.3.1).

* FileDedup   — sha256 over whole files; catches exact re-uploads (Table 2).
* TensorDedup — the paper's contribution: hash each tensor independently
  (boundaries come free from the safetensors header), ~the reduction ratio of
  CDC at 3 orders of magnitude less metadata, embarrassingly parallel, and —
  crucially — alignment-preserving, so unique tensors remain compressible by
  model-aware compressors (the zLLM synergy).
* LayerDedup  — coarser: hash per layer group (all tensors with the same
  layer index); one changed tensor breaks the whole layer (Table 5).
* ChunkDedup  — the CDC baseline lives in ``repro_torch.core.chunkdedup``.

Each engine exposes ``scan_file`` returning (hits, misses) against its global
index plus byte-accurate accounting, so the benchmarks can replay Table 5.

Interplay with the device-batched encode path: dedup decisions run in the
pipeline's *serial* decision stage, strictly before any codec work, and are
pure functions of the tensor hashes — so they are identical no matter which
``ArrayBackend`` the store was built with, and a dedup'd tensor never reaches
the batched kernel launches at all (its record carries zero payload). The
hash counts these engines report are therefore backend-invariant.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.formats.safetensors import SafetensorsFile, TensorInfo

__all__ = ["sha256_bytes", "sha256_file", "FileDedup", "TensorDedup", "LayerDedup",
           "DedupStats"]

# FileDedup streams whole files through sha256 in fixed chunks so peak RSS
# stays flat on multi-GB shards (the hash state is 64 B regardless of input).
HASH_CHUNK_BYTES = 8 << 20


def sha256_bytes(data) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str, chunk_bytes: int = HASH_CHUNK_BYTES) -> Tuple[str, int]:
    """Streaming whole-file sha256. Returns (hexdigest, bytes hashed)."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


@dataclass
class DedupStats:
    """Byte accounting for one dedup engine over an ingested corpus."""

    total_bytes: int = 0
    unique_bytes: int = 0
    n_units: int = 0
    n_unique: int = 0
    unit_sizes: List[int] = field(default_factory=list)

    @property
    def saved_bytes(self) -> int:
        return self.total_bytes - self.unique_bytes

    @property
    def reduction_ratio(self) -> float:
        return self.saved_bytes / self.total_bytes if self.total_bytes else 0.0

    def metadata_bytes(self, per_entry: int = 64) -> int:
        """Index footprint (paper assumes 64 B/entry: hash, location, refcount)."""
        return self.n_unique * per_entry

    def observe(self, size: int, is_new: bool):
        self.total_bytes += size
        self.n_units += 1
        if is_new:
            self.unique_bytes += size
            self.n_unique += 1
            self.unit_sizes.append(size)


class FileDedup:
    def __init__(self):
        self.index: Dict[str, str] = {}     # hash -> first location
        self.stats = DedupStats()

    def scan_file(self, path: str, location: Optional[str] = None) -> Tuple[str, bool]:
        digest, size = sha256_file(path)
        return digest, self.observe(digest, size, location or path)

    def observe(self, digest: str, size: int, location: Optional[str] = None) -> bool:
        """Register a whole-file hash computed elsewhere (the pipelined ingest
        engine hashes upload N+1 on a worker thread while upload N encodes;
        only this registration runs on the serial decision stage). Returns
        True when the hash is new to the index."""
        is_new = digest not in self.index
        if is_new:
            self.index[digest] = location or digest
        self.stats.observe(size, is_new)
        return is_new

    def forget(self, digest: str) -> None:
        """Drop a hash whose last copy was deleted, so a future identical
        upload is stored fresh instead of dedup'd against a dead entry.
        Cumulative ingest stats are left untouched."""
        self.index.pop(digest, None)


class TensorDedup:
    """Per-tensor content hashing over the safetensors mmap (zero-copy).

    ``hash_calls`` counts every tensor hash computed through this engine
    (thread-safe — the parallel ingest pool hashes concurrently); the
    pipeline tests use it to assert a base model is hashed exactly once no
    matter how many fine-tunes are ingested against it.
    """

    def __init__(self):
        self.index: Dict[str, str] = {}     # tensor hash -> location "repo/file:tensor"
        self.stats = DedupStats()
        self.hash_calls = 0
        self._counter_lock = threading.Lock()

    def hash_tensor(self, raw: memoryview) -> str:
        with self._counter_lock:
            self.hash_calls += 1
        return sha256_bytes(raw)

    def forget(self, digest: str) -> None:
        """Drop a tensor hash whose backing container was garbage-collected
        (cumulative stats stay; the pipeline also scrubs tensor_locations)."""
        self.index.pop(digest, None)

    def scan_file(self, path: str, location: Optional[str] = None):
        """Returns [(TensorInfo, hash, is_new)] in serialization order."""
        out = []
        loc = location or path
        with SafetensorsFile(path) as sf:
            for ti in sf.infos:
                digest = self.hash_tensor(sf.tensor_bytes(ti.name))
                is_new = digest not in self.index
                if is_new:
                    self.index[digest] = f"{loc}:{ti.name}"
                self.stats.observe(ti.nbytes, is_new)
                out.append((ti, digest, is_new))
        return out


_LAYER_RE = re.compile(r"(?:^|\.)(?:layers?|blocks?|h)[._](\d+)[._]")


def layer_key(tensor_name: str) -> str:
    """Group tensors into layers by the layer index in their name; tensors
    without one (embeddings, final norm) each form their own group."""
    m = _LAYER_RE.search(tensor_name)
    if m:
        return f"layer.{m.group(1)}"
    return f"top.{tensor_name}"


class LayerDedup:
    def __init__(self):
        self.index: Dict[str, str] = {}
        self.stats = DedupStats()

    def scan_file(self, path: str, location: Optional[str] = None):
        loc = location or path
        groups: Dict[str, List[TensorInfo]] = {}
        out = []
        with SafetensorsFile(path) as sf:
            for ti in sf.infos:
                groups.setdefault(layer_key(ti.name), []).append(ti)
            for key, infos in groups.items():
                h = hashlib.sha256()
                size = 0
                for ti in infos:
                    h.update(sf.tensor_bytes(ti.name))
                    size += ti.nbytes
                digest = h.hexdigest()
                is_new = digest not in self.index
                if is_new:
                    self.index[digest] = f"{loc}:{key}"
                self.stats.observe(size, is_new)
                out.append((key, digest, is_new, size))
        return out
