# Port copy of src/repro/core/chunkdedup.py: host-only, logic unchanged.
"""FastCDC content-defined chunking — the ChunkDedup baseline (paper §2.1, §5.3.1).

Gear-hash rolling fingerprint with normalized chunking (FastCDC'16): two
masks (stricter before the normal point, looser after) centre the chunk-size
distribution; min/max clamps bound metadata. Defaults give ~64 KiB average
chunks (the paper's Table 5 corpus averages 0.085 MB).

Implementation note: the gear recurrence fp_i = (fp_{i-1} << 1) + G[b_i] over
uint64 is EXACTLY a 64-tap windowed sum fp_i = Σ_{j<64} G[b_{i-j}] << j
(shifts ≥ 64 overflow out), so we compute the fingerprint for the whole
buffer with 64 vectorized shifted adds and then walk cut points with
searchsorted — orders of magnitude faster than a per-byte Python loop. Unlike
textbook FastCDC the fingerprint window does not reset at chunk boundaries
(a windowed-gear variant); boundaries remain purely content-defined, which is
the property the dedup comparison needs.

This baseline is deliberately LLM-oblivious — it sees a byte stream — which
is exactly the property the paper critiques: chunk boundaries cut across
float/tensor boundaries, so post-dedup unique chunks are misaligned for
model-aware compressors.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.dedup import DedupStats

__all__ = ["FastCDC", "ChunkDedup", "GEAR", "gear_fingerprints"]

# 256-entry gear table, fixed seed for reproducibility
_rng = np.random.RandomState(0x5EED)
GEAR = _rng.randint(0, 2**64, size=256, dtype=np.uint64)


def gear_fingerprints(buf: np.ndarray) -> np.ndarray:
    """Exact gear fingerprint at every position (64-tap windowed form)."""
    g = GEAR[buf]
    fp = np.zeros(len(buf), np.uint64)
    for j in range(64):
        if j >= len(buf):
            break
        shifted = g[: len(buf) - j] << np.uint64(j)
        fp[j:] += shifted
    return fp


@dataclass(frozen=True)
class FastCDC:
    min_size: int = 16 * 1024
    avg_size: int = 64 * 1024
    max_size: int = 256 * 1024

    @property
    def mask_s(self) -> np.uint64:
        bits = int(np.log2(self.avg_size)) + 2
        return np.uint64((1 << bits) - 1)

    @property
    def mask_l(self) -> np.uint64:
        bits = int(np.log2(self.avg_size)) - 2
        return np.uint64((1 << bits) - 1)

    def chunks(self, data) -> Iterator[Tuple[int, int]]:
        buf = np.frombuffer(data, np.uint8)
        n = len(buf)
        if n == 0:
            return
        fp = gear_fingerprints(buf)
        cand_s = np.nonzero((fp & self.mask_s) == 0)[0]
        cand_l = np.nonzero((fp & self.mask_l) == 0)[0]
        start = 0
        while start < n:
            lo = start + self.min_size
            normal = start + self.avg_size
            hi = start + self.max_size
            cut = min(hi, n)
            # strict mask in [lo, normal)
            i = np.searchsorted(cand_s, lo)
            if i < len(cand_s) and cand_s[i] < min(normal, n):
                cut = int(cand_s[i]) + 1
            else:
                j = np.searchsorted(cand_l, normal)
                if j < len(cand_l) and cand_l[j] < min(hi, n):
                    cut = int(cand_l[j]) + 1
            yield start, min(cut, n)
            start = cut


class ChunkDedup:
    """CDC-based dedup over raw file bytes."""

    def __init__(self, cdc: Optional[FastCDC] = None):
        self.cdc = cdc or FastCDC()
        self.index: Dict[str, int] = {}
        self.stats = DedupStats()

    def scan_bytes(self, data, location: str = "") -> List[Tuple[int, int, str, bool]]:
        mv = memoryview(data)
        out = []
        for b, e in self.cdc.chunks(mv):
            digest = hashlib.sha256(mv[b:e]).hexdigest()
            is_new = digest not in self.index
            if is_new:
                self.index[digest] = e - b
            self.stats.observe(e - b, is_new)
            out.append((b, e, digest, is_new))
        return out

    def scan_file(self, path: str, location: Optional[str] = None):
        with open(path, "rb") as f:
            return self.scan_bytes(f.read(), location or path)
