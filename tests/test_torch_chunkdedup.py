"""The port's ChunkDedup (FastCDC over raw bytes, the hub's chunk-level
baseline) against the reference: the same chunk boundaries, digests and
``DedupStats`` on the same bytes, exactly."""

import dataclasses
import os

import numpy as np
import pytest

from repro.core import chunkdedup as ref_cdc
from repro_torch.core import chunkdedup as port_cdc

SMALL = dict(min_size=64, avg_size=256, max_size=1024)
HUB = dict(min_size=4096, avg_size=16384, max_size=65536)  # the benchmarks' setting


def _uploads(kind: str, seed: int):
    """A few byte strings that share regions, as hub uploads do."""
    rng = np.random.RandomState(seed)
    if kind == "shared_region":
        shared = rng.bytes(32 * 1024)
        return [rng.bytes(4096) + shared + rng.bytes(4096),
                rng.bytes(2048) + shared + rng.bytes(512)]
    if kind == "shifted":
        base = rng.bytes(256 * 1024)
        return [base, rng.bytes(7) + base, base[1000:] + rng.bytes(333)]
    if kind == "weights":  # bf16-like words: small-variance floats, upper halves
        w = (rng.randn(512 * 1024) * 0.02).astype(np.float32)
        ft = w + (rng.randn(w.size) * 0.001).astype(np.float32)
        return [(w.view(np.uint32) >> 16).astype(np.uint16).tobytes(),
                (ft.view(np.uint32) >> 16).astype(np.uint16).tobytes()]
    if kind == "tiny":
        return [b"", b"x", rng.bytes(63), rng.bytes(1025)]
    raise ValueError(kind)


def _stats(s):
    return dataclasses.asdict(s) | {"saved": s.saved_bytes, "ratio": s.reduction_ratio,
                                    "meta": s.metadata_bytes()}


@pytest.mark.parametrize("cdc", [SMALL, HUB], ids=["small", "hub"])
@pytest.mark.parametrize("kind", ["shared_region", "shifted", "weights", "tiny"])
def test_chunkdedup_matches_reference(kind, cdc):
    ref = ref_cdc.ChunkDedup(ref_cdc.FastCDC(**cdc))
    port = port_cdc.ChunkDedup(port_cdc.FastCDC(**cdc))
    for i, data in enumerate(_uploads(kind, seed=len(kind))):
        want = ref.scan_bytes(data, f"u{i}")
        got = port.scan_bytes(data, f"u{i}")
        assert got == want
        assert sum(e - b for b, e, _, _ in got) == len(data)
    assert port.index == ref.index
    assert _stats(port.stats) == _stats(ref.stats)


def test_chunkdedup_dedups_and_scans_files(tmp_path):
    """The port finds the shared region (the reference test's claim) and
    ``scan_file`` reads the same chunks as ``scan_bytes``."""
    f1, f2 = _uploads("shared_region", seed=4)
    dd = port_cdc.ChunkDedup(port_cdc.FastCDC(**SMALL))
    dd.scan_bytes(f1)
    before = dd.stats.unique_bytes
    dd.scan_bytes(f2)
    assert dd.stats.unique_bytes - before < len(f2) * 0.5
    path = os.path.join(tmp_path, "blob")
    with open(path, "wb") as f:
        f.write(f2)
    fresh = port_cdc.ChunkDedup(port_cdc.FastCDC(**SMALL))
    assert fresh.scan_file(path) == ref_cdc.ChunkDedup(ref_cdc.FastCDC(**SMALL)).scan_bytes(f2)


def test_gear_table_and_fingerprints_match_reference():
    assert np.array_equal(port_cdc.GEAR, ref_cdc.GEAR)
    buf = np.random.RandomState(1).randint(0, 256, 5000).astype(np.uint8)
    assert np.array_equal(port_cdc.gear_fingerprints(buf), ref_cdc.gear_fingerprints(buf))
    assert port_cdc.FastCDC().mask_s == ref_cdc.FastCDC().mask_s
    assert port_cdc.FastCDC().mask_l == ref_cdc.FastCDC().mask_l
