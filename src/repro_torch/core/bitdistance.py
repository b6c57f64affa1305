# Port copy of src/repro/core/bitdistance.py:1-96 (the numpy part): host-only, logic unchanged.
"""Bit distance (paper Eq. 1) on the host.

``bit_distance_arrays`` / ``bit_distance_files`` implement the metric on
aligned bit views (numpy, over mmap'd files), which is what family matching
in :mod:`repro_torch.core.clustering` calls. The Monte-Carlo threshold
calibration of the reference module waits for the hamming-kernel slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "bit_distance_arrays",
    "hamming_total_arrays",
    "bit_distance_files",
    "shape_signature",
    "DEFAULT_THRESHOLD",
]

# Paper §4.2: threshold 4 gives 93.5% family classification accuracy.
DEFAULT_THRESHOLD = 4.0


def _bit_view(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "u":
        return arr
    return arr.view(f"<u{arr.dtype.itemsize}")


def hamming_total_arrays(a: np.ndarray, b: np.ndarray) -> int:
    """Total differing bits between two same-shape arrays (numpy host path)."""
    av = _bit_view(np.ascontiguousarray(a)).reshape(-1)
    bv = _bit_view(np.ascontiguousarray(b)).reshape(-1)
    assert av.shape == bv.shape and av.dtype == bv.dtype
    delta = np.bitwise_xor(av, bv)
    # np.bitwise_count (numpy>=2) is a vectorized popcount.
    return int(np.bitwise_count(delta).astype(np.uint64).sum())


def bit_distance_arrays(a: np.ndarray, b: np.ndarray) -> float:
    """Paper Eq. 1 over two aligned arrays: mean differing bits per element."""
    n = int(np.prod(a.shape)) if a.shape else a.size
    if n == 0:
        return 0.0
    return hamming_total_arrays(a, b) / n


def shape_signature(infos) -> Tuple:
    """Order-sensitive (name-free) signature of a model's tensor shapes+dtypes.

    §4.2: models with different tensor shapes are immediately cross-family —
    the cheap prefilter before any bit distance is computed.
    """
    return tuple((ti.dtype_str, ti.shape) for ti in infos)


def bit_distance_files(
    path_a: str,
    path_b: str,
    sample_elems_per_tensor: Optional[int] = 262_144,
) -> float:
    """Bit distance between two safetensors files, aligned by serialization
    order. ``sample_elems_per_tensor`` caps per-tensor work (prefix sample) —
    the paper's matching step needs "fewer than five comparisons" per model, and
    a prefix of each tensor is an unbiased-enough estimator for thresholding
    (validated in tests against the full scan).
    """
    from repro_torch.formats.safetensors import SafetensorsFile

    with SafetensorsFile(path_a) as fa, SafetensorsFile(path_b) as fb:
        if shape_signature(fa.infos) != shape_signature(fb.infos):
            return float("inf")  # structurally different => cross-family
        total_bits = 0
        total_elems = 0
        for ta, tb in zip(fa.infos, fb.infos):
            va = fa.tensor(ta.name).reshape(-1)
            vb = fb.tensor(tb.name).reshape(-1)
            if sample_elems_per_tensor and va.size > sample_elems_per_tensor:
                va = va[:sample_elems_per_tensor]
                vb = vb[:sample_elems_per_tensor]
            total_bits += hamming_total_arrays(va, vb)
            total_elems += va.size
        return total_bits / max(total_elems, 1)
