# Port of src/repro/core/bitdistance.py: the numpy part copied, logic unchanged;
# the Monte-Carlo calibration rewritten in PyTorch over the hamming kernel.
"""Bit distance (paper Eq. 1) + Monte-Carlo clustering-threshold calibration (§4.2, A.0.1).

``bit_distance_arrays`` / ``bit_distance_files`` implement the metric on
aligned bit views (numpy, over mmap'd files), which is what family matching
in :mod:`repro_torch.core.clustering` calls; ``repro_torch.kernels.ops``
computes it for tensors on the card. ``expected_bit_distance_mc`` reproduces
the paper's Monte-Carlo estimate of E[D(w, w+δ)] under w ~ N(0, σw²),
δ ~ N(0, σΔ²), which yields the within-family range [~3.5, 6] bits for BF16
and motivates the threshold of 4 (Fig. 11/12). It runs on the card by default
and raises where there is none; ``device="cpu"`` runs it on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "bit_distance_arrays",
    "hamming_total_arrays",
    "bit_distance_files",
    "shape_signature",
    "rounded_bit_distance",
    "expected_bit_distance_mc",
    "CalibrationResult",
    "calibration_heatmap",
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


# ---------------------------------------------------------------------------
# Monte-Carlo threshold calibration (paper §4.2, Appendix A.0.1)
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the calibration runs on a CUDA device by default and none is "
                               "visible; pass device='cpu' to run it on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"the calibration runs on 'cuda' or 'cpu', not {dev}")
    return dev


def rounded_bit_distance(w: torch.Tensor, delta: torch.Tensor, dtype: str = "bfloat16") -> float:
    """The deterministic core of :func:`expected_bit_distance_mc`: round the
    float32 draws ``w`` and ``w + delta`` to ``dtype`` (nearest even, as jax's
    ``astype``) and take their bit distance, through the hamming kernel for
    tensors on the card."""
    target = getattr(torch, dtype)
    return ops.bit_distance(w.to(target), (w + delta).to(target))


def expected_bit_distance_mc(
    sigma_w: float,
    sigma_delta: float,
    n: int = 100_000,
    dtype: str = "bfloat16",
    seed: int = 0,
    device="cuda",
) -> float:
    """Monte-Carlo estimate of E[D(w, w+δ)] (paper's N=100,000 default).

    Bit distance is discontinuous in the float value (ULP boundaries), so the
    expectation is sampled exactly as the paper does: draw w and δ in fp32,
    round both w and w+δ to the target dtype, popcount the XOR. The draws come
    from one ``torch.Generator`` seeded with ``seed`` on ``device``, w first;
    they are not jax's numbers, so only the statistics match the reference.
    """
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n, generator=gen, device=dev, dtype=torch.float32) * sigma_w
    d = torch.randn(n, generator=gen, device=dev, dtype=torch.float32) * sigma_delta
    return rounded_bit_distance(w, d, dtype)


@dataclass
class CalibrationResult:
    sigma_w_grid: List[float]
    sigma_delta_grid: List[float]
    heatmap: np.ndarray  # E[D] per (sigma_w, sigma_delta)
    within_family_range: Tuple[float, float]

    def recommended_threshold(self, cross_family_floor: float = 6.0) -> float:
        """Paper A.0.1: clip the in-family upper bound at the near-cross-family
        bit distance (~4 for Llama-3 vs 3.1) rather than the generic floor."""
        return min(DEFAULT_THRESHOLD, cross_family_floor)


def calibration_heatmap(
    sigma_w_grid: Sequence[float] = (0.01, 0.015, 0.02, 0.03, 0.04, 0.05),
    sigma_delta_grid: Sequence[float] = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.02),
    n: int = 100_000,
    dtype: str = "bfloat16",
    device="cuda",
) -> CalibrationResult:
    """Reproduces Fig. 11: expected-bit-distance heatmap over (σw, σΔ)."""
    dev = _device(device)
    hm = np.zeros((len(sigma_w_grid), len(sigma_delta_grid)), np.float64)
    for i, sw in enumerate(sigma_w_grid):
        for j, sd in enumerate(sigma_delta_grid):
            hm[i, j] = expected_bit_distance_mc(sw, sd, n=n, dtype=dtype, seed=i * 31 + j,
                                                device=dev)
    # within-family empirical band (paper: σw∈[0.015,0.05], σΔ∈[0,0.02])
    band = hm[np.ix_(
        [i for i, s in enumerate(sigma_w_grid) if 0.015 <= s <= 0.05],
        [j for j, s in enumerate(sigma_delta_grid) if s <= 0.02],
    )]
    rng = (float(band.min()), float(band.max())) if band.size else (float(hm.min()), float(hm.max()))
    return CalibrationResult(list(sigma_w_grid), list(sigma_delta_grid), hm, rng)
