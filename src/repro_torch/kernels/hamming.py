"""Bit distance on the card (counterpart of ``src/repro/kernels/hamming.py``).

``hamming_partials`` replaces the Pallas ``hamming_partials_2d`` and
``hamming_total`` replaces ``hamming_total_2d``; the CUDA kernel is in
``csrc/planes.cu``. XOR, popcount and a per-block sum run on the card, one
64-bit partial per block; the partials (at most a few thousand) are summed in
int64 and read once. Totals of embedding-sized tensors pass 2³², which is why
no stage keeps 32 bits. The reference's ``(rows, 1024)`` zero padding cancels
in XOR and has no counterpart: the kernel takes flat buffers and masks the
tail. A tensor on the CPU takes the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the kernel on the
current stream or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["hamming_partials", "hamming_total"]


def hamming_partials(a: torch.Tensor, b: torch.Tensor, nb: int) -> torch.Tensor:
    """Differing bits between two buffers of ``nb``-byte words, as int64
    partial sums: one per block of the kernel's grid on the card, a single
    one (the plain total) on the CPU."""
    n = _build.check_pair(a, b, nb)
    if a.device.type == "cpu":
        return torch.tensor([ref.hamming_total(a, b, nb)], dtype=torch.int64)
    # the kernel writes unsigned 64-bit counts, each at most 64·n < 2⁶³
    partials = torch.empty(_build.grid(n), dtype=torch.int64, device=a.device)
    if n:
        _build.launch("hamming", a, b, partials, n=n, nb=nb)
    return partials


def hamming_total(a: torch.Tensor, b: torch.Tensor, nb: int) -> int:
    """Total differing bits between two buffers of ``nb``-byte words (exact)."""
    return int(hamming_partials(a, b, nb).sum())
