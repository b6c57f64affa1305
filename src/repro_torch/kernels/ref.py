"""Plain PyTorch versions of the storage kernels (counterpart of
``src/repro/kernels/ref.py:41-80``).

They are the semantic ground truth for the CUDA kernels in ``csrc/planes.cu``
and run wherever a tensor lies on the CPU. Everything is written on uint8
byte views: a flat buffer of ``n`` little-endian words of ``nb`` bytes is
viewed as ``(n, nb)``, and plane ``i`` is byte column ``nb - 1 - i`` (MSB plane
first), as the numpy host path does. XOR on the byte view equals XOR on the
words, and the byte view needs no shifts, which PyTorch lacks for
uint16/32/64 on the CPU.

Signatures match the wrappers in :mod:`repro_torch.kernels.bitx_xor` and
:mod:`repro_torch.kernels.byte_planes`: words in as flat uint8 buffers of
``n * nb`` bytes, planes as one ``(nb, n)`` uint8 tensor.
"""

from __future__ import annotations

import torch

__all__ = ["byte_split", "byte_merge", "xor_split_planes", "merge_planes_xor"]


def byte_split(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Split ``n`` words (flat uint8, ``n * nb`` bytes) into ``(nb, n)`` byte
    planes, most significant first. For BF16 bit views (``nb == 2``) that is
    ``[sign+exp7, exp1+mantissa7]``, the ZipNN grouping."""
    return x.view(-1, nb).flip(1).t().contiguous()


def byte_merge(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`byte_split`: ``(nb, n)`` planes back to the flat
    ``n * nb`` byte buffer of the words."""
    return planes.flip(0).t().contiguous().view(-1)


def xor_split_planes(base: torch.Tensor, ft: torch.Tensor, nb: int) -> torch.Tensor:
    """Fused BitX encode: XOR two word buffers, split the delta into planes."""
    return byte_split(torch.bitwise_xor(base, ft), nb)


def merge_planes_xor(planes: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Fused BitX decode: merge the planes into the delta, XOR with ``base``."""
    return torch.bitwise_xor(byte_merge(planes), base)
