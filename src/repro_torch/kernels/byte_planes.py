"""ZipNN byte-plane shuffle on the card (counterpart of
``src/repro/kernels/byte_planes.py``).

``split`` replaces the Pallas ``split_2d`` and ``merge`` replaces ``merge_2d``;
the CUDA kernels are in ``csrc/planes.cu``. Same buffer conventions and
dispatch as :mod:`repro_torch.kernels.bitx_xor`, without a base.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["split", "merge"]


def split(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``(nb, n)`` byte planes of the words in ``x``, MSB plane first."""
    n = _build.check_bytes(x, nb, "x")
    if x.device.type == "cpu":
        return ref.byte_split(x, nb)
    planes = torch.empty((nb, n), dtype=torch.uint8, device=x.device)
    if n:
        _build.launch("split", x, planes, n=n, nb=nb)
    return planes


def merge(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split`: the words as a flat byte buffer."""
    if planes.dim() != 2:
        raise ValueError(f"planes must be (nb, n), got shape {tuple(planes.shape)}")
    nb, n = planes.shape
    _build.check_bytes(planes, 1, "planes")
    if nb not in (1, 2, 4, 8):
        raise ValueError(f"word width must be 1, 2, 4 or 8 bytes, got {nb}")
    if planes.device.type == "cpu":
        return ref.byte_merge(planes)
    out = torch.empty(n * nb, dtype=torch.uint8, device=planes.device)
    if n:
        _build.launch("merge", planes, out, n=n, nb=nb)
    return out
