"""BitX encode/decode on the card (counterpart of ``src/repro/kernels/bitx_xor.py``).

``xor_split`` replaces the Pallas ``xor_split_2d`` and ``merge_xor`` replaces
``merge_xor_2d``; the CUDA kernels are in ``csrc/planes.cu``. Both wrappers take
flat uint8 buffers of ``n`` little-endian words of ``nb`` bytes and planes as
one ``(nb, n)`` uint8 tensor, MSB plane first. A tensor on the CPU takes the
plain version in :mod:`repro_torch.kernels.ref`; a CUDA tensor launches the
kernel on the current stream or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["xor_split", "merge_xor"]


def xor_split(base: torch.Tensor, ft: torch.Tensor, nb: int) -> torch.Tensor:
    """``(nb, n)`` byte planes of ``base ^ ft``, MSB plane first."""
    n = _build.check_bytes(base, nb, "base")
    if _build.check_bytes(ft, nb, "ft") != n or ft.device != base.device:
        raise ValueError("base and ft must hold the same words on one device")
    if base.device.type == "cpu":
        return ref.xor_split_planes(base, ft, nb)
    planes = torch.empty((nb, n), dtype=torch.uint8, device=base.device)
    if n:
        _build.launch("xor_split", base, ft, planes, n=n, nb=nb)
    return planes


def merge_xor(planes: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`xor_split`: the words of ``ft`` as a flat byte buffer."""
    if planes.dim() != 2:
        raise ValueError(f"planes must be (nb, n), got shape {tuple(planes.shape)}")
    nb = planes.shape[0]
    n = _build.check_bytes(base, nb, "base")
    _build.check_bytes(planes, 1, "planes")
    if planes.shape[1] != n or planes.device != base.device:
        raise ValueError("planes and base must hold the same words on one device")
    if base.device.type == "cpu":
        return ref.merge_planes_xor(planes, base)
    out = torch.empty(n * nb, dtype=torch.uint8, device=base.device)
    if n:
        _build.launch("merge_xor", planes, base, out, n=n, nb=nb)
    return out
