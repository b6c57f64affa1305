"""Public tensor API over the storage kernels (counterpart of
``src/repro/kernels/ops.py``).

Callers hand in arbitrary-shaped tensors (float or unsigned bit view); this
module bitcasts floats to their unsigned bit view (bf16/f16 -> u16, f32 -> u32,
f64 -> u64), flattens them to byte buffers and reshapes the results. The
reference's ``(rows, 1024)`` padding and block-row evenness are TPU plumbing
and have no counterpart: the CUDA kernels take flat buffers and mask the tail.
Dispatch follows the tensor: CPU tensors take the plain PyTorch versions, CUDA
tensors the kernels.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels import bitx_xor as _bitx
from repro_torch.kernels import byte_planes as _bp

__all__ = [
    "bit_view_dtype",
    "to_bit_view",
    "bitx_encode_planes",
    "bitx_decode_planes",
    "zipnn_split_planes",
    "zipnn_merge_planes",
]

_FLOAT_TO_UINT = {
    torch.bfloat16: torch.uint16,
    torch.float16: torch.uint16,
    torch.float32: torch.uint32,
    torch.float64: torch.uint64,
}
_UINTS = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def bit_view_dtype(dtype: torch.dtype) -> torch.dtype:
    """Unsigned bit-view dtype for a float (or passthrough for uints)."""
    if dtype in _FLOAT_TO_UINT:
        return _FLOAT_TO_UINT[dtype]
    if dtype in _UINTS:
        return dtype
    raise ValueError(f"no bit view for dtype {dtype}")


def to_bit_view(x: torch.Tensor) -> torch.Tensor:
    """Bitcast to the unsigned view (no-op if already unsigned)."""
    tgt = bit_view_dtype(x.dtype)
    return x if x.dtype == tgt else x.view(tgt)


def _words(x: torch.Tensor) -> torch.Tensor:
    """Flat contiguous byte buffer of ``x``'s words."""
    if x.numel() == 0:  # an empty tensor's stride refuses the dtype view
        return torch.empty(0, dtype=torch.uint8, device=x.device)
    return x.contiguous().reshape(-1).view(torch.uint8)


def _stack(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([p.reshape(-1) for p in planes])


def bitx_encode_planes(base: torch.Tensor, ft: torch.Tensor) -> List[torch.Tensor]:
    """XOR-delta byte planes (MSB first) of ``ft`` against ``base``: flat uint8
    planes of length ``numel(base)``."""
    a, b = to_bit_view(base), to_bit_view(ft)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"base {a.shape}/{a.dtype} and ft {b.shape}/{b.dtype} differ")
    return list(_bitx.xor_split(_words(a), _words(b), a.element_size()).unbind(0))


def bitx_decode_planes(planes: Sequence[torch.Tensor], base: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bitx_encode_planes`: the bit view of ``ft``, shaped
    like ``base``."""
    a = to_bit_view(base)
    out = _bitx.merge_xor(_stack(planes), _words(a))
    return out.view(a.dtype).view(a.shape)


def zipnn_split_planes(x: torch.Tensor) -> List[torch.Tensor]:
    """ZipNN byte planes (MSB first) of one tensor's bit view."""
    a = to_bit_view(x)
    return list(_bp.split(_words(a), a.element_size()).unbind(0))


def zipnn_merge_planes(planes: Sequence[torch.Tensor], dtype: torch.dtype,
                       shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`zipnn_split_planes`: a ``bit_view_dtype(dtype)``
    tensor of ``shape``."""
    out = _bp.merge(_stack(planes))
    return out.view(bit_view_dtype(dtype)).view(tuple(shape))
