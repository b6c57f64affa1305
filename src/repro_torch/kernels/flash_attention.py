"""Flash-attention forward on the card (counterpart of
``src/repro/kernels/flash_attention.py``).

``flash_attention`` replaces the Pallas ``flash_attention`` with one of two
CUDA kernels, picked by :func:`route`: ``"sm90"`` (``csrc/flash_attention_sm90.cu``:
bf16 tiles on the tensor cores through ``wgmma``, loaded by TMA) for bf16
operands of head dim 64 or 128 whose base pointers and B/S/H strides TMA can
address (multiples of 16 bytes), and ``"simt"`` (``csrc/flash_attention.cu``:
float32 FMAs) for every other call. Both take the reference's layout, q
(B, Sq, H, D) and k, v (B, Sk, H, D) with grouped-query heads already expanded,
in float32 or bfloat16, and read the operands in place through their strides
(the last dim must be contiguous): no ``(B*H, S, D)`` transposes, no block-size
divisibility, ragged Sq and Sk welcome. The kernels are forward-only, as the
TPU kernel is, so an input that requires grad is refused. A tensor on the CPU
takes the plain version :func:`repro_torch.kernels.ref.mha_reference`; a CUDA
tensor launches its route's kernel on the current stream or raises (no route
falls back to the other).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention", "route", "route_launches", "reset_route_launches", "HEAD_DIMS",
           "SM90_HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are built for
SM90_HEAD_DIMS = (64, 128)          # the head dims of the sm90 route
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # heads and batch ride the grid's y and z dims
_TMA_ALIGN = 16         # bytes: a tensor map's base address and strides are multiples of it
_TMA_STRIDE_LIMIT = 1 << 40  # bytes: and its strides are below it
_LAUNCHER = {"sm90": "flash_attention_sm90", "simt": "flash_attention"}

# launches per route; _build counts both under "flash_attention"
ROUTE_LAUNCHES = {name: 0 for name in _LAUNCHER}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, H, D), got shapes "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[2] != H:
        raise ValueError(f"k and v have {k.shape[2]} heads and q {H}: expand grouped-query "
                         "heads (repeat_kv) before the call")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q, k and v must lie on one cpu or cuda device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention is forward-only (the TPU kernel has no "
                           "backward); call it on tensors that do not require grad")
    if q.device.type == "cuda":
        if D not in HEAD_DIMS:
            raise ValueError(f"head dim {D} is not one the kernel is built for {HEAD_DIMS}")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("the last dim of q, k and v must be contiguous")
        if B > _GRID_LIMIT or H > _GRID_LIMIT:
            raise ValueError(f"batch {B} or heads {H} exceed the grid limit {_GRID_LIMIT}")


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call takes: ``"sm90"`` when q, k and v are bf16 with head
    dim 64 or 128, D contiguous, and every base pointer and every B/S/H byte
    stride is a positive multiple of 16 below 2^40 (what a TMA tensor map can
    address; a dim of extent 1 is never stepped, so its stride is free);
    ``"simt"`` otherwise. Reads only dtypes, shapes, pointers and strides."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or q.shape[-1] not in SM90_HEAD_DIMS:
        return "simt"
    for t in (q, k, v):
        size = t.element_size()
        if t.stride(-1) != 1 or t.data_ptr() % _TMA_ALIGN:
            return "simt"
        for extent, stride in zip(t.shape[:3], t.stride()[:3]):
            if extent > 1 and not (0 < stride * size < _TMA_STRIDE_LIMIT
                                   and stride * size % _TMA_ALIGN == 0):
                return "simt"
    return "sm90"


def route_launches() -> dict:
    """Kernel launches per route since the last reset."""
    return dict(ROUTE_LAUNCHES)


def reset_route_launches() -> None:
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def _launch(which: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """Run route ``which``'s kernel on checked CUDA operands; the output is
    a new contiguous (B, Sq, H, D) tensor."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _build.launch_args(_LAUNCHER[which], q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Sk, H, D, *strides, int(causal), int(window),
                       _DTYPE_CODE[q.dtype])
    ROUTE_LAUNCHES[which] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Softmax attention over H heads: (B, Sq, H, D) out, in q's dtype.

    ``causal`` masks keys after the query (positions start at 0 for both);
    ``window > 0`` also masks keys at or before ``q_pos - window``.
    """
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    if k.shape[1] == 0 and q.shape[1]:
        raise ValueError("flash_attention needs at least one key")
    return _launch(route(q, k, v), q, k, v, causal, window)
