"""Flash-attention forward on the card (counterpart of
``src/repro/kernels/flash_attention.py``).

``flash_attention`` replaces the Pallas ``flash_attention``; the CUDA kernel is
in ``csrc/flash_attention.cu``. It takes the reference's layout, q
(B, Sq, H, D) and k, v (B, Sk, H, D) with grouped-query heads already expanded,
in float32 or bfloat16, and reads the operands in place through their strides
(the last dim must be contiguous): no ``(B*H, S, D)`` transposes, no block-size
divisibility, ragged Sq and Sk welcome. The kernel is forward-only, as the TPU
kernel is, so an input that requires grad is refused. A tensor on the CPU takes
the plain version :func:`repro_torch.kernels.ref.mha_reference`; a CUDA tensor
launches the kernel on the current stream or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["flash_attention", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # heads and batch ride the grid's y and z dims


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
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sk == 0 and Sq:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    _build.launch_args("flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Sk, H, D, *strides, int(causal), int(window),
                       _DTYPE_CODE[q.dtype])
    return out
