# Port copy of src/repro/configs/base.py: data only; param counts come from repro_torch.models.api.
"""Architecture + input-shape configuration system.

``ArchConfig`` is a frozen dataclass describing one architecture; each of the
10 assigned architectures gets one module in this package exporting ``CONFIG``
(the exact published config) and ``SMOKE`` (a reduced same-family variant for
CPU smoke tests). ``ShapeCell`` describes one assigned input-shape cell.

The registry (`repro_torch.configs.registry`) resolves ``--arch <id>`` strings.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "ArchConfig", "ShapeCell", "SHAPES"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    version: int = 1            # 1 = Mamba-1 (falcon-mamba), 2 = Mamba-2/SSD (zamba2)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # Mamba-2 only
    dt_rank: int = 0            # Mamba-1: ceil(d_model / 16) when 0
    chunk: int = 256            # scan chunk length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_pct: float = 1.0
    mrope: bool = False         # Qwen2-VL M-RoPE
    moe: Optional[MoEConfig] = None
    swa_window: int = 0         # sliding-window attention (Mixtral)
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0         # hybrid: shared attention block every N ssm layers
    tie_embeddings: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act_dtype: str = "bfloat16"
    attn_score_dtype: str = "float32"  # bf16 halves flash score-block HBM traffic
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"    # adamw | adafactor (grok-scale)
    fsdp_over_pod: bool = False # shard params over ("pod","data") on the multi-pod mesh
    # which shape cells apply
    supports_decode: bool = True
    supports_long: bool = False # sub-quadratic attention -> run long_500k
    long_skip_reason: str = ""
    source: str = ""            # [arXiv/hf; verification tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def param_count(self) -> int:
        """Exact parameter count from the template table."""
        from repro_torch.models.api import get_model
        return get_model(self).param_count()

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of E experts)."""
        from repro_torch.models.api import get_model
        return get_model(self).active_param_count()


@dataclass(frozen=True)
class ShapeCell:
    name: str                   # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1       # grad-accum steps (train only)

    def with_microbatches(self, n: int) -> "ShapeCell":
        return replace(self, microbatches=n)


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256, microbatches=8),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cells_for(cfg: ArchConfig):
    """The applicable (arch × shape) cells: long_500k only for sub-quadratic
    archs; decode only for archs with a decode step (all assigned archs have
    one — whisper is enc-dec, not encoder-only)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.supports_long:
            continue
        if s.kind == "decode" and not cfg.supports_decode:
            continue
        out.append(s)
    return out
