# Port of src/repro/sharding/rules.py: ParamSpec and ShardingRules as plain data.
"""Logical-axis parameter specs (a port of ``ParamSpec`` and ``ShardingRules``
from ``src/repro/sharding/rules.py``).

Every parameter and cache tensor carries a shape, a dtype, one logical axis
name per dimension and an init recipe; the models' ``param_templates`` and
``cache_templates`` return these, and the engine reads the ``"sp"`` axis to
find the sequence dimension of a cache. The JAX objects built from them
(``ParamSpec.sds`` / ``.sharding``, ``named_sharding`` and the mesh helpers,
``rules.py:87-151``) belong to the mesh slice and are not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ShardingRules", "ParamSpec"]


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to tuples of physical mesh axis names."""

    batch: Tuple[str, ...] = ("data",)
    fsdp: Tuple[str, ...] = ("data",)
    tp: Tuple[str, ...] = ("model",)
    sp: Tuple[str, ...] = ("model",)
    expert: Tuple[str, ...] = ()

    def resolve(self, logical: Optional[str]):
        """Logical axis name -> mesh axis entry (None, str or tuple)."""
        if logical is None:
            return None
        got: Tuple[str, ...] = getattr(self, logical)
        if len(got) == 0:
            return None
        if len(got) == 1:
            return got[0]
        return got


@dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + logical axes + init recipe for one parameter tensor.

    ``axes`` has one entry per dim: a logical axis name or None (replicated).
    ``stacked`` marks per-layer parameters that carry a leading layer dim.
    """

    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"       # "normal" | "zeros" | "ones" | "scaled"
    init_scale: float = 0.02
    stacked: bool = False

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")
