# Port of src/repro/sharding/rules.py: rewritten for DTensor, names kept.
"""Logical-axis sharding rules: DP × FSDP(ZeRO-3) × TP (+ pod axis).

Every parameter/activation dimension carries a *logical* axis name; this module
maps logical names onto the named dims of a ``DeviceMesh``. The production
meshes are

* single-pod: ``(data=16, model=16)``
* multi-pod:  ``(pod=2, data=16, model=16)``

Default mapping (the reference's):

========  =======================  =============================================
logical   mesh axes                used for
========  =======================  =============================================
batch     ("pod", "data")          activation batch dim (pure DP)
fsdp      ("data",) | +"pod"       the ZeRO-3 dim of every weight (all-gathered
                                   per layer inside the step; reduce-scattered
                                   gradients)
tp        ("model",)               heads / d_ff / vocab — tensor parallelism
sp        ("model",)               sequence dim of long-context activations and
                                   of decode KV caches (flash-decoding)
expert    ()                       MoE expert dim (kept unsharded)
========  =======================  =============================================

A :class:`PartitionSpec` holds one entry per tensor dim (None, a mesh axis
name, or a tuple of them), as JAX's does; :func:`spec_placements` turns it into
DTensor placements, one per mesh dim: a tensor dim over ``("pod", "data")`` is
``Shard(d)`` on both mesh dims, pod major, which is the order JAX gives it.
:func:`safe_spec` replicates an entry whose axes do not divide the dim, as the
reference does; DTensor's uneven sharding is never used.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["ShardingRules", "ParamSpec", "PartitionSpec", "NamedSharding", "logical_to_spec",
           "safe_spec", "safe_entry", "named_sharding", "spec_placements", "axis_sizes",
           "spec_tree_sds", "spec_tree_shardings", "is_dtensor", "whole"]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. No DTensor exists before its module is
    imported, so code off the mesh never pays for that import (seconds on
    first use)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def whole(x):
    """A DTensor's whole value (``full_tensor``: a collective every rank of
    its mesh joins); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to tuples of physical mesh axis names."""

    batch: Tuple[str, ...] = ("data",)
    fsdp: Tuple[str, ...] = ("data",)
    tp: Tuple[str, ...] = ("model",)
    sp: Tuple[str, ...] = ("model",)
    expert: Tuple[str, ...] = ()

    @staticmethod
    def for_mesh(mesh, *, fsdp_over_pod: bool = False) -> "ShardingRules":
        has_pod = "pod" in mesh.mesh_dim_names
        batch = ("pod", "data") if has_pod else ("data",)
        fsdp = ("pod", "data") if (has_pod and fsdp_over_pod) else ("data",)
        return ShardingRules(batch=batch, fsdp=fsdp)

    def resolve(self, logical: Optional[str]):
        """Logical axis name -> spec entry (None, str or tuple)."""
        if logical is None:
            return None
        got: Tuple[str, ...] = getattr(self, logical)
        if len(got) == 0:
            return None
        if len(got) == 1:
            return got[0]
        return got


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (the dim split over their product, first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


def logical_to_spec(axes: Sequence[Optional[str]], rules: ShardingRules) -> PartitionSpec:
    """Translate a tuple of logical axis names into a PartitionSpec."""
    return PartitionSpec(*(rules.resolve(a) for a in axes))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, entry) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _names(entry))


def safe_spec(mesh, axes: Sequence[Optional[str]], rules: ShardingRules,
              shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """PartitionSpec with non-divisible entries dropped to replicated.

    E.g. a global_batch=1 long-context cell cannot shard its batch dim over a
    16-wide data axis: the axis is dropped (the roofline shows it idle)."""
    entries = [rules.resolve(a) for a in axes]
    if shape is not None:
        entries = [e if (dim % _axis_size(mesh, e) == 0) else None
                   for e, dim in zip(entries, shape)]
    return PartitionSpec(*entries)


def safe_entry(mesh, rules: ShardingRules, logical: Optional[str], dim: int):
    """Single PartitionSpec entry, dropped to None when it does not divide."""
    e = rules.resolve(logical)
    return e if (e is not None and dim % _axis_size(mesh, e) == 0) else None


def spec_placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim, ``Shard(d)``
    where tensor dim ``d``'s entry names that mesh dim, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, entry in enumerate(spec):
        for a in _names(entry):
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec on it: the reference's ``NamedSharding``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)

    def distribute(self, x: torch.Tensor):
        """``x`` (the whole tensor, alike on every rank) as a DTensor laid out
        by this sharding: each rank keeps its own piece, with no collective
        (the reference's ``device_put``). A meta tensor gives a meta DTensor."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements, src_data_rank=None)

    def zeros(self, shape: Sequence[int], dtype: torch.dtype):
        """Zeros of ``shape`` as a DTensor laid out by this sharding: each
        rank makes only its own piece."""
        from torch.distributed.tensor import zeros

        return zeros(tuple(shape), dtype=dtype, device_mesh=self.mesh,
                     placements=self.placements)


def named_sharding(mesh, axes: Sequence[Optional[str]], rules: ShardingRules,
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(mesh, safe_spec(mesh, axes, rules, shape))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_tree_sds(tree):
    """A tree of ParamSpec leaves as meta tensors (the reference's
    ShapeDtypeStructs)."""
    return _map(lambda s: s.sds, tree)


def spec_tree_shardings(tree, mesh, rules: ShardingRules):
    return _map(lambda s: s.sharding(mesh, rules), tree)


@dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + logical axes + init recipe for one parameter tensor.

    ``axes`` has one entry per dim: a logical axis name or None (replicated).
    ``stacked`` marks per-layer parameters that carry a leading layer dim (the
    leading dim is never sharded).
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

    @property
    def sds(self) -> torch.Tensor:
        """A meta tensor of this shape and dtype: no storage."""
        return torch.empty(self.shape, dtype=getattr(torch, self.dtype), device="meta")

    def spec(self, rules: ShardingRules) -> PartitionSpec:
        return logical_to_spec(self.axes, rules)

    def sharding(self, mesh, rules: ShardingRules) -> NamedSharding:
        return named_sharding(mesh, self.axes, rules, self.shape)
