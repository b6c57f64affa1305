# Port of src/repro/launch/mesh.py: rewritten for torch.distributed, names kept.
"""Device meshes over ``torch.distributed`` process groups, and the card's
hardware constants for the roofline.

Production topology, with the reference's axis names:

* single-pod: 16 × 16 = 256 devices, axes ("data", "model")
* multi-pod:  2 × 16 × 16 = 512 devices, axes ("pod", "data", "model")

The "model" axis carries TP + sequence-parallel decode; "data" carries DP +
FSDP; "pod" carries DP (and optionally FSDP for grok-scale models — see
``ShardingRules.for_mesh(fsdp_over_pod=True)``).

A mesh spans the process group that is up: NCCL across cards, gloo across CPU
processes, or, for the dry run, a fake group of 256 or 512 ranks that runs no
collective (``repro_torch.launch.dryrun``). A one-device mesh needs no group
from the caller: :func:`make_local_mesh` starts a one-rank group over a
``FileStore`` when none is up.

:class:`HW` holds NVIDIA's datasheet figures for one H100 SXM 80 GB (dense
rates, at the full 700 W power limit). The collective term keeps the
reference's one-link convention: the slowest link that a 16-wide axis crosses.
On an H100 cluster that is the network, one 400 Gb/s NIC per GPU (50e9 B/s);
NVLink (450 GB/s each way) joins only the 8 cards of one host, and a 16-wide
axis leaves the host.
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_backend",
           "ensure_process_group", "HW"]


def mesh_backend(device_type: str) -> str:
    """The collective backend of a device type: NCCL on cards, gloo on the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"a mesh spans 'cuda' or 'cpu' devices, not {device_type!r}")


def _check_device(device_type: str) -> None:
    mesh_backend(device_type)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA device and none is visible; "
                           "pass device_type='cpu' for a mesh of CPU processes")


def ensure_process_group(device_type: str) -> None:
    """A process group for this process: the one that is up, else a one-rank
    group over a ``FileStore`` in a fresh temporary file."""
    if dist.is_initialized():
        return
    _check_device(device_type)
    fd, path = tempfile.mkstemp(prefix="repro-torch-pg-")
    os.close(fd)
    os.remove(path)  # FileStore creates it
    dist.init_process_group(mesh_backend(device_type), store=dist.FileStore(path, 1),
                            rank=0, world_size=1)


def _mk(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(f"a {shape} mesh spans {math.prod(shape)} ranks: start a process "
                               "group of that size first (the launcher does)")
        ensure_process_group(device_type)
    if dist.get_backend() != "fake":
        _check_device(device_type)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0, device_type: str = "cuda"):
    """A (data, model) or (pod, data, model) mesh over the process group that
    is up (one rank: started here if none is)."""
    if pod:
        return _mk((pod, data, model), ("pod", "data", "model"), device_type)
    return _mk((data, model), ("data", "model"), device_type)


class HW:
    """One NVIDIA H100 SXM 80 GB, from NVIDIA's datasheet (dense, 700 W)."""

    PEAK_FLOPS_BF16 = 989e12     # tensor cores, bf16 dense
    HBM_BW = 3.35e12             # bytes/s
    LINK_BW = 50e9               # bytes/s: one 400 Gb/s NIC, the slowest link a 16-wide axis crosses
    HBM_BYTES = 80e9             # bytes
