# Port of src/repro/models/api.py: rewritten in PyTorch, names kept.
"""Unified model API: dispatch ArchConfig -> model class, parameter init,
decode caches, input specs and real synthetic batches; plus
:func:`params_from_reference`, which carries the JAX package's flat numpy
parameters into torch tensors.

Draws come from an explicit :class:`torch.Generator` on an explicit device.
The ``abstract_*`` stand-ins and the ``*_shardings`` helpers of the reference
build JAX objects for a mesh and wait for the mesh slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.sharding.rules import ParamSpec

__all__ = [
    "get_model",
    "init_params",
    "init_cache",
    "input_templates",
    "make_batch",
    "params_from_reference",
]


def get_model(cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing"):
    """The model of ``cfg``'s family. ``attn`` picks the full-sequence
    attention of the models that attend: the CUDA kernel (``"flash"``, the
    default) or the plain PyTorch version (``"plain"``); ``MambaLM`` has no
    attention and ignores it. ``remat_policy`` (``"nothing"``, ``"dots"`` or
    ``"none"``, the reference's) sets what the backward pass of ``loss``
    recomputes."""
    from repro_torch.models.ssm import MambaLM, Zamba2LM
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.whisper import WhisperModel

    if cfg.family == "encdec":
        return WhisperModel(cfg, attn, remat_policy)
    if cfg.family == "ssm":
        return MambaLM(cfg, attn, remat_policy)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, attn, remat_policy)
    return TransformerLM(cfg, attn, remat_policy)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_one(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    dt = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    scale = spec.init_scale if spec.init == "scaled" else 0.02
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
            * scale).to(dt)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Random parameters of ``cfg``, drawn in name order from ``generator`` on
    ``device`` (default: the generator's device). The draws differ from the
    reference's ``jax.random`` keys; the recipe (normal 0.02, scaled output
    projections, ones, zeros) is the same."""
    device = torch.device(device) if device is not None else generator.device
    templates = get_model(cfg).param_templates()
    return {name: _init_one(generator, spec, device) for name, spec in sorted(templates.items())}


def params_from_reference(flat: Mapping[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
    """The JAX package's flat parameters, as numpy arrays, on ``device``.

    A bfloat16 array (detected by dtype name, as ``formats/safetensors.py``
    does, so ``ml_dtypes`` is never imported) crosses as its 16-bit pattern and
    becomes ``torch.bfloat16`` with the same bits; other dtypes cross as they
    are (the SSMs' float32 ``A_log``, ``D`` and ``dt_bias`` stay float32 inside
    a bf16 model)."""
    out = {}
    for name, arr in flat.items():
        a = np.array(arr, copy=True, order="C")  # owned and writable, as torch wants
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, seq: int, device) -> Dict:
    out = {}
    for k, spec in get_model(cfg).cache_templates(batch, seq).items():
        if k != "len":
            out[k] = torch.zeros(spec.shape, dtype=getattr(torch, spec.dtype), device=device)
    out["len"] = 0
    return out


# ---------------------------------------------------------------------------
# Model inputs per shape cell
# ---------------------------------------------------------------------------


def input_templates(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, ParamSpec]:
    """Templates (with logical axes) for one cell's batch.

    train:   tokens + labels (B, S)  [+ frames/patch_embeds/positions3 stubs]
    prefill: tokens (B, S)           [+ stubs]
    decode:  tokens (B, 1)           (the cache is a separate argument)
    """
    B = cell.global_batch
    S = 1 if cell.kind == "decode" else cell.seq_len
    t: Dict[str, ParamSpec] = {
        "tokens": ParamSpec((B, S), "int32", ("batch", None)),
    }
    if cell.kind == "train":
        t["labels"] = ParamSpec((B, S), "int32", ("batch", None))
    if cfg.family == "encdec" and cell.kind != "decode":
        # conv-frontend stub: precomputed frame embeddings
        t["frames"] = ParamSpec((B, cell.seq_len, cfg.d_model), cfg.act_dtype,
                                ("batch", None, None))
    if cfg.family == "vlm":
        if cell.kind != "decode":
            # patch-embedding stub merged additively over token embeddings
            t["patch_embeds"] = ParamSpec((B, S, cfg.d_model), cfg.act_dtype,
                                          ("batch", None, None))
            t["positions3"] = ParamSpec((B, 3, S), "int32", ("batch", None, None))
    return t


def make_batch(cfg: ArchConfig, cell: ShapeCell, generator: torch.Generator,
               device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Real synthetic batch (reduced configs), drawn from ``generator``."""
    device = torch.device(device) if device is not None else generator.device
    out = {}
    for name, spec in input_templates(cfg, cell).items():
        if spec.dtype == "int32":
            if name == "positions3":
                S = spec.shape[-1]
                out[name] = torch.arange(S, dtype=torch.int32, device=device).expand(spec.shape)
            else:
                out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=generator,
                                          dtype=torch.int32, device=device)
        else:
            out[name] = (torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                                     device=device) * 0.02).to(getattr(torch, spec.dtype))
    return out
