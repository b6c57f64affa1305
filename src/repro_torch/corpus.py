"""Synthetic dense model families for driving the store (a port of the
dense-family part of ``benchmarks/corpus.py``: ``make_base_tensors``,
``make_finetune`` and ``_write_repo``).

Weights are drawn with an explicit, seeded :class:`torch.Generator` on the given
device in float32 and rounded to bf16, as the reference draws with numpy and
rounds with ``ml_dtypes``: base weights w ~ N(0, σw²), fine-tune deltas
Δw ~ N(0, σΔ²) with a per-tensor chance of leaving a tensor untouched (the
tensor-dedup signal). The layout is the llama/qwen dense stack; grouped-query
attention narrows k/v to ``n_kv_heads * head_dim`` rows and ``qkv_bias`` adds
the q/k/v biases (Qwen2). With ``n_kv_heads == n_heads`` and no bias the layout
is the reference's. Files are written through the port's safetensors writer
as BF16-tagged uint16 bit views, and ``README.md`` carries ``base_model:``
front matter when the repo declares its base. The random numbers differ from
the reference generator's; only the layout and statistics carry over.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.formats import safetensors as st

__all__ = ["CorpusSpec", "make_base_tensors", "make_finetune", "write_repo"]


@dataclass
class CorpusSpec:
    n_layers: int = 4
    d_model: int = 128
    d_ff: int = 256
    vocab: int = 512
    n_heads: int = 4
    n_kv_heads: Optional[int] = None   # None: plain multi-head attention
    qkv_bias: bool = False
    sigma_w: float = 0.02
    sigma_delta: float = 0.005
    untouched_prob: float = 0.3        # per-tensor chance a fine-tune keeps it

    @property
    def kv_dim(self) -> int:
        kv = self.n_kv_heads or self.n_heads
        return kv * (self.d_model // self.n_heads)


def _randn(gen: torch.Generator, shape, sigma: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * sigma


def _dense_layer(t: Dict[str, torch.Tensor], p: str, spec: CorpusSpec,
                 gen: torch.Generator) -> None:
    d, f, kv = spec.d_model, spec.d_ff, spec.kv_dim
    bf = torch.bfloat16
    t[p + "input_layernorm.weight"] = torch.ones(d, dtype=bf, device=gen.device)
    t[p + "self_attn.q_proj.weight"] = _randn(gen, (d, d), spec.sigma_w).to(bf)
    t[p + "self_attn.k_proj.weight"] = _randn(gen, (kv, d), spec.sigma_w).to(bf)
    t[p + "self_attn.v_proj.weight"] = _randn(gen, (kv, d), spec.sigma_w).to(bf)
    if spec.qkv_bias:
        t[p + "self_attn.q_proj.bias"] = _randn(gen, (d,), spec.sigma_w).to(bf)
        t[p + "self_attn.k_proj.bias"] = _randn(gen, (kv,), spec.sigma_w).to(bf)
        t[p + "self_attn.v_proj.bias"] = _randn(gen, (kv,), spec.sigma_w).to(bf)
    t[p + "self_attn.o_proj.weight"] = _randn(gen, (d, d), spec.sigma_w).to(bf)
    t[p + "post_attention_layernorm.weight"] = torch.ones(d, dtype=bf, device=gen.device)
    t[p + "mlp.gate_proj.weight"] = _randn(gen, (f, d), spec.sigma_w).to(bf)
    t[p + "mlp.up_proj.weight"] = _randn(gen, (f, d), spec.sigma_w).to(bf)
    t[p + "mlp.down_proj.weight"] = _randn(gen, (d, f), spec.sigma_w).to(bf)


def make_base_tensors(spec: CorpusSpec, gen: torch.Generator,
                      embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """Base bf16 weights of one dense family, on ``gen``'s device, in
    serialization order. ``embeddings=False`` leaves out ``embed_tokens`` and
    ``lm_head``."""
    d = spec.d_model
    t: Dict[str, torch.Tensor] = {}
    if embeddings:
        t["model.embed_tokens.weight"] = _randn(gen, (spec.vocab, d), spec.sigma_w).to(torch.bfloat16)
    for i in range(spec.n_layers):
        _dense_layer(t, f"model.layers.{i}.", spec, gen)
    t["model.norm.weight"] = torch.ones(d, dtype=torch.bfloat16, device=gen.device)
    if embeddings:
        t["lm_head.weight"] = _randn(gen, (spec.vocab, d), spec.sigma_w).to(torch.bfloat16)
    return t


def make_finetune(base: Dict[str, torch.Tensor], spec: CorpusSpec, gen: torch.Generator,
                  sigma_delta: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """A fine-tune of ``base``: each tensor is kept bit-identical with
    probability ``untouched_prob`` (a tensor-dedup hit), else perturbed by
    N(0, σΔ²) in float32 and rounded back to bf16."""
    sd = spec.sigma_delta if sigma_delta is None else sigma_delta
    out = {}
    for name, arr in base.items():
        keep = float(torch.rand((), generator=gen, device=gen.device)) < spec.untouched_prob
        if keep or sd == 0.0:
            out[name] = arr.clone()
        else:
            out[name] = (arr.float() + _randn(gen, arr.shape, sd)).to(arr.dtype)
    return out


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """Host uint16 bit view of a bf16 tensor (int16 crosses to numpy, which has
    no bf16)."""
    return t.detach().contiguous().view(torch.int16).cpu().numpy().view(np.uint16)


def write_repo(root: str, repo_id: str, tensors: Dict[str, torch.Tensor],
               base_model: Optional[str] = None) -> str:
    """Write ``repo_id`` under ``root``: ``model.safetensors`` (the bf16
    tensors as BF16-tagged bit views, float32 ones, such as an SSM's ``A_log``
    and ``D``, as F32), ``config.json`` and a ``README.md`` that declares
    ``base_model`` in its front matter when one is given."""
    repo_dir = os.path.join(root, repo_id)
    os.makedirs(repo_dir, exist_ok=True)
    for name, t in tensors.items():
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name} is {t.dtype}; the model files hold bf16 and float32")
    st.save_file({name: _bf16_bits(t) if t.dtype == torch.bfloat16
                  else t.detach().contiguous().cpu().numpy() for name, t in tensors.items()},
                 os.path.join(repo_dir, "model.safetensors"),
                 dtype_tags={name: "BF16" for name, t in tensors.items()
                             if t.dtype == torch.bfloat16})
    cfg = {"architectures": ["Qwen2ForCausalLM"], "torch_dtype": "bfloat16"}
    readme = f"# {repo_id}\n"
    if base_model:
        readme = f"---\nbase_model: {base_model}\n---\n" + readme
    with open(os.path.join(repo_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(repo_dir, "README.md"), "w") as f:
        f.write(readme)
    return repo_dir
