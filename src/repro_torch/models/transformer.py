# Port of src/repro/models/transformer.py: rewritten in PyTorch, names and layouts kept.
"""Decoder-only transformer LM family, on one card or on a device mesh.

Covers the seven transformer architectures of the reference through one
config-driven implementation: qwen2-7b / qwen2-vl-7b (GQA, QKV bias, M-RoPE),
granite-20b (MQA), phi4-mini (partial rotary), deepseek-coder-33b,
mixtral-8x7b (MoE + SWA), grok-1-314b (MoE). Parameters are the reference's
flat dict: ``embed``, ``final_norm``, ``lm_head`` and the per-layer
``blocks.*`` tensors stacked on a leading layer dim.

Entry points, as in the reference:

* ``loss(params, batch)``              — mean next-token CE, differentiable
* ``prefill(params, batch)``           — last-position logits + KV cache
* ``decode_step(params, batch, cache)`` — one token against the cache

What changes from the reference: ``lax.scan`` over the stacked blocks becomes
a Python loop over the leading layer dim, each layer of ``loss`` wrapped by
:func:`layers.remat` under ``remat_policy`` (the reference's
``jax.checkpoint``); the decode step writes the new K/V into the
preallocated cache in place, where the reference's ``dynamic_update_slice``
returns a new array.

On a mesh (``mesh`` and ``rules`` given) the parameters and inputs are
DTensors laid out by the rules (``models.api.param_shardings`` /
``input_shardings``) and the model is the reference's GSPMD program written
out: each layer's weights are gathered over their FSDP axes where the layer
uses them (the backward pass reduce-scatters their gradients), the
reference's ``with_sharding_constraint`` points are ``redistribute`` calls
(``_ws``), RoPE and attention run under ``local_map`` on each rank's own
batch rows and heads (the flash kernel included), MoE dispatches one group
per data shard, decode on a model axis wider than one runs
:func:`layers.decode_attention_sp` over the sequence-sharded cache, and each
rank writes a new K/V position only where it owns that position. What runs
under ``local_map`` is plain tensor code, so no plain tensor meets a DTensor
in the autograd graph. ``attn="flash"`` (the default)
runs the full-sequence attention of ``loss`` and ``prefill`` through
:func:`repro_torch.kernels.flash_attention.flash_attention`, the hand-written
CUDA kernel on a card; ``attn="plain"`` runs :func:`layers.attention`, as the
reference does. Decode keeps :func:`layers.attention` with ``q_offset`` under
both flags, as the reference does: the kernel has no query offset.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.sharding.rules import (ParamSpec, PartitionSpec, axis_sizes, named_sharding,
                                        safe_entry, spec_placements)

__all__ = ["TransformerLM", "ATTN_IMPLS", "check_attn", "stacked_params", "layer_params",
           "count_params", "logits_f32"]

ATTN_IMPLS = ("flash", "plain")


# helpers shared by the model families (ssm.py and whisper.py import them)

def check_attn(attn: str) -> str:
    """``attn`` if it names a full-sequence attention: the kernel or plain."""
    if attn not in ATTN_IMPLS:
        raise ValueError(f"attn must be one of {ATTN_IMPLS}, got {attn!r}")
    return attn


def stacked_params(params, prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """The tensors under ``prefix`` (stacked on a leading layer dim), keyed
    without it."""
    return {k.split(".", 1)[1]: v for k, v in params.items() if k.startswith(prefix)}


def layer_params(stacked: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in stacked.items()}


def count_params(templates: Dict[str, ParamSpec]) -> int:
    n = 0
    for spec in templates.values():
        c = 1
        for s in spec.shape:
            c *= s
        n += c
    return n


def logits_f32(h_last: torch.Tensor, w_vocab: torch.Tensor) -> torch.Tensor:
    """float32 logits of the last position's hidden state (B, d) -> (B, V)."""
    return h_last.float() @ w_vocab.float()


class TransformerLM:
    # cache entries the serving engine grows before decode
    GROWING_CACHE = ("k", "v")

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing", *,
                 mesh=None, rules=None):
        self.cfg = cfg
        self.attn = check_attn(attn)
        self.remat_policy = L.check_remat(remat_policy)
        self.mesh = mesh
        self.rules = rules

    # ------------------------------------------------------------------
    # Parameter templates
    # ------------------------------------------------------------------
    def param_templates(self) -> Dict[str, ParamSpec]:
        c = self.cfg
        hd, H, Kv, d, f, V, Ln = c.hd, c.n_heads, c.n_kv_heads, c.d_model, c.d_ff, c.vocab, c.n_layers
        dt = c.param_dtype
        out_scale = 0.02 / (2 * Ln) ** 0.5
        t: Dict[str, ParamSpec] = {
            "embed": ParamSpec((V, d), dt, ("tp", None), init="normal"),
            "final_norm": ParamSpec((d,), dt, (None,), init="ones"),
        }
        if not c.tie_embeddings:
            t["lm_head"] = ParamSpec((d, V), dt, ("fsdp", "tp"), init="normal")
        blk = {
            "attn_norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
            "wq": ParamSpec((Ln, d, H * hd), dt, (None, "fsdp", "tp"), stacked=True),
            "wk": ParamSpec((Ln, d, Kv * hd), dt, (None, "fsdp", "tp"), stacked=True),
            "wv": ParamSpec((Ln, d, Kv * hd), dt, (None, "fsdp", "tp"), stacked=True),
            "wo": ParamSpec((Ln, H * hd, d), dt, (None, "tp", "fsdp"),
                            init="scaled", init_scale=out_scale, stacked=True),
            "mlp_norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
        }
        if c.qkv_bias:
            blk["bq"] = ParamSpec((Ln, H * hd), dt, (None, "tp"), init="zeros", stacked=True)
            blk["bk"] = ParamSpec((Ln, Kv * hd), dt, (None, "tp"), init="zeros", stacked=True)
            blk["bv"] = ParamSpec((Ln, Kv * hd), dt, (None, "tp"), init="zeros", stacked=True)
        if c.moe is not None:
            E = c.moe.n_experts
            blk["router"] = ParamSpec((Ln, d, E), dt, (None, "fsdp", None), stacked=True)
            blk["moe_gate"] = ParamSpec((Ln, E, d, f), dt, (None, "expert", "fsdp", "tp"), stacked=True)
            blk["moe_up"] = ParamSpec((Ln, E, d, f), dt, (None, "expert", "fsdp", "tp"), stacked=True)
            blk["moe_down"] = ParamSpec((Ln, E, f, d), dt, (None, "expert", "tp", "fsdp"),
                                        init="scaled", init_scale=out_scale, stacked=True)
        else:
            blk["w_gate"] = ParamSpec((Ln, d, f), dt, (None, "fsdp", "tp"), stacked=True)
            blk["w_up"] = ParamSpec((Ln, d, f), dt, (None, "fsdp", "tp"), stacked=True)
            blk["w_down"] = ParamSpec((Ln, f, d), dt, (None, "tp", "fsdp"),
                                      init="scaled", init_scale=out_scale, stacked=True)
        t.update({f"blocks.{k}": v for k, v in blk.items()})
        return t

    def param_count(self) -> int:
        return count_params(self.param_templates())

    def active_param_count(self) -> int:
        c = self.cfg
        if c.moe is None:
            return self.param_count()
        n = 0
        E, k = c.moe.n_experts, c.moe.top_k
        for name, spec in self.param_templates().items():
            cnt = 1
            for s in spec.shape:
                cnt *= s
            if "moe_" in name:
                cnt = cnt * k // E
            n += cnt
        return n

    # ------------------------------------------------------------------
    # Sharding helpers
    # ------------------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.rules is not None

    def _ws(self, x, *axes):
        """``x`` laid out as ``axes`` (the reference's
        ``with_sharding_constraint``): a ``redistribute`` on the mesh."""
        if not self.sharded:
            return x
        return L.redistribute(x, self.mesh, named_sharding(self.mesh, axes, self.rules,
                                                           x.shape).placements)

    def _dp_degree(self) -> int:
        """Data-parallel shards: the product of the batch axes' sizes."""
        if not self.sharded:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in self.rules.batch:
            n *= sizes.get(a, 1)
        return n

    def _gathered(self, w):
        """Weight ``w`` gathered over its FSDP axes (the backward pass
        reduce-scatters its gradient); as it is off the mesh."""
        if not self.sharded:
            return w
        from torch.distributed.tensor import Replicate

        return w.redistribute(self.mesh, [Replicate() if a in self.rules.fsdp else pl
                                          for a, pl in zip(self.mesh.mesh_dim_names,
                                                           w.placements)])

    def _layer(self, stacked, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights, gathered over their FSDP axes on a mesh."""
        return {k: self._gathered(w) for k, w in layer_params(stacked, i).items()}

    def _local(self, fn, placements, *args):
        """``fn`` on each rank's own pieces of ``args``, all laid out as
        ``placements`` (DTensor's ``local_map``); plain ``fn`` off the mesh."""
        if not self.sharded:
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map

        # a single output's placements go as a list (a tuple would list outputs)
        return local_map(fn, out_placements=list(placements),
                         in_placements=(placements,) * len(args),
                         device_mesh=self.mesh, redistribute_inputs=True)(*args)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _qkv(self, x, p, positions, positions3=None):
        """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,Kv,hd) with RoPE applied."""
        c = self.cfg
        B, S, _ = x.shape
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if c.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = self._split_heads(q, c.n_heads)
        k = self._split_heads(k, c.n_kv_heads)
        v = self._split_heads(v, c.n_kv_heads)
        return self._rope(q, positions, positions3), self._rope(k, positions, positions3), v

    def _split_heads(self, x, n: int):
        """(B, S, n·hd) -> (B, S, n, hd), laid out ("batch", None, "tp", None).
        On a mesh whose tp axes do not divide n the heads are gathered first:
        DTensor splits a sharded dim only where the shards hold whole heads."""
        B, S = x.shape[:2]
        if self.sharded and safe_entry(self.mesh, self.rules, "tp", n) is None:
            x = self._ws(x, "batch", None, None)
        return self._ws(x.reshape(B, S, n, self.cfg.hd), "batch", None, "tp", None)

    def _rope(self, x, positions, positions3):
        """RoPE (M-RoPE for the VLM) of x (B, S, heads, hd); on a mesh each
        rank rotates its own rows and heads."""
        c = self.cfg

        def rope(x, pos, pos3):
            if c.mrope:
                return L.apply_mrope(x, pos3, c.rope_theta)
            return L.apply_rope(x, pos, c.rope_theta, c.rope_pct)

        if not self.sharded:
            return rope(x, positions, positions3)
        from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
        from torch.distributed.tensor.experimental import local_map

        def placed(t, batch_dim):
            # t's batch dim split as x's is, every other dim whole
            if t is None:
                return None, None
            pl = [Shard(batch_dim) if p == Shard(0) else Replicate() for p in x.placements]
            if isinstance(t, DTensor):
                return t.redistribute(self.mesh, pl), pl
            return distribute_tensor(t, self.mesh, pl, src_data_rank=None), pl

        pos, pos_pl = placed(positions, 0)
        pos3, pos3_pl = placed(positions3, 1)
        return local_map(rope, out_placements=list(x.placements),
                         in_placements=(x.placements, pos_pl, pos3_pl),
                         device_mesh=self.mesh)(x, pos, pos3)

    def _mlp(self, x, p):
        c = self.cfg
        if c.moe is not None:
            return L.moe_block(x, p["router"], p["moe_gate"], p["moe_up"], p["moe_down"],
                               top_k=c.moe.top_k, capacity_factor=c.moe.capacity_factor,
                               n_groups=self._dp_degree())
        return L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), torch.zeros((), device=x.device)

    def _attend(self, q, kH, vH, causal: bool):
        """Full-sequence attention, the kernel or plain. On a mesh each rank
        attends over its own batch rows and its own heads; where the tp axes
        do not divide the heads (qwen2's 28 on 16) the plain attention splits
        the query rows over the sp axes instead (K and V whole on every rank,
        each rank's rows at their global offset), so no rank repeats
        another's work. The flash kernel has no query offset: there it runs
        on every head of the rank's rows."""
        c = self.cfg

        def attend(q, k, v, q_offset=0):
            if self.attn == "flash":
                return flash_attention(q, k, v, causal=causal, window=c.swa_window)
            return L.attention(q, k, v, causal=causal, q_offset=q_offset, window=c.swa_window,
                               score_dtype=getattr(torch, c.attn_score_dtype),
                               chunk_q=c.attn_chunk_q, chunk_kv=c.attn_chunk_kv)

        if not self.sharded:
            return attend(q, kH, vH)
        B, S, H = q.shape[:3]
        rows = safe_entry(self.mesh, self.rules, "sp", S)
        if (safe_entry(self.mesh, self.rules, "tp", H) is not None or self.attn == "flash"
                or rows is None):
            pl = named_sharding(self.mesh, ("batch", None, "tp", None), self.rules,
                                q.shape).placements
            return self._local(attend, pl, q, kH, vH)
        from torch.distributed.tensor import Partial, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        from torch.distributed.tensor.experimental import local_map

        bentry = safe_entry(self.mesh, self.rules, "batch", B)
        q_pl = spec_placements(self.mesh, PartitionSpec(bentry, rows, None, None))
        kv_pl = spec_placements(self.mesh, PartitionSpec(bentry, None, None, None))
        kv_grad = tuple(Partial() if p == Shard(1) else k for p, k in zip(q_pl, kv_pl))
        offset = compute_local_shape_and_global_offset(q.shape, self.mesh, q_pl)[1][1]
        return local_map(lambda q, k, v: attend(q, k, v, offset), out_placements=list(q_pl),
                         in_placements=(q_pl, kv_pl, kv_pl),
                         in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=self.mesh,
                         redistribute_inputs=True)(q, kH, vH)

    def _block_full(self, h, p, positions, positions3, causal=True):
        """One transformer block over a full sequence. Returns (h, (k, v), aux)."""
        c = self.cfg
        x = self._ws(L.rms_norm(h, p["attn_norm"]), "batch", None, None)
        q, k, v = self._qkv(x, p, positions, positions3)
        kH = self._ws(L.repeat_kv(k, c.n_heads), "batch", None, "tp", None)
        vH = self._ws(L.repeat_kv(v, c.n_heads), "batch", None, "tp", None)
        attn = self._attend(q, kH, vH, causal)
        B, S = h.shape[:2]
        # The row-parallel products (attention's output projection, the MLP's
        # down projection) are reduced where they are made, as GSPMD does: a
        # partial sum left in h would make the norm's output partial, and
        # DTensor would gather the next weights, forward and backward, to keep
        # it so. The attention output is laid out before the projection so
        # that the backward pass hands its view a gradient it can split into
        # heads.
        h = h + self._ws(self._ws(attn.reshape(B, S, -1), "batch", None, "tp") @ p["wo"],
                         "batch", None, None)
        x = self._ws(L.rms_norm(h, p["mlp_norm"]), "batch", None, None)
        mlp_out, aux = self._mlp(x, p)
        return h + self._ws(mlp_out, "batch", None, None), (k, v), aux

    def _lm_head(self, params):
        """(d, V) output projection; the transpose of embed when tied (phi-4);
        on a mesh gathered over its FSDP axes."""
        if "lm_head" not in params:
            return params["embed"].T
        return self._gathered(params["lm_head"])

    def _logits(self, params, h_last):
        return logits_f32(h_last, self._lm_head(params))

    # ------------------------------------------------------------------
    # Embedding
    # ------------------------------------------------------------------
    def _embed(self, params, batch):
        """Token embedding (+ additive patch-embedding stub for the VLM)."""
        h = self._lookup(batch["tokens"], params["embed"])
        if self.cfg.mrope and "patch_embeds" in batch:
            h = h + batch["patch_embeds"].to(h.dtype)
        return self._ws(h, "batch", None, None)

    def _lookup(self, tokens, table):
        """``F.embedding`` of the tokens. On a mesh the table is vocab-sharded:
        each rank looks up the tokens that fall in its rows and zeroes the
        rest, so the result is a partial sum over the vocab-cut mesh dims (no
        collective; ``_ws`` then reduces it). Indexing instead would make
        DTensor re-shard the whole table on every call; and DTensor's own
        masked-partial rule for ``F.embedding`` fails in the backward pass
        when the incoming gradient is a partial sum."""
        if not self.sharded:
            return F.embedding(tokens.long(), table)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
        from torch.distributed.tensor.experimental import local_map

        rows, (lo, _) = compute_local_shape_and_global_offset(table.shape, self.mesh,
                                                              table.placements)
        n = rows[0]
        batch = [p == Shard(0) for p in tokens.placements]
        cut = [p == Shard(0) for p in table.placements]
        out_pl = [Shard(0) if b else Partial() if c else Replicate() for b, c in zip(batch, cut)]
        grad_pl = [Partial() if b else Shard(0) if c else Replicate() for b, c in zip(batch, cut)]

        def lookup(tok, tab):
            ids = tok.long() - lo
            inside = (ids >= 0) & (ids < n)
            return F.embedding(ids.clamp(0, n - 1), tab).masked_fill(~inside[..., None], 0)

        return local_map(lookup, out_placements=out_pl,
                         in_placements=(tokens.placements, table.placements),
                         in_grad_placements=(tokens.placements, grad_pl),
                         device_mesh=self.mesh)(tokens, table)

    def _positions(self, batch, B, S, offset=0):
        c = self.cfg
        pos = batch.get("positions")
        if pos is None:
            pos = (torch.arange(S, device=batch["tokens"].device)[None, :] + offset).expand(B, S)
        if c.mrope:
            p3 = batch.get("positions3")
            if p3 is None:
                p3 = pos[None].expand(3, B, S)
            elif p3.dim() == 3 and p3.shape[1] == 3:
                p3 = p3.permute(1, 0, 2)   # (B, 3, S) input layout -> (3, B, S)
            return pos, p3
        return pos, None

    # ------------------------------------------------------------------
    # Entry points
    # ------------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE. batch: tokens (B,S) int, labels (B,S) int
        (+ patch_embeds / positions3 for the VLM). Keeps the autograd graph
        when the parameters require grad, as the reference's loss is what its
        train step differentiates; the flash kernel is forward-only, so a
        differentiated loss takes ``attn="plain"``."""
        c = self.cfg
        B, S = batch["tokens"].shape
        h = self._embed(params, batch)
        positions, positions3 = self._positions(batch, B, S)
        stacked = stacked_params(params)
        aux = torch.zeros((), device=h.device)

        def layer(h, p):
            h, _, a = self._block_full(h, p, positions, positions3)
            return h, a

        layer = L.remat(layer, self.remat_policy)
        for i in L.layer_range(c.n_layers):
            h, a = layer(h, self._layer(stacked, i))
            aux = aux + a
        h = self._ws(L.rms_norm(h, params["final_norm"]), "batch", None, None)
        ce = L.chunked_cross_entropy(h, self._lm_head(params), batch["labels"])
        if c.moe is not None:
            ce = ce + 0.01 * aux / c.n_layers
        return ce

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full forward pass; returns (last-position logits (B, V) float32,
        cache {"k", "v": (L, B, S, Kv, hd), "len": S}); on a mesh the cache
        is sequence-sharded."""
        B, S = batch["tokens"].shape
        h = self._embed(params, batch)
        positions, positions3 = self._positions(batch, B, S)
        stacked = stacked_params(params)
        ks, vs = [], []
        for i in L.layer_range(self.cfg.n_layers):
            h, (k, v), _ = self._block_full(h, self._layer(stacked, i), positions, positions3)
            ks.append(self._ws(k, "batch", "sp", None, None))
            vs.append(self._ws(v, "batch", "sp", None, None))
        h = L.rms_norm(h, params["final_norm"])
        cache = {"k": self._ws(torch.stack(ks), None, "batch", "sp", None, None),
                 "v": self._ws(torch.stack(vs), None, "batch", "sp", None, None), "len": S}
        return self._logits(params, h[:, -1]), cache

    def _write_kv(self, cache, i: int, pos: int, new) -> None:
        """``cache[i, :, pos] = new[:, 0]`` in place. On a mesh only the rank
        that owns sequence position ``pos`` writes, into its own shard: a
        DTensor ``index_put`` on the sharded dim would move the cache."""
        if not self.sharded:
            cache[i, :, pos] = new[:, 0].to(cache.dtype)
            return
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        bentry = safe_entry(self.mesh, self.rules, "batch", new.shape[0])
        new = new.redistribute(self.mesh, spec_placements(
            self.mesh, PartitionSpec(bentry, None, None, None))).to_local()
        shape, offset = compute_local_shape_and_global_offset(cache.shape, self.mesh,
                                                              cache.placements)
        lo = offset[2]
        if lo <= pos < lo + shape[2]:
            cache.to_local()[i, :, pos - lo] = new[:, 0].to(cache.dtype)

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One-token decode. batch: tokens (B, 1). cache: k/v (L, B, Smax, Kv, hd)
        + ``len`` (an int). Writes the new K/V into ``cache`` in place and
        returns (logits (B, V) float32, cache with ``len`` advanced)."""
        c = self.cfg
        B = batch["tokens"].shape[0]
        t = int(cache["len"])
        h = self._embed(params, batch)                     # (B, 1, d)
        positions = torch.full((B, 1), t, dtype=torch.int64, device=h.device)
        positions3 = positions[None].expand(3, B, 1) if c.mrope else None
        stacked = stacked_params(params)

        k_all, v_all = cache["k"], cache["v"]
        Smax = k_all.shape[2]
        rolling = bool(c.swa_window) and Smax <= c.swa_window
        # rolling SWA cache: writes wrap modulo the window; every resident
        # entry is in-window by construction, so no window mask is needed
        wpos = (t % Smax) if rolling else t
        valid_len = min(t + 1, Smax)
        window = 0 if rolling else c.swa_window
        sp = self.sharded and axis_sizes(self.mesh).get("model", 1) > 1

        def attend(q, kH, vH):
            # query acts at index valid_len-1: cache entries < valid_len are
            # visible, garbage beyond is masked (order within a rolled window
            # is irrelevant to softmax)
            return L.attention(q, kH, vH, causal=True, q_offset=valid_len - 1, window=window)

        for i in L.layer_range(c.n_layers):
            p = self._layer(stacked, i)
            x = L.rms_norm(h, p["attn_norm"])
            q, k, v = self._qkv(x, p, positions, positions3)
            # in place, where the reference's dynamic_update_slice makes a new cache
            self._write_kv(k_all, i, wpos, k)
            self._write_kv(v_all, i, wpos, v)
            if sp:
                bentry = safe_entry(self.mesh, self.rules, "batch", B)
                attn = L.decode_attention_sp(q[:, 0], k_all[i], v_all[i], valid_len,
                                             mesh=self.mesh, sp_axis="model",
                                             batch_axes=(bentry,), window=window)
            else:
                kH = L.repeat_kv(k_all[i], c.n_heads)
                vH = L.repeat_kv(v_all[i], c.n_heads)
                pl = (named_sharding(self.mesh, ("batch", None, None, None), self.rules,
                                     q.shape).placements if self.sharded else None)
                attn = self._local(attend, pl, q, kH, vH)[:, 0]
            h = h + self._ws((attn.reshape(B, -1) @ p["wo"])[:, None], "batch", None, None)
            x = L.rms_norm(h, p["mlp_norm"])
            mlp_out, _ = self._mlp(x, p)
            h = h + self._ws(mlp_out, "batch", None, None)
        h = L.rms_norm(h, params["final_norm"])
        return self._logits(params, h[:, -1]), {"k": k_all, "v": v_all, "len": t + 1}

    # ------------------------------------------------------------------
    # Cache specs
    # ------------------------------------------------------------------
    def cache_templates(self, batch: int, seq: int) -> Dict[str, ParamSpec]:
        c = self.cfg
        # rolling SWA cache for long-context decode
        S = min(seq, c.swa_window) if (c.swa_window and seq > c.swa_window) else seq
        kv = (c.n_layers, batch, S, c.n_kv_heads, c.hd)
        axes = (None, "batch", "sp", None, None)
        return {
            "k": ParamSpec(kv, c.act_dtype, axes),
            "v": ParamSpec(kv, c.act_dtype, axes),
            "len": ParamSpec((), "int32", ()),
        }
