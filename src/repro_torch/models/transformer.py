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
out (with the helpers every family shares, ``models.base.ModelBase``):
each layer's weights are gathered over their FSDP axes where the layer uses
them (the backward pass reduce-scatters their gradients), the
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

from repro_torch.models import layers as L
from repro_torch.models.base import ModelBase, logits_f32, stacked_params
from repro_torch.sharding.rules import ParamSpec

__all__ = ["TransformerLM"]


class TransformerLM(ModelBase):
    # cache entries the serving engine grows before decode
    GROWING_CACHE = ("k", "v")

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
    # Blocks
    # ------------------------------------------------------------------
    def _mlp(self, x, p):
        c = self.cfg
        if c.moe is not None:
            return L.moe_block(x, p["router"], p["moe_gate"], p["moe_up"], p["moe_down"],
                               top_k=c.moe.top_k, capacity_factor=c.moe.capacity_factor,
                               n_groups=self._dp_degree())
        return L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"]), torch.zeros((), device=x.device)

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
        h = h + self._ws(self._merge_heads(attn) @ p["wo"], "batch", None, None)
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
        h = self._embed_tokens(batch["tokens"], params["embed"])
        if self.cfg.mrope and "patch_embeds" in batch:
            h = self._ws(h + batch["patch_embeds"].to(h.dtype), "batch", None, None)
        return h

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

        for i in L.layer_range(c.n_layers):
            p = self._layer(stacked, i)
            x = L.rms_norm(h, p["attn_norm"])
            q, k, v = self._qkv(x, p, positions, positions3)
            # in place, where the reference's dynamic_update_slice makes a new cache
            self._write_kv(k_all, i, wpos, k)
            self._write_kv(v_all, i, wpos, v)
            # the query acts at index valid_len-1: cache entries < valid_len
            # are visible, garbage beyond is masked (order within a rolled
            # window is irrelevant to softmax)
            attn = self._decode_attend(q, k_all[i], v_all[i], valid_len, window=window)
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
