# Port of src/repro/models/whisper.py: rewritten in PyTorch, names and layouts kept.
"""Whisper-medium encoder-decoder backbone, on one card or on a device mesh.

As in the reference, the conv audio frontend is a stub: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d) in the activation dtype.
Downstream is real: bidirectional encoder layers (MHA + GELU MLP,
pre-LayerNorm), decoder layers (causal self-attention, cross-attention, GELU
MLP), sinusoidal positions, logits tied to the decoder token embedding.

What changes from the reference: ``lax.scan`` over stacked layers becomes a
Python loop, each encoder and decoder layer wrapped by :func:`layers.remat`
under ``remat_policy`` (the reference's ``jax.checkpoint``). ``attn="flash"``
(the default) runs every full-sequence attention of ``loss`` and ``prefill``
through :func:`repro_torch.kernels.flash_attention.flash_attention`: the
encoder's bidirectional self attention, the decoder's causal self attention
and the cross attention (non-causal, Sq != Sk). Decode keeps
:func:`layers.attention`, as the transformer's decode does, and writes the new
self-attention K/V into the preallocated cache in place.

Decode's cross attention runs over exactly the S_enc encoder frames of the
fixed cross cache, as the reference model computes it. Only ``self_k`` and
``self_v`` grow during decode (``GROWING_CACHE``); the reference's serving
engine also pads the cross cache, whose zero keys then join the softmax, and
that is not carried over. ``cache_templates`` is the reference's, cross
entries sized by ``seq`` included.

On a mesh (``mesh`` and ``rules``) the parameters and inputs are DTensors laid
out by the reference's rules (``models.base``): the reference's
``with_sharding_constraint`` points are ``_ws`` calls, each layer's weights are
gathered over their FSDP axes, every attention (encoder, decoder self and
cross) runs on each rank's own batch rows and heads under ``local_map`` (the
flash kernel included), ``prefill`` returns its caches sequence-sharded, and
decode on a model axis wider than one runs both of its attentions through
:func:`layers.decode_attention_sp` (the cross attention over the cross
cache's whole length).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import ModelBase, logits_f32, stacked_params
from repro_torch.sharding.rules import ParamSpec

__all__ = ["WhisperModel", "sinusoid_positions"]


def sinusoid_positions(S: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """(S, d) float32: sin of the d/2 frequencies, then their cos. The
    frequency divisors are rounded once from float64, as XLA's float32 power
    is, so the angles equal the reference's bit for bit."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None] + offset
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, (2 * dim / d).double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperModel(ModelBase):
    # cache entries the serving engine grows before decode: the decoder's
    # self-attention K/V; the cross K/V stay the encoder's S_enc frames
    GROWING_CACHE = ("self_k", "self_v")

    def param_templates(self) -> Dict[str, ParamSpec]:
        c = self.cfg
        d, f, V, Ln = c.d_model, c.d_ff, c.vocab, c.n_layers
        hd, H, Kv = c.hd, c.n_heads, c.n_kv_heads
        dt = c.param_dtype
        out_scale = 0.02 / (2 * 2 * Ln) ** 0.5
        t = {
            "embed": ParamSpec((V, d), dt, ("tp", None)),   # decoder tokens; tied logits
            "enc_final_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "enc_final_bias": ParamSpec((d,), dt, (None,), init="zeros"),
            "dec_final_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "dec_final_bias": ParamSpec((d,), dt, (None,), init="zeros"),
        }

        def attn_block(prefix, kv_heads):
            return {
                f"{prefix}_norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
                f"{prefix}_norm_b": ParamSpec((Ln, d), dt, (None, None), init="zeros", stacked=True),
                f"{prefix}_wq": ParamSpec((Ln, d, H * hd), dt, (None, "fsdp", "tp"), stacked=True),
                f"{prefix}_wk": ParamSpec((Ln, d, kv_heads * hd), dt, (None, "fsdp", "tp"), stacked=True),
                f"{prefix}_wv": ParamSpec((Ln, d, kv_heads * hd), dt, (None, "fsdp", "tp"), stacked=True),
                f"{prefix}_wo": ParamSpec((Ln, H * hd, d), dt, (None, "tp", "fsdp"),
                                          init="scaled", init_scale=out_scale, stacked=True),
            }

        def mlp_block(prefix):
            return {
                f"{prefix}_norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
                f"{prefix}_norm_b": ParamSpec((Ln, d), dt, (None, None), init="zeros", stacked=True),
                f"{prefix}_w_in": ParamSpec((Ln, d, f), dt, (None, "fsdp", "tp"), stacked=True),
                f"{prefix}_b_in": ParamSpec((Ln, f), dt, (None, "tp"), init="zeros", stacked=True),
                f"{prefix}_w_out": ParamSpec((Ln, f, d), dt, (None, "tp", "fsdp"),
                                             init="scaled", init_scale=out_scale, stacked=True),
                f"{prefix}_b_out": ParamSpec((Ln, d), dt, (None, None), init="zeros", stacked=True),
            }

        for grp in (attn_block("enc.attn", Kv), mlp_block("enc.mlp"),
                    attn_block("dec.self", Kv), attn_block("dec.cross", Kv),
                    mlp_block("dec.mlp")):
            t.update(grp)
        return t

    # ------------------------------------------------------------------
    def _heads(self, x, w):
        """x @ w split into heads: (B, S, heads, hd), laid out ("batch", None,
        "tp", None)."""
        return self._split_heads(x @ w, w.shape[-1] // self.cfg.hd)

    def _mha(self, x, kv_src, p, prefix, causal):
        c = self.cfg
        q = self._heads(x, p[f"{prefix}_wq"])
        k = self._heads(kv_src, p[f"{prefix}_wk"])
        v = self._heads(kv_src, p[f"{prefix}_wv"])
        kH = self._ws(L.repeat_kv(k, c.n_heads), "batch", None, "tp", None)
        vH = self._ws(L.repeat_kv(v, c.n_heads), "batch", None, "tp", None)
        attn = self._attend(q, kH, vH, causal)
        return self._out(attn, p[f"{prefix}_wo"]), (k, v)

    def _out(self, attn, wo):
        """The attention output (B, S, H, hd) through ``wo``, reduced where it
        is made."""
        return self._ws(self._merge_heads(attn) @ wo, "batch", None, None)

    def _norm(self, h, p, name):
        return self._ws(L.layer_norm(h, p[f"{name}_norm"], p[f"{name}_norm_b"]),
                        "batch", None, None)

    def _mlp(self, h, p):
        x = self._norm(h, p, "mlp")
        o = self._ws(L.gelu_mlp(x, p["mlp_w_in"], p["mlp_b_in"], p["mlp_w_out"], None),
                     "batch", None, None)
        return h + (o + p["mlp_b_out"])

    def _positions(self, S: int, dtype, device, offset: int = 0):
        """Sinusoidal positions (1, S, d) in ``dtype``, replicated on a mesh."""
        pos = sinusoid_positions(S, self.cfg.d_model, offset=offset, device=device)
        return self._replicated(pos.to(dtype)[None])

    def _encoder(self, params, frames):
        """frames: (B, S_enc, d) precomputed conv-frontend embeddings."""
        S = frames.shape[1]
        h = self._ws(frames + self._positions(S, frames.dtype, frames.device),
                     "batch", None, None)
        stacked = stacked_params(params, "enc.")

        def layer(h, p):
            x = self._norm(h, p, "attn")
            h = h + self._mha(x, x, p, "attn", causal=False)[0]
            return self._mlp(h, p)

        layer = L.remat(layer, self.remat_policy)
        for i in L.layer_range(self.cfg.n_layers):
            h = layer(h, self._layer(stacked, i))
        return self._ws(L.layer_norm(h, params["enc_final_norm"], params["enc_final_bias"]),
                        "batch", None, None)

    def _decoder_full(self, params, tokens, enc_out, with_cache: bool = False):
        """(final hidden states, and with ``with_cache`` the per-layer self
        and cross K/V stacked (L, B, S, Kv, hd), laid out ("batch", "sp"))."""
        S = tokens.shape[1]
        h = self._embed_tokens(tokens, params["embed"])
        h = h + self._positions(S, h.dtype, tokens.device)
        stacked = stacked_params(params, "dec.")

        def layer(h, p):
            x = self._norm(h, p, "self")
            a, (sk, sv) = self._mha(x, x, p, "self", causal=True)
            h = h + a
            x = self._norm(h, p, "cross")
            a, (ck, cv) = self._mha(x, enc_out, p, "cross", causal=False)
            return self._mlp(h + a, p), (sk, sv, ck, cv)

        layer = L.remat(layer, self.remat_policy)
        caches = ([], [], [], [])
        for i in L.layer_range(self.cfg.n_layers):
            h, kv = layer(h, self._layer(stacked, i))
            if with_cache:
                for lst, t in zip(caches, kv):
                    lst.append(self._ws(t, "batch", "sp", None, None))
        h = self._ws(L.layer_norm(h, params["dec_final_norm"], params["dec_final_bias"]),
                     "batch", None, None)
        if not with_cache:
            return h, None
        return h, tuple(self._ws(torch.stack(lst), None, "batch", "sp", None, None)
                        for lst in caches)

    # ------------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """batch: frames (B, S_enc, d), tokens (B, S_dec), labels (B, S_dec).
        Differentiable (with ``attn="plain"``: the flash kernel is
        forward-only)."""
        enc_out = self._encoder(params, batch["frames"])
        h, _ = self._decoder_full(params, batch["tokens"], enc_out)
        return L.chunked_cross_entropy(h, params["embed"].T, batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch):
        """(last-position logits (B, V) float32, cache {"self_k", "self_v":
        (L, B, S_dec, Kv, hd); "cross_k", "cross_v": (L, B, S_enc, Kv, hd);
        "len": S_dec}); on a mesh every cache entry is sequence-sharded."""
        enc_out = self._encoder(params, batch["frames"])
        h, (sk, sv, ck, cv) = self._decoder_full(params, batch["tokens"], enc_out,
                                                 with_cache=True)
        cache = {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv,
                 "len": batch["tokens"].shape[1]}
        return logits_f32(h[:, -1], params["embed"].T), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One decoder token. cache: self_k/v (L,B,Smax,Kv,hd) growing, written
        in place at ``len``; cross_k/v (L,B,S_enc,Kv,hd) fixed."""
        c = self.cfg
        t = int(cache["len"])
        h = self._embed_tokens(batch["tokens"], params["embed"])
        h = h + self._positions(1, h.dtype, batch["tokens"].device, offset=t)
        stacked = stacked_params(params, "dec.")
        for i in L.layer_range(c.n_layers):
            p = self._layer(stacked, i)
            # self attention against the growing cache
            x = self._norm(h, p, "self")
            q = self._heads(x, p["self_wq"])
            self._write_kv(cache["self_k"], i, t, self._heads(x, p["self_wk"]))
            self._write_kv(cache["self_v"], i, t, self._heads(x, p["self_wv"]))
            attn = self._decode_attend(q, cache["self_k"][i], cache["self_v"][i], t + 1)
            h = h + self._out(attn[:, None], p["self_wo"])
            # cross attention against the fixed encoder cache, all of it
            x = self._norm(h, p, "cross")
            q = self._heads(x, p["cross_wq"])
            ckc, cvc = cache["cross_k"][i], cache["cross_v"][i]
            ca = self._decode_attend(q, ckc, cvc, ckc.shape[1], causal=False)
            h = self._mlp(h + self._out(ca[:, None], p["cross_wo"]), p)
        h = L.layer_norm(h, params["dec_final_norm"], params["dec_final_bias"])
        return logits_f32(h[:, -1], params["embed"].T), dict(cache, len=t + 1)

    def cache_templates(self, batch: int, seq: int) -> Dict[str, ParamSpec]:
        c = self.cfg
        kv = (c.n_layers, batch, seq, c.n_kv_heads, c.hd)
        axes = (None, "batch", "sp", None, None)
        return {
            "self_k": ParamSpec(kv, c.act_dtype, axes),
            "self_v": ParamSpec(kv, c.act_dtype, axes),
            "cross_k": ParamSpec(kv, c.act_dtype, axes),
            "cross_v": ParamSpec(kv, c.act_dtype, axes),
            "len": ParamSpec((), "int32", ()),
        }
