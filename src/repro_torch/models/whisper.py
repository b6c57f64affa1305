# Port of src/repro/models/whisper.py: rewritten in PyTorch, names and layouts kept.
"""Whisper-medium encoder-decoder backbone on one card.

As in the reference, the conv audio frontend is a stub: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d) in the activation dtype.
Downstream is real: bidirectional encoder layers (MHA + GELU MLP,
pre-LayerNorm), decoder layers (causal self-attention, cross-attention, GELU
MLP), sinusoidal positions, logits tied to the decoder token embedding.

What changes from the reference: ``lax.scan`` over stacked layers becomes a
Python loop, each encoder and decoder layer wrapped by :func:`layers.remat`
under ``remat_policy`` (the reference's ``jax.checkpoint``); the sharding
constraints are dropped. ``attn="flash"``
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
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import (check_attn, count_params, layer_params, logits_f32,
                                            stacked_params)
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


class WhisperModel:
    # cache entries the serving engine grows before decode: the decoder's
    # self-attention K/V; the cross K/V stay the encoder's S_enc frames
    GROWING_CACHE = ("self_k", "self_v")

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing"):
        self.cfg = cfg
        self.attn = check_attn(attn)
        self.remat_policy = L.check_remat(remat_policy)

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

    def param_count(self) -> int:
        return count_params(self.param_templates())

    active_param_count = param_count

    # ------------------------------------------------------------------
    def _mha(self, x, kv_src, p, prefix, causal):
        c = self.cfg
        B, S, _ = x.shape
        Skv = kv_src.shape[1]
        q = (x @ p[f"{prefix}_wq"]).reshape(B, S, c.n_heads, c.hd)
        k = (kv_src @ p[f"{prefix}_wk"]).reshape(B, Skv, c.n_kv_heads, c.hd)
        v = (kv_src @ p[f"{prefix}_wv"]).reshape(B, Skv, c.n_kv_heads, c.hd)
        kH, vH = L.repeat_kv(k, c.n_heads), L.repeat_kv(v, c.n_heads)
        if self.attn == "flash":
            attn = flash_attention(q, kH, vH, causal=causal)
        else:
            attn = L.attention(q, kH, vH, causal=causal,
                               score_dtype=getattr(torch, c.attn_score_dtype))
        return attn.reshape(B, S, -1) @ p[f"{prefix}_wo"], (k, v)

    @staticmethod
    def _mlp(h, p):
        x = L.layer_norm(h, p["mlp_norm"], p["mlp_norm_b"])
        return h + L.gelu_mlp(x, p["mlp_w_in"], p["mlp_b_in"], p["mlp_w_out"], p["mlp_b_out"])

    def _encoder(self, params, frames):
        """frames: (B, S_enc, d) precomputed conv-frontend embeddings."""
        _, S, d = frames.shape
        h = frames + sinusoid_positions(S, d, device=frames.device).to(frames.dtype)[None]
        stacked = stacked_params(params, "enc.")

        def layer(h, p):
            x = L.layer_norm(h, p["attn_norm"], p["attn_norm_b"])
            h = h + self._mha(x, x, p, "attn", causal=False)[0]
            return self._mlp(h, p)

        layer = L.remat(layer, self.remat_policy)
        for i in range(self.cfg.n_layers):
            h = layer(h, layer_params(stacked, i))
        return L.layer_norm(h, params["enc_final_norm"], params["enc_final_bias"])

    def _decoder_full(self, params, tokens, enc_out):
        S = tokens.shape[1]
        h = params["embed"][tokens.long()]
        h = h + sinusoid_positions(S, self.cfg.d_model, device=h.device).to(h.dtype)[None]
        stacked = stacked_params(params, "dec.")

        def layer(h, p):
            x = L.layer_norm(h, p["self_norm"], p["self_norm_b"])
            a, (sk, sv) = self._mha(x, x, p, "self", causal=True)
            h = h + a
            x = L.layer_norm(h, p["cross_norm"], p["cross_norm_b"])
            a, (ck, cv) = self._mha(x, enc_out, p, "cross", causal=False)
            return self._mlp(h + a, p), (sk, sv, ck, cv)

        layer = L.remat(layer, self.remat_policy)
        caches = ([], [], [], [])
        for i in range(self.cfg.n_layers):
            h, kv = layer(h, layer_params(stacked, i))
            for lst, t in zip(caches, kv):
                lst.append(t)
        h = L.layer_norm(h, params["dec_final_norm"], params["dec_final_bias"])
        return h, tuple(torch.stack(lst) for lst in caches)

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
        "len": S_dec})."""
        enc_out = self._encoder(params, batch["frames"])
        h, (sk, sv, ck, cv) = self._decoder_full(params, batch["tokens"], enc_out)
        cache = {"self_k": sk, "self_v": sv, "cross_k": ck, "cross_v": cv,
                 "len": batch["tokens"].shape[1]}
        return logits_f32(h[:, -1], params["embed"].T), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One decoder token. cache: self_k/v (L,B,Smax,Kv,hd) growing, written
        in place at ``len``; cross_k/v (L,B,S_enc,Kv,hd) fixed."""
        c = self.cfg
        B = batch["tokens"].shape[0]
        t = int(cache["len"])
        h = params["embed"][batch["tokens"].long()]
        h = h + sinusoid_positions(1, c.d_model, offset=t, device=h.device).to(h.dtype)[None]
        stacked = stacked_params(params, "dec.")
        for i in range(c.n_layers):
            p = layer_params(stacked, i)
            skc, svc = cache["self_k"][i], cache["self_v"][i]
            ckc, cvc = cache["cross_k"][i], cache["cross_v"][i]
            # self attention against the growing cache
            x = L.layer_norm(h, p["self_norm"], p["self_norm_b"])
            q = (x @ p["self_wq"]).reshape(B, 1, c.n_heads, c.hd)
            skc[:, t:t + 1] = (x @ p["self_wk"]).reshape(B, 1, c.n_kv_heads, c.hd).to(skc.dtype)
            svc[:, t:t + 1] = (x @ p["self_wv"]).reshape(B, 1, c.n_kv_heads, c.hd).to(svc.dtype)
            attn = L.attention(q, L.repeat_kv(skc, c.n_heads), L.repeat_kv(svc, c.n_heads),
                               causal=True, q_offset=t)
            h = h + attn.reshape(B, 1, -1) @ p["self_wo"]
            # cross attention against the fixed encoder cache
            x = L.layer_norm(h, p["cross_norm"], p["cross_norm_b"])
            q = (x @ p["cross_wq"]).reshape(B, 1, c.n_heads, c.hd)
            ca = L.attention(q, L.repeat_kv(ckc, c.n_heads), L.repeat_kv(cvc, c.n_heads),
                             causal=False)
            h = h + ca.reshape(B, 1, -1) @ p["cross_wo"]
            h = self._mlp(h, p)
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
