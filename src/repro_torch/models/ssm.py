# Port of src/repro/models/ssm.py: rewritten in PyTorch, names and layouts kept.
"""State-space models on one card: Mamba-1 (falcon-mamba-7b) and the
Mamba-2/SSD hybrid with one shared attention block (zamba2-2.7b).

Parameters are the reference's flat dicts (``embed``, ``final_norm``,
``lm_head``, zamba2's ``shared.*`` and the per-layer ``blocks.*`` tensors
stacked on a leading layer dim); ``A_log``, ``D`` and zamba2's ``dt_bias`` are
float32 inside bf16 models, and every recurrence runs in float32.

What changes from the reference:

* ``lax.scan`` over stacked layers and over sequence chunks becomes a Python
  loop; each layer of ``loss`` and each chunk body of the scans is wrapped by
  :func:`layers.remat` under ``remat_policy``, where the reference wraps them
  in ``jax.checkpoint``; the sharding constraints are dropped (one card).
* Mamba-1's ``associative_scan`` inside a chunk becomes a log-depth doubling
  (Hillis-Steele) scan with the same combine ``(a1*a2, b1*a2 + b2)``: 7 steps at
  chunk 128. The chunk rule (``chunk = min(chunk, S)``, halved until it divides
  S) is the reference's.
* The depthwise causal conv is ``F.conv1d`` with ``groups=C`` in float32 (the
  reference's NWC layout transposed to NCW).
* The decode steps write zamba2's shared-attention K/V into the preallocated
  cache in place, as ``TransformerLM.decode_step`` does; the O(1) SSM and conv
  states come back as new tensors.
* With no mesh, the shared block's decode is ``layers.attention`` with
  ``q_offset`` (the reference's single-device branch); ``decode_attention_sp``
  waits for the mesh slice. Its full-sequence attention takes the flash kernel
  under ``attn="flash"`` and ``layers.attention`` under ``"plain"``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.transformer import (check_attn, count_params, layer_params, logits_f32,
                                            stacked_params)
from repro_torch.sharding.rules import ParamSpec

__all__ = ["MambaLM", "Zamba2LM"]


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B, S, C); w: (C, K); b: (C,)."""
    K = w.shape[-1]
    xp = F.pad(x.float().transpose(1, 2), (K - 1, 0))              # (B, C, K-1+S)
    out = F.conv1d(xp, w.float()[:, None, :], groups=w.shape[0])   # (B, C, S)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-token depthwise conv. x_t: (B, C); conv_state: (B, K-1, C)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,ck->bc", window.float(), w.float())
    out = (out + b.float()).to(x_t.dtype)
    return out, window[:, 1:]


def _param_free_rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along dim 1 from h = 0:
    (prod a_1..t, h_t). Hillis-Steele doubling, ceil(log2 n) steps, each
    combining a position with the one ``off`` before it."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], b[:, :-off], a[:, off:])], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _chunk_len(chunk: int, S: int) -> int:
    """The reference's chunk rule: at most S, halved until it divides S."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


# ===========================================================================
# Mamba-1 (falcon-mamba-7b)
# ===========================================================================

class MambaLM:
    # cache entries the serving engine grows before decode: none, the SSM and
    # conv states are O(1) in the sequence
    GROWING_CACHE = ()

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing"):
        """``attn`` is accepted for a uniform ``get_model`` and unused: the
        model has no attention."""
        assert cfg.ssm is not None and cfg.ssm.version == 1
        self.cfg = cfg
        self.attn = check_attn(attn)
        self.remat_policy = L.check_remat(remat_policy)

    @property
    def dt_rank(self) -> int:
        c = self.cfg
        return c.ssm.dt_rank or -(-c.d_model // 16)

    def param_templates(self) -> Dict[str, ParamSpec]:
        c = self.cfg
        d, V, Ln = c.d_model, c.vocab, c.n_layers
        DI, N, K, R = c.d_inner, c.ssm.d_state, c.ssm.d_conv, self.dt_rank
        dt = c.param_dtype
        out_scale = 0.02 / (2 * Ln) ** 0.5
        t = {
            "embed": ParamSpec((V, d), dt, ("tp", None)),
            "final_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "lm_head": ParamSpec((d, V), dt, ("fsdp", "tp")),
        }
        blk = {
            "norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
            "in_proj": ParamSpec((Ln, d, 2 * DI), dt, (None, "fsdp", "tp"), stacked=True),
            "conv_w": ParamSpec((Ln, DI, K), dt, (None, "tp", None), stacked=True),
            "conv_b": ParamSpec((Ln, DI), dt, (None, "tp"), init="zeros", stacked=True),
            "x_proj": ParamSpec((Ln, DI, R + 2 * N), dt, (None, "tp", None), stacked=True),
            "dt_proj": ParamSpec((Ln, R, DI), dt, (None, None, "tp"), stacked=True),
            "dt_bias": ParamSpec((Ln, DI), dt, (None, "tp"), init="zeros", stacked=True),
            # A_log/D in fp32: the recurrence is numerically delicate
            "A_log": ParamSpec((Ln, DI, N), "float32", (None, "tp", None), init="ones", stacked=True),
            "D": ParamSpec((Ln, DI), "float32", (None, "tp"), init="ones", stacked=True),
            "out_proj": ParamSpec((Ln, DI, d), dt, (None, "tp", "fsdp"),
                                  init="scaled", init_scale=out_scale, stacked=True),
        }
        t.update({f"blocks.{k}": v for k, v in blk.items()})
        return t

    def param_count(self) -> int:
        return count_params(self.param_templates())

    active_param_count = param_count

    # ------------------------------------------------------------------
    def _ssm_inputs(self, x, p):
        """x: (B, S, DI) post-conv. Returns dt (B,S,DI) f32, Bs/Cs (B,S,N) f32."""
        c = self.cfg
        N, R = c.ssm.d_state, self.dt_rank
        proj = (x @ p["x_proj"]).float()
        dt_in, Bs, Cs = torch.split(proj, [R, N, N], dim=-1)
        # falcon-mamba applies parameter-free RMS norm to dt/B/C streams
        dt_in, Bs, Cs = _param_free_rms(dt_in), _param_free_rms(Bs), _param_free_rms(Cs)
        dt = dt_in @ p["dt_proj"].float()
        return F.softplus(dt + p["dt_bias"].float()), Bs, Cs

    def _selective_scan(self, x, dt, A, Bs, Cs, h0, chunk):
        """Chunked selective scan.

        x/dt: (B, S, DI) f32; A: (DI, N) f32 (negative); Bs/Cs: (B, S, N) f32;
        h0: (B, DI, N) f32. Returns (y (B, S, DI) f32, h_final).
        """
        S = x.shape[1]
        chunk = _chunk_len(chunk, S)

        def chunk_body(h, xch, dtch, Bch, Cch):
            a = torch.exp(dtch[..., None] * A)                      # (B,c,DI,N)
            b = (dtch * xch)[..., None] * Bch[:, :, None, :]
            aP, bP = _affine_scan(a, b)
            hs = aP * h[:, None] + bP                               # (B,c,DI,N)
            return hs[:, -1], torch.einsum("bcdn,bcn->bcd", hs, Cch)

        chunk_body = L.remat(chunk_body, self.remat_policy)
        h, ys = h0, []
        for s0 in range(0, S, chunk):
            h, y = chunk_body(h, *(v[:, s0:s0 + chunk] for v in (x, dt, Bs, Cs)))
            ys.append(y)
        return torch.cat(ys, dim=1), h

    def _block_full(self, h, p):
        """One block over a full sequence: (h + out, (final SSM state, conv
        tail = the last K-1 PRE-conv inputs, what ``_conv_step`` consumes))."""
        c = self.cfg
        B = h.shape[0]
        K = c.ssm.d_conv
        x = L.rms_norm(h, p["norm"])
        xi, z = (x @ p["in_proj"]).chunk(2, dim=-1)
        conv_tail = xi[:, -(K - 1):, :] if K > 1 else xi[:, :0, :]
        xi = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
        dt, Bs, Cs = self._ssm_inputs(xi, p)
        A = -torch.exp(p["A_log"].float())
        h0 = torch.zeros((B, c.d_inner, c.ssm.d_state), dtype=torch.float32, device=h.device)
        y, hN = self._selective_scan(xi.float(), dt, A, Bs, Cs, h0, c.ssm.chunk)
        y = y + p["D"].float() * xi.float()
        y = (y * F.silu(z.float())).to(h.dtype)
        return h + y @ p["out_proj"], (hN, conv_tail)

    # ------------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE; differentiable, as the reference's."""
        h = params["embed"][batch["tokens"].long()]
        stacked = stacked_params(params)
        layer = L.remat(lambda h, p: self._block_full(h, p)[0], self.remat_policy)
        for i in L.layer_range(self.cfg.n_layers):
            h = layer(h, layer_params(stacked, i))
        h = L.rms_norm(h, params["final_norm"])
        return L.chunked_cross_entropy(h, params["lm_head"], batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch):
        """Forward + final recurrent state per layer (the SSM 'cache'):
        (last-position logits (B, V) float32, {"ssm", "conv", "len"})."""
        S = batch["tokens"].shape[1]
        h = params["embed"][batch["tokens"].long()]
        stacked = stacked_params(params)
        hs, tails = [], []
        for i in L.layer_range(self.cfg.n_layers):
            h, (hN, tail) = self._block_full(h, layer_params(stacked, i))
            hs.append(hN)
            tails.append(tail)
        h = L.rms_norm(h, params["final_norm"])
        return logits_f32(h[:, -1], params["lm_head"]), {"ssm": torch.stack(hs),
                                                       "conv": torch.stack(tails), "len": S}

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One token against the O(1) state; returns (logits, new cache)."""
        h = params["embed"][batch["tokens"].long()]           # (B,1,d)
        stacked = stacked_params(params)
        hs, tails = [], []
        for i in L.layer_range(self.cfg.n_layers):
            p = layer_params(stacked, i)
            x = L.rms_norm(h, p["norm"])
            xi, z = (x @ p["in_proj"])[:, 0].chunk(2, dim=-1)  # (B, DI)
            xi, conv_state = _conv_step(xi, cache["conv"][i], p["conv_w"], p["conv_b"])
            xi = F.silu(xi)
            dt, Bs, Cs = (v[:, 0] for v in self._ssm_inputs(xi[:, None, :], p))
            A = -torch.exp(p["A_log"].float())
            xf = xi.float()
            hst = (torch.exp(dt[..., None] * A) * cache["ssm"][i]
                   + (dt * xf)[..., None] * Bs[:, None, :])
            y = torch.einsum("bdn,bn->bd", hst, Cs) + p["D"].float() * xf
            y = (y * F.silu(z.float())).to(h.dtype)
            h = h + (y @ p["out_proj"])[:, None]
            hs.append(hst)
            tails.append(conv_state)
        h = L.rms_norm(h, params["final_norm"])
        return logits_f32(h[:, -1], params["lm_head"]), {
            "ssm": torch.stack(hs), "conv": torch.stack(tails), "len": int(cache["len"]) + 1}

    def cache_templates(self, batch: int, seq: int) -> Dict[str, ParamSpec]:
        c = self.cfg
        Ln, DI, N, K = c.n_layers, c.d_inner, c.ssm.d_state, c.ssm.d_conv
        return {
            "ssm": ParamSpec((Ln, batch, DI, N), "float32", (None, "batch", "tp", None)),
            "conv": ParamSpec((Ln, batch, K - 1, DI), c.act_dtype, (None, "batch", None, "tp")),
            "len": ParamSpec((), "int32", ()),
        }


# ===========================================================================
# Mamba-2 / SSD + shared-attention hybrid (zamba2-2.7b)
# ===========================================================================

class Zamba2LM:
    # cache entries the serving engine grows before decode: the shared
    # block's K/V; the SSM and conv states are O(1)
    GROWING_CACHE = ("attn_k", "attn_v")

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing"):
        assert cfg.ssm is not None and cfg.ssm.version == 2
        self.cfg = cfg
        self.attn = check_attn(attn)
        self.remat_policy = L.check_remat(remat_policy)

    @property
    def n_ssm_heads(self) -> int:
        return self.cfg.d_inner // self.cfg.ssm.head_dim

    @property
    def n_groups(self) -> int:
        assert self.cfg.n_layers % self.cfg.attn_every == 0
        return self.cfg.n_layers // self.cfg.attn_every

    def param_templates(self) -> Dict[str, ParamSpec]:
        c = self.cfg
        d, V, Ln = c.d_model, c.vocab, c.n_layers
        DI, N, K = c.d_inner, c.ssm.d_state, c.ssm.d_conv
        P = self.n_ssm_heads
        hd, H, Kv, f = c.hd, c.n_heads, c.n_kv_heads, c.d_ff
        dt = c.param_dtype
        out_scale = 0.02 / (2 * Ln) ** 0.5
        t = {
            "embed": ParamSpec((V, d), dt, ("tp", None)),
            "final_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "lm_head": ParamSpec((d, V), dt, ("fsdp", "tp")),
            # ---- ONE shared transformer block (9 invocations) ----
            "shared.attn_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "shared.wq": ParamSpec((d, H * hd), dt, ("fsdp", "tp")),
            "shared.wk": ParamSpec((d, Kv * hd), dt, ("fsdp", "tp")),
            "shared.wv": ParamSpec((d, Kv * hd), dt, ("fsdp", "tp")),
            "shared.wo": ParamSpec((H * hd, d), dt, ("tp", "fsdp"),
                                   init="scaled", init_scale=out_scale),
            "shared.mlp_norm": ParamSpec((d,), dt, (None,), init="ones"),
            "shared.w_gate": ParamSpec((d, f), dt, ("fsdp", "tp")),
            "shared.w_up": ParamSpec((d, f), dt, ("fsdp", "tp")),
            "shared.w_down": ParamSpec((f, d), dt, ("tp", "fsdp"),
                                       init="scaled", init_scale=out_scale),
        }
        blk = {
            "norm": ParamSpec((Ln, d), dt, (None, None), init="ones", stacked=True),
            "in_proj_xz": ParamSpec((Ln, d, 2 * DI), dt, (None, "fsdp", "tp"), stacked=True),
            "in_proj_bcdt": ParamSpec((Ln, d, 2 * N + P), dt, (None, "fsdp", None), stacked=True),
            "conv_x_w": ParamSpec((Ln, DI, K), dt, (None, "tp", None), stacked=True),
            "conv_x_b": ParamSpec((Ln, DI), dt, (None, "tp"), init="zeros", stacked=True),
            "conv_bc_w": ParamSpec((Ln, 2 * N, K), dt, (None, None, None), stacked=True),
            "conv_bc_b": ParamSpec((Ln, 2 * N), dt, (None, None), init="zeros", stacked=True),
            "dt_bias": ParamSpec((Ln, P), "float32", (None, None), init="zeros", stacked=True),
            "A_log": ParamSpec((Ln, P), "float32", (None, None), init="ones", stacked=True),
            "D": ParamSpec((Ln, P), "float32", (None, None), init="ones", stacked=True),
            "gated_norm": ParamSpec((Ln, DI), dt, (None, "tp"), init="ones", stacked=True),
            "out_proj": ParamSpec((Ln, DI, d), dt, (None, "tp", "fsdp"),
                                  init="scaled", init_scale=out_scale, stacked=True),
        }
        t.update({f"blocks.{k}": v for k, v in blk.items()})
        return t

    def param_count(self) -> int:
        return count_params(self.param_templates())

    active_param_count = param_count

    # ------------------------------------------------------------------
    # SSD (Mamba-2) chunked scan — matmul formulation
    # ------------------------------------------------------------------
    def _ssd(self, x, dt, A, Bs, Cs, h0, chunk):
        """x: (B,S,P,hd) f32; dt: (B,S,P) f32 (softplus'd); A: (P,) f32 neg;
        Bs/Cs: (B,S,N) f32 (single group, broadcast over heads);
        h0: (B,P,N,hd) f32. Returns (y (B,S,P,hd), h_final)."""
        S = x.shape[1]
        chunk = _chunk_len(chunk, S)
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))

        def chunk_body(h, xch, dtch, Bch, Cch):
            s = torch.cumsum(dtch * A, dim=1)                     # log-decay from chunk start
            # intra-chunk: attention-like masked product; the mask goes in
            # before exp, so no inf (s_i - s_j > 0 above the diagonal) is made
            CB = torch.einsum("bin,bjn->bij", Cch, Bch)           # (B,c,c)
            Lmask = s[:, :, None, :] - s[:, None, :, :]           # s_i - s_j (B,i,j,P)
            M = Lmask.masked_fill(~tri[None, :, :, None], float("-inf")).exp()
            M = M * CB[..., None] * dtch[:, None, :, :]           # × dt_j
            y = torch.einsum("bijp,bjph->biph", M, xch)
            # inter-chunk: contribution of the carried state
            y = y + torch.einsum("bin,bpnh,bip->biph", Cch, h, torch.exp(s))
            # state update
            decay_to_end = torch.exp(s[:, -1:, :] - s)            # (B,c,P)
            S_chunk = torch.einsum("bjp,bjn,bjph->bpnh", decay_to_end * dtch, Bch, xch)
            return torch.exp(s[:, -1, :])[:, :, None, None] * h + S_chunk, y

        chunk_body = L.remat(chunk_body, self.remat_policy)
        h, ys = h0, []
        for s0 in range(0, S, chunk):
            h, y = chunk_body(h, *(v[:, s0:s0 + chunk] for v in (x, dt, Bs, Cs)))
            ys.append(y)
        return torch.cat(ys, dim=1), h

    def _mamba_inputs(self, x_conv, bcdt_conv, p):
        """Split conv'd streams into SSD inputs (f32)."""
        B_, S, _ = x_conv.shape
        x = x_conv.float().reshape(B_, S, self.n_ssm_heads, self.cfg.ssm.head_dim)
        Bs, Cs = bcdt_conv.float().chunk(2, dim=-1)
        return x, Bs, Cs

    def _mamba_block(self, h, p, h0=None, conv_states=None, single_step=False):
        """One Mamba-2 block: (h + out, final SSM state, conv states). Over a
        full sequence the conv states returned are the last K-1 PRE-conv
        inputs of the x and BC streams (the reference recomputes them in its
        prefill); in a single step, the updated states."""
        c = self.cfg
        N, K, DI = c.ssm.d_state, c.ssm.d_conv, c.d_inner
        B_ = h.shape[0]
        x = L.rms_norm(h, p["norm"])
        xi, z = (x @ p["in_proj_xz"]).chunk(2, dim=-1)
        bc, dt_in = torch.split(x @ p["in_proj_bcdt"], [2 * N, self.n_ssm_heads], dim=-1)
        A = -torch.exp(p["A_log"])
        if single_step:
            cx, cbc = conv_states
            xi1, cx = _conv_step(xi[:, 0], cx, p["conv_x_w"], p["conv_x_b"])
            bc1, cbc = _conv_step(bc[:, 0], cbc, p["conv_bc_w"], p["conv_bc_b"])
            xs, Bs, Cs = self._mamba_inputs(F.silu(xi1)[:, None], F.silu(bc1)[:, None], p)
            dt = F.softplus(dt_in[:, 0].float() + p["dt_bias"])            # (B,P)
            hN = (torch.exp(dt * A)[:, :, None, None] * h0
                  + torch.einsum("bp,bn,bph->bpnh", dt, Bs[:, 0], xs[:, 0]))
            y = torch.einsum("bn,bpnh->bph", Cs[:, 0], hN)[:, None]        # (B,1,P,hd)
            new_conv = (cx, cbc)
        else:
            new_conv = (xi[:, -(K - 1):, :], bc[:, -(K - 1):, :])
            xi = F.silu(_causal_conv(xi, p["conv_x_w"], p["conv_x_b"]))
            bc = F.silu(_causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
            xs, Bs, Cs = self._mamba_inputs(xi, bc, p)
            dt = F.softplus(dt_in.float() + p["dt_bias"])
            if h0 is None:
                h0 = torch.zeros((B_, self.n_ssm_heads, N, c.ssm.head_dim), dtype=torch.float32,
                                 device=h.device)
            y, hN = self._ssd(xs, dt, A, Bs, Cs, h0, c.ssm.chunk)
        y = y + p["D"][:, None] * xs                                        # (B,S,P,hd)
        S_ = y.shape[1]
        y = y.reshape(B_, S_, DI) * F.silu(z.float()[:, :S_])
        y = L.rms_norm(y.to(h.dtype), p["gated_norm"])
        return h + y @ p["out_proj"], hN, new_conv

    # ------------------------------------------------------------------
    def _shared_attn(self, h, params, positions, cache=None, t=None):
        """The shared transformer block. Full-seq when cache is None; else
        one-token decode against this invocation's cache, written in place."""
        c = self.cfg
        x = L.rms_norm(h, params["shared.attn_norm"])
        B, S = x.shape[:2]
        q = (x @ params["shared.wq"]).reshape(B, S, c.n_heads, c.hd)
        k = (x @ params["shared.wk"]).reshape(B, S, c.n_kv_heads, c.hd)
        v = (x @ params["shared.wv"]).reshape(B, S, c.n_kv_heads, c.hd)
        q = L.apply_rope(q, positions, c.rope_theta)
        k = L.apply_rope(k, positions, c.rope_theta)
        if cache is None:
            kH, vH = L.repeat_kv(k, c.n_heads), L.repeat_kv(v, c.n_heads)
            if self.attn == "flash":
                attn = flash_attention(q, kH, vH, causal=True)
            else:
                attn = L.attention(q, kH, vH, causal=True)
            new_cache = (k, v)
        else:
            k_cache, v_cache = cache
            k_cache[:, t:t + 1] = k.to(k_cache.dtype)
            v_cache[:, t:t + 1] = v.to(v_cache.dtype)
            kH, vH = L.repeat_kv(k_cache, c.n_heads), L.repeat_kv(v_cache, c.n_heads)
            attn = L.attention(q, kH, vH, causal=True, q_offset=t)
            new_cache = (k_cache, v_cache)
        h = h + attn.reshape(B, S, -1) @ params["shared.wo"]
        x = L.rms_norm(h, params["shared.mlp_norm"])
        h = h + L.swiglu(x, params["shared.w_gate"], params["shared.w_up"], params["shared.w_down"])
        return h, new_cache

    # ------------------------------------------------------------------
    def _split_groups(self, params) -> List[List[Dict[str, torch.Tensor]]]:
        """Per group of ``attn_every`` Mamba layers, each layer's parameters."""
        g = self.cfg.attn_every
        stacked = stacked_params(params)
        return [[layer_params(stacked, i * g + j) for j in range(g)] for i in range(self.n_groups)]

    @staticmethod
    def _positions(B: int, S: int, device, offset: int = 0) -> torch.Tensor:
        return (torch.arange(S, device=device)[None, :] + offset).expand(B, S)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE; differentiable (with ``attn="plain"``: the flash
        kernel is forward-only)."""
        B, S = batch["tokens"].shape
        h = params["embed"][batch["tokens"].long()]
        positions = self._positions(B, S, h.device)
        layer = L.remat(lambda h, p: self._mamba_block(h, p)[0], self.remat_policy)
        for grp in self._split_groups(params):
            for p in grp:
                h = layer(h, p)
            h, _ = self._shared_attn(h, params, positions)
        h = L.rms_norm(h, params["final_norm"])
        return L.chunked_cross_entropy(h, params["lm_head"], batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch):
        """(last-position logits (B, V) float32, cache {"ssm", "conv_x",
        "conv_bc": per layer; "attn_k", "attn_v": (n_groups, B, S, Kv, hd);
        "len": S})."""
        B, S = batch["tokens"].shape
        h = params["embed"][batch["tokens"].long()]
        positions = self._positions(B, S, h.device)
        ssm, conv_x, conv_bc, attn_k, attn_v = [], [], [], [], []
        for grp in self._split_groups(params):
            for p in grp:
                h, hN, (tx, tbc) = self._mamba_block(h, p)
                ssm.append(hN)
                conv_x.append(tx)
                conv_bc.append(tbc)
            h, (k, v) = self._shared_attn(h, params, positions)
            attn_k.append(k)
            attn_v.append(v)
        h = L.rms_norm(h, params["final_norm"])
        cache = {"ssm": torch.stack(ssm), "conv_x": torch.stack(conv_x),
                 "conv_bc": torch.stack(conv_bc), "attn_k": torch.stack(attn_k),
                 "attn_v": torch.stack(attn_v), "len": S}
        return logits_f32(h[:, -1], params["lm_head"]), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One token. Writes the shared block's K/V into ``cache["attn_k"]``
        / ``["attn_v"]`` in place; returns (logits, cache with new SSM and conv
        states and ``len`` advanced)."""
        B = batch["tokens"].shape[0]
        t = int(cache["len"])
        h = params["embed"][batch["tokens"].long()]   # (B,1,d)
        positions = torch.full((B, 1), t, dtype=torch.int64, device=h.device)
        g = self.cfg.attn_every
        ssm, conv_x, conv_bc = [], [], []
        for i, grp in enumerate(self._split_groups(params)):
            for j, p in enumerate(grp):
                li = i * g + j
                h, hN, (cx, cbc) = self._mamba_block(
                    h, p, h0=cache["ssm"][li],
                    conv_states=(cache["conv_x"][li], cache["conv_bc"][li]), single_step=True)
                ssm.append(hN)
                conv_x.append(cx)
                conv_bc.append(cbc)
            h, _ = self._shared_attn(h, params, positions,
                                     cache=(cache["attn_k"][i], cache["attn_v"][i]), t=t)
        h = L.rms_norm(h, params["final_norm"])
        cache = dict(cache, ssm=torch.stack(ssm), conv_x=torch.stack(conv_x),
                     conv_bc=torch.stack(conv_bc), len=t + 1)
        return logits_f32(h[:, -1], params["lm_head"]), cache

    def cache_templates(self, batch: int, seq: int) -> Dict[str, ParamSpec]:
        c = self.cfg
        Ln, N, K, P, hd = c.n_layers, c.ssm.d_state, c.ssm.d_conv, self.n_ssm_heads, c.ssm.head_dim
        return {
            "ssm": ParamSpec((Ln, batch, P, N, hd), "float32", (None, "batch", "tp", None, None)),
            "conv_x": ParamSpec((Ln, batch, K - 1, c.d_inner), c.act_dtype, (None, "batch", None, "tp")),
            "conv_bc": ParamSpec((Ln, batch, K - 1, 2 * N), c.act_dtype, (None, "batch", None, None)),
            "attn_k": ParamSpec((self.n_groups, batch, seq, c.n_kv_heads, c.hd),
                                c.act_dtype, (None, "batch", "sp", None, None)),
            "attn_v": ParamSpec((self.n_groups, batch, seq, c.n_kv_heads, c.hd),
                                c.act_dtype, (None, "batch", "sp", None, None)),
            "len": ParamSpec((), "int32", ()),
        }
