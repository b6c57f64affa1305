# Port of src/repro/models/ssm.py: rewritten in PyTorch, names and layouts kept.
"""State-space models on one card or on a device mesh: Mamba-1
(falcon-mamba-7b) and the Mamba-2/SSD hybrid with one shared attention block
(zamba2-2.7b).

Parameters are the reference's flat dicts (``embed``, ``final_norm``,
``lm_head``, zamba2's ``shared.*`` and the per-layer ``blocks.*`` tensors
stacked on a leading layer dim); ``A_log``, ``D`` and zamba2's ``dt_bias`` are
float32 inside bf16 models, and every recurrence runs in float32.

What changes from the reference:

* ``lax.scan`` over stacked layers and over sequence chunks becomes a Python
  loop; each layer of ``loss`` and each chunk body of the scans is wrapped by
  :func:`layers.remat` under ``remat_policy``, where the reference wraps them
  in ``jax.checkpoint``.
* Mamba-1's ``associative_scan`` inside a chunk becomes a log-depth doubling
  (Hillis-Steele) scan with the same combine ``(a1*a2, b1*a2 + b2)``: 7 steps at
  chunk 128. The chunk rule (``chunk = min(chunk, S)``, halved until it divides
  S) is the reference's.
* The depthwise causal conv is ``F.conv1d`` with ``groups=C`` in float32 (the
  reference's NWC layout transposed to NCW).
* The packed input projections (``in_proj``, ``in_proj_xz``) are used as their
  x and z column blocks (``layers.unpack_columns``), so that on a mesh each
  rank holds matching channels of both.
* The decode steps write zamba2's shared-attention K/V into the preallocated
  cache in place, as ``TransformerLM.decode_step`` does; the O(1) SSM and conv
  states come back as new tensors. The shared block's full-sequence attention
  takes the flash kernel under ``attn="flash"`` and ``layers.attention`` under
  ``"plain"``.

On a mesh (``mesh`` and ``rules``) the parameters and inputs are DTensors laid
out by the reference's rules, and the model is the reference's GSPMD program
written out (``models.base``): its ``with_sharding_constraint`` points are
``_ws`` calls, each layer's weights are gathered over their FSDP axes, and each
layer's conv and scan run under one ``local_map`` on the rank's own d_inner
channels (Mamba-1) or SSD heads (zamba2), so the Python loops over chunks
dispatch plain tensor ops. Mamba-1's contraction of its channels with
``x_proj`` is a partial sum, all-reduced inside that ``local_map`` before the
dt/B/C norms; zamba2's B, C and dt arrive whole on every model rank (each
takes its heads' slice), its C·Bᵀ is computed whole on each, and its gated
norm's mean adds the ranks' sums. The shared block's weights are gathered
once a pass for all its invocations; its decode runs
``layers.decode_attention_sp`` over the sequence-sharded cache on a model
axis wider than one.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.base import ModelBase, layer_params, logits_f32, stacked_params
from repro_torch.sharding.rules import ParamSpec, safe_entry

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


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, sum_over, n: int,
                eps: float = 1e-6) -> torch.Tensor:
    """RMS norm of y (..., C) over all ``n`` channels, of which this rank
    holds C: ``sum_over`` adds the ranks' sums of squares (the identity on
    one card), so the mean is the global one."""
    yf = y.float()
    var = sum_over(yf.square().sum(dim=-1, keepdim=True)) / n
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


# ===========================================================================
# Mamba-1 (falcon-mamba-7b)
# ===========================================================================

class MambaLM(ModelBase):
    # cache entries the serving engine grows before decode: none, the SSM and
    # conv states are O(1) in the sequence
    GROWING_CACHE = ()
    # the weights of one layer's conv + SSM, all split on d_inner like its input
    MIXER = ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D")

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing", *,
                 mesh=None, rules=None):
        """``attn`` is accepted for a uniform ``get_model`` and unused: the
        model has no attention."""
        assert cfg.ssm is not None and cfg.ssm.version == 1
        super().__init__(cfg, attn, remat_policy, mesh=mesh, rules=rules)

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

    # ------------------------------------------------------------------
    def _ssm_inputs(self, x, x_proj, dt_proj, dt_bias, sum_over):
        """x: (B, S, DI) post-conv. Returns dt (B,S,DI) f32, Bs/Cs (B,S,N) f32.
        On a mesh x holds the rank's channels: the contraction with
        ``x_proj`` is a partial sum, reduced by ``sum_over`` before the norms."""
        c = self.cfg
        N, R = c.ssm.d_state, self.dt_rank
        proj = sum_over((x @ x_proj).float())
        dt_in, Bs, Cs = torch.split(proj, [R, N, N], dim=-1)
        # falcon-mamba applies parameter-free RMS norm to dt/B/C streams
        dt_in, Bs, Cs = _param_free_rms(dt_in), _param_free_rms(Bs), _param_free_rms(Cs)
        dt = dt_in @ dt_proj.float()
        return F.softplus(dt + dt_bias.float()), Bs, Cs

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

    def _mixer(self, xi, z, p, states=None):
        """Conv, SSM and gate of one layer over the channels of xi / z
        ((B, S, DI), laid out ("batch", None, "tp")): on a mesh one
        ``local_map`` over each rank's own channels, the x_proj partial sum
        reduced inside it. Over a full sequence (``states`` None): (y (B, S,
        DI), final SSM state (B, DI, N)); one step (xi, z (B, DI); ``states``
        = (conv state (B, K-1, DI), SSM state (B, DI, N))): (y (B, DI), new
        conv state, new SSM state)."""
        c = self.cfg
        sums = self._cut_dims(xi, -1)

        def sum_over(t):
            return L.mesh_sum(t, self.mesh, sums)

        def full(xi, z, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D):
            xc = F.silu(_causal_conv(xi, conv_w, conv_b))
            dt, Bs, Cs = self._ssm_inputs(xc, x_proj, dt_proj, dt_bias, sum_over)
            A = -torch.exp(A_log.float())
            h0 = torch.zeros((xc.shape[0], xc.shape[-1], c.ssm.d_state), dtype=torch.float32,
                             device=xc.device)
            y, hN = self._selective_scan(xc.float(), dt, A, Bs, Cs, h0, c.ssm.chunk)
            y = y + D.float() * xc.float()
            return (y * F.silu(z.float())).to(xi.dtype), hN

        def step(xi, z, conv_state, hst, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D):
            xi, conv_state = _conv_step(xi, conv_state, conv_w, conv_b)
            xi = F.silu(xi)
            dt, Bs, Cs = (v[:, 0] for v in self._ssm_inputs(xi[:, None, :], x_proj, dt_proj,
                                                             dt_bias, sum_over))
            A = -torch.exp(A_log.float())
            xf = xi.float()
            hst = torch.exp(dt[..., None] * A) * hst + (dt * xf)[..., None] * Bs[:, None, :]
            y = torch.einsum("bdn,bn->bd", hst, Cs) + D.float() * xf
            return (y * F.silu(z.float())).to(xi.dtype), conv_state, hst

        w = [p[k] for k in self.MIXER]
        if states is None:
            out = None
            if self.sharded:
                out = (xi.placements, self._placements(("batch", "tp", None),
                                                       (xi.shape[0], xi.shape[-1], 1)))
            return self._split(full, xi, out, xi, z, *w)
        out = None
        if self.sharded:
            out = (xi.placements, states[0].placements, states[1].placements)
        return self._split(step, xi, out, xi, z, *states, *w)

    def _weights(self, stacked, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights as its block uses them: ``in_proj`` split
        into its x and z blocks (``wx``, ``wz``), the projections gathered over
        their FSDP axes."""
        p = layer_params(stacked, i)
        p["wx"], p["wz"] = self._unpacked(p.pop("in_proj"), 2)
        p["out_proj"] = self._gathered(p["out_proj"])
        return p

    def _in_proj(self, h, p):
        """The layer's norm and input projection: (xi, z), each (B, S, DI)
        laid out ("batch", None, "tp")."""
        x = self._ws(L.rms_norm(h, p["norm"]), "batch", None, None)
        return (self._ws(x @ p["wx"], "batch", None, "tp"),
                self._ws(x @ p["wz"], "batch", None, "tp"))

    def _out_proj(self, h, y, p):
        out = self._ws(y @ p["out_proj"], "batch", None, None)
        return self._ws(h + out, "batch", None, None)

    def _block_full(self, h, p):
        """One block over a full sequence: (h + out, (final SSM state, conv
        tail = the last K-1 PRE-conv inputs, what ``_conv_step`` consumes))."""
        K = self.cfg.ssm.d_conv
        xi, z = self._in_proj(h, p)
        conv_tail = xi[:, -(K - 1):, :] if K > 1 else xi[:, :0, :]
        y, hN = self._mixer(xi, z, p)
        return self._out_proj(h, y, p), (hN, conv_tail)

    def _head(self, params, h):
        return self._ws(L.rms_norm(h, params["final_norm"]), "batch", None, None)

    # ------------------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE; differentiable, as the reference's."""
        h = self._embed_tokens(batch["tokens"], params["embed"])
        stacked = stacked_params(params)
        layer = L.remat(lambda h, p: self._block_full(h, p)[0], self.remat_policy)
        for i in L.layer_range(self.cfg.n_layers):
            h = layer(h, self._weights(stacked, i))
        return L.chunked_cross_entropy(self._head(params, h), self._gathered(params["lm_head"]),
                                       batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch):
        """Forward + final recurrent state per layer (the SSM 'cache'):
        (last-position logits (B, V) float32, {"ssm", "conv", "len"}); on a
        mesh laid out as ``cache_templates`` says."""
        S = batch["tokens"].shape[1]
        h = self._embed_tokens(batch["tokens"], params["embed"])
        stacked = stacked_params(params)
        hs, tails = [], []
        for i in L.layer_range(self.cfg.n_layers):
            h, (hN, tail) = self._block_full(h, self._weights(stacked, i))
            hs.append(hN)
            tails.append(tail)
        h = self._head(params, h)
        cache = {"ssm": self._ws(torch.stack(hs), None, "batch", "tp", None),
                 "conv": self._ws(torch.stack(tails), None, "batch", None, "tp"), "len": S}
        return logits_f32(h[:, -1], self._gathered(params["lm_head"])), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One token against the O(1) state; returns (logits, new cache)."""
        h = self._embed_tokens(batch["tokens"], params["embed"])     # (B,1,d)
        stacked = stacked_params(params)
        hs, tails = [], []
        for i in L.layer_range(self.cfg.n_layers):
            p = self._weights(stacked, i)
            xi, z = (v[:, 0] for v in self._in_proj(h, p))            # (B, DI)
            states = (self._ws(cache["conv"][i], "batch", None, "tp"),
                      self._ws(cache["ssm"][i], "batch", "tp", None))
            y, conv_state, hst = self._mixer(xi, z, p, states)
            h = self._out_proj(h, y[:, None], p)
            hs.append(hst)
            tails.append(conv_state)
        h = self._head(params, h)
        return logits_f32(h[:, -1], self._gathered(params["lm_head"])), {
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

class Zamba2LM(ModelBase):
    # cache entries the serving engine grows before decode: the shared
    # block's K/V; the SSM and conv states are O(1)
    GROWING_CACHE = ("attn_k", "attn_v")
    # the weights of one Mamba-2 layer's conv, SSD and gated norm
    MIXER = ("conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b", "dt_bias", "A_log", "D",
             "gated_norm")

    def __init__(self, cfg: ArchConfig, attn: str = "flash", remat_policy: str = "nothing", *,
                 mesh=None, rules=None):
        assert cfg.ssm is not None and cfg.ssm.version == 2
        super().__init__(cfg, attn, remat_policy, mesh=mesh, rules=rules)

    @property
    def n_ssm_heads(self) -> int:
        return self.cfg.d_inner // self.cfg.ssm.head_dim

    @property
    def n_groups(self) -> int:
        assert self.cfg.n_layers % self.cfg.attn_every == 0
        return self.cfg.n_layers // self.cfg.attn_every

    @property
    def _heads(self):
        """The logical axis of the SSD heads (and of d_inner, which they
        split): "tp" where its axes divide the heads, else None (every rank
        runs every head)."""
        if self.sharded and safe_entry(self.mesh, self.rules, "tp", self.n_ssm_heads) is None:
            return None
        return "tp"

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
            # inter-chunk: contribution of the carried state (the products
            # in a fixed order: einsum's own order, and so its FLOPs, would
            # change with the number of heads a rank holds)
            y = y + torch.einsum("bin,bpnh->biph", Cch, h) * torch.exp(s)[..., None]
            # state update
            decay_to_end = torch.exp(s[:, -1:, :] - s)            # (B,c,P)
            S_chunk = torch.einsum("bjn,bjph->bpnh", Bch, xch * (decay_to_end * dtch)[..., None])
            return torch.exp(s[:, -1, :])[:, :, None, None] * h + S_chunk, y

        chunk_body = L.remat(chunk_body, self.remat_policy)
        h, ys = h0, []
        for s0 in range(0, S, chunk):
            h, y = chunk_body(h, *(v[:, s0:s0 + chunk] for v in (x, dt, Bs, Cs)))
            ys.append(y)
        return torch.cat(ys, dim=1), h

    def _mamba_inputs(self, x_conv, bc_conv):
        """Split conv'd streams into SSD inputs (f32): x (B, S, heads, hd),
        Bs, Cs (B, S, N)."""
        B_, S, C = x_conv.shape
        hd = self.cfg.ssm.head_dim
        x = x_conv.float().reshape(B_, S, C // hd, hd)
        Bs, Cs = bc_conv.float().chunk(2, dim=-1)
        return x, Bs, Cs

    def _mixer(self, xi, z, bc, dt_in, p, states=None):
        """Conv, SSD, gate and gated norm of one Mamba-2 layer. xi, z (B, S,
        DI) laid out ("batch", None, heads); bc (B, S, 2N) and dt_in (B, S, P)
        whole on the model axis. On a mesh one ``local_map`` over each rank's
        own SSD heads: each takes its heads' slice of dt_in, A_log, D and
        dt_bias, runs the (c × c) C·Bᵀ whole, and the gated norm's mean over
        d_inner adds the ranks' sums. Over a full sequence (``states`` None):
        (y (B, S, DI), final SSM state (B, heads, N, hd)); one step
        (``states`` = (conv x state, conv BC state, SSM state)): (y (B, 1,
        DI), conv x state, conv BC state, SSM state)."""
        c = self.cfg
        hd, DI = c.ssm.head_dim, c.d_inner
        sums = self._cut_dims(xi, -1)
        lo = 0
        if self.sharded and sums:
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

            lo = compute_local_shape_and_global_offset(xi.shape, self.mesh,
                                                       xi.placements)[1][-1] // hd

        def sum_over(t):
            return L.mesh_sum(t, self.mesh, sums)

        def gate(y, xs, z, D, gated_norm, heads):
            y = y + D[heads][:, None] * xs                                  # (B,S,P,hd)
            B_, S_ = y.shape[:2]
            y = y.reshape(B_, S_, -1) * F.silu(z.float()[:, :S_])
            return _gated_norm(y.to(z.dtype), gated_norm, sum_over, DI)

        def full(xi, z, bc, dt_in, conv_x_w, conv_x_b, conv_bc_w, conv_bc_b, dt_bias, A_log,
                 D, gated_norm):
            heads = slice(lo, lo + xi.shape[-1] // hd)
            xc = F.silu(_causal_conv(xi, conv_x_w, conv_x_b))
            bcc = F.silu(_causal_conv(bc, conv_bc_w, conv_bc_b))
            xs, Bs, Cs = self._mamba_inputs(xc, bcc)
            dt = F.softplus(dt_in[..., heads].float() + dt_bias[heads])
            h0 = torch.zeros((xs.shape[0], xs.shape[2], c.ssm.d_state, hd), dtype=torch.float32,
                             device=xs.device)
            y, hN = self._ssd(xs, dt, -torch.exp(A_log[heads]), Bs, Cs, h0, c.ssm.chunk)
            return gate(y, xs, z, D, gated_norm, heads), hN

        def step(xi, z, bc, dt_in, cx, cbc, h0, conv_x_w, conv_x_b, conv_bc_w, conv_bc_b,
                 dt_bias, A_log, D, gated_norm):
            heads = slice(lo, lo + xi.shape[-1] // hd)
            xi1, cx = _conv_step(xi[:, 0], cx, conv_x_w, conv_x_b)
            bc1, cbc = _conv_step(bc[:, 0], cbc, conv_bc_w, conv_bc_b)
            xs, Bs, Cs = self._mamba_inputs(F.silu(xi1)[:, None], F.silu(bc1)[:, None])
            dt = F.softplus(dt_in[:, 0, heads].float() + dt_bias[heads])     # (B,P)
            A = -torch.exp(A_log[heads])
            hN = (torch.exp(dt * A)[:, :, None, None] * h0
                  + torch.einsum("bp,bn,bph->bpnh", dt, Bs[:, 0], xs[:, 0]))
            y = torch.einsum("bn,bpnh->bph", Cs[:, 0], hN)[:, None]        # (B,1,P,hd)
            return gate(y, xs, z, D, gated_norm, heads), cx, cbc, hN

        w = [p[k] for k in self.MIXER]
        if states is None:
            out = None
            if self.sharded:
                out = (xi.placements, self._placements(
                    ("batch", self._heads, None, None),
                    (xi.shape[0], self.n_ssm_heads, 1, 1)))
            return self._split(full, xi, out, xi, z, bc, dt_in, *w)
        out = None
        if self.sharded:
            out = (xi.placements,) + tuple(s.placements for s in states)
        return self._split(step, xi, out, xi, z, bc, dt_in, *states, *w)

    def _mamba_block(self, h, p, states=None):
        """One Mamba-2 block: (h + out, final SSM state, conv states). Over a
        full sequence (``states`` None) the conv states returned are the last
        K-1 PRE-conv inputs of the x and BC streams (the reference recomputes
        them in its prefill); in one step (``states`` = (conv x, conv BC,
        SSM)), the updated states."""
        c = self.cfg
        N, K = c.ssm.d_state, c.ssm.d_conv
        x = self._ws(L.rms_norm(h, p["norm"]), "batch", None, None)
        xi = self._ws(x @ p["wx"], "batch", None, self._heads)
        z = self._ws(x @ p["wz"], "batch", None, self._heads)
        bc, dt_in = torch.split(x @ p["in_proj_bcdt"], [2 * N, self.n_ssm_heads], dim=-1)
        if states is None:
            new_conv = (xi[:, -(K - 1):, :], bc[:, -(K - 1):, :])
            y, hN = self._mixer(xi, z, bc, dt_in, p)
        else:
            y, cx, cbc, hN = self._mixer(xi, z, bc, dt_in, p, states)
            new_conv = (cx, cbc)
        out = self._ws(y @ p["out_proj"], "batch", None, None)
        return self._ws(h + out, "batch", None, None), hN, new_conv

    def _weights(self, stacked, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s weights as its block uses them: ``in_proj_xz`` split
        into its x and z blocks (``wx``, ``wz``), the projections gathered
        over their FSDP axes."""
        p = layer_params(stacked, i)
        p["wx"], p["wz"] = self._unpacked(p.pop("in_proj_xz"), 2)
        for k in ("in_proj_bcdt", "out_proj"):
            p[k] = self._gathered(p[k])
        return p

    # ------------------------------------------------------------------
    def _shared(self, params) -> Dict[str, torch.Tensor]:
        """The shared block's weights, gathered over their FSDP axes once for
        all its invocations of a pass: one all-gather each, and in the
        backward pass one reduce-scatter of their summed gradients."""
        return {k.split(".", 1)[1]: self._gathered(v) for k, v in params.items()
                if k.startswith("shared.")}

    def _shared_attn(self, h, sp, positions, cache=None, t=None, i=None):
        """The shared transformer block (``sp``: its weights, ``_shared``).
        Full-seq when cache is None: (h, (k, v)); else one-token decode
        against invocation ``i``'s slice of the caches (n_groups, B, S, Kv,
        hd), written in place at ``t``: (h, None)."""
        c = self.cfg
        x = self._ws(L.rms_norm(h, sp["attn_norm"]), "batch", None, None)
        q, k, v = self._qkv(x, sp, positions)
        if cache is None:
            kH = self._ws(L.repeat_kv(k, c.n_heads), "batch", None, "tp", None)
            vH = self._ws(L.repeat_kv(v, c.n_heads), "batch", None, "tp", None)
            attn = self._attend(q, kH, vH, causal=True)
            new_cache = (k, v)
        else:
            k_cache, v_cache = cache
            self._write_kv(k_cache, i, t, k)
            self._write_kv(v_cache, i, t, v)
            attn = self._decode_attend(q, k_cache[i], v_cache[i], t + 1)[:, None]
            new_cache = None
        h = h + self._ws(self._merge_heads(attn) @ sp["wo"], "batch", None, None)
        x = self._ws(L.rms_norm(h, sp["mlp_norm"]), "batch", None, None)
        h = h + self._ws(L.swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"]), "batch", None, None)
        return h, new_cache

    def _layers(self):
        """The layer loop (``layers.layer_range``): ("mamba", i) for each
        Mamba layer, then ("shared", g) after each group g, with
        ``layers.LAYER`` holding g while the shared block runs."""
        g = self.cfg.attn_every
        for li in L.layer_range(self.cfg.n_layers):
            yield "mamba", li
            if (li + 1) % g == 0:
                L.LAYER.set(li // g)
                yield "shared", li // g

    @staticmethod
    def _positions(B: int, S: int, device, offset: int = 0) -> torch.Tensor:
        return (torch.arange(S, device=device)[None, :] + offset).expand(B, S)

    def _head(self, params, h):
        return self._ws(L.rms_norm(h, params["final_norm"]), "batch", None, None)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE; differentiable (with ``attn="plain"``: the flash
        kernel is forward-only)."""
        B, S = batch["tokens"].shape
        h = self._embed_tokens(batch["tokens"], params["embed"])
        positions = self._positions(B, S, batch["tokens"].device)
        stacked, sp = stacked_params(params), self._shared(params)
        layer = L.remat(lambda h, p: self._mamba_block(h, p)[0], self.remat_policy)
        for kind, i in self._layers():
            if kind == "mamba":
                h = layer(h, self._weights(stacked, i))
            else:
                h, _ = self._shared_attn(h, sp, positions)
        return L.chunked_cross_entropy(self._head(params, h), self._gathered(params["lm_head"]),
                                       batch["labels"])

    @torch.no_grad()
    def prefill(self, params, batch):
        """(last-position logits (B, V) float32, cache {"ssm", "conv_x",
        "conv_bc": per layer; "attn_k", "attn_v": (n_groups, B, S, Kv, hd);
        "len": S}); on a mesh laid out as ``cache_templates`` says."""
        B, S = batch["tokens"].shape
        h = self._embed_tokens(batch["tokens"], params["embed"])
        positions = self._positions(B, S, batch["tokens"].device)
        stacked, sp = stacked_params(params), self._shared(params)
        ssm, conv_x, conv_bc, attn_k, attn_v = [], [], [], [], []
        for kind, i in self._layers():
            if kind == "mamba":
                h, hN, (tx, tbc) = self._mamba_block(h, self._weights(stacked, i))
                ssm.append(hN)
                conv_x.append(tx)
                conv_bc.append(tbc)
            else:
                h, (k, v) = self._shared_attn(h, sp, positions)
                attn_k.append(self._ws(k, "batch", "sp", None, None))
                attn_v.append(self._ws(v, "batch", "sp", None, None))
        h = self._head(params, h)
        heads = self._heads
        cache = {"ssm": self._ws(torch.stack(ssm), None, "batch", heads, None, None),
                 "conv_x": self._ws(torch.stack(conv_x), None, "batch", None, heads),
                 "conv_bc": self._ws(torch.stack(conv_bc), None, "batch", None, None),
                 "attn_k": self._ws(torch.stack(attn_k), None, "batch", "sp", None, None),
                 "attn_v": self._ws(torch.stack(attn_v), None, "batch", "sp", None, None),
                 "len": S}
        return logits_f32(h[:, -1], self._gathered(params["lm_head"])), cache

    @torch.no_grad()
    def decode_step(self, params, batch, cache):
        """One token. Writes the shared block's K/V into ``cache["attn_k"]``
        / ``["attn_v"]`` in place; returns (logits, cache with new SSM and conv
        states and ``len`` advanced)."""
        B = batch["tokens"].shape[0]
        t = int(cache["len"])
        h = self._embed_tokens(batch["tokens"], params["embed"])     # (B,1,d)
        positions = torch.full((B, 1), t, dtype=torch.int64, device=batch["tokens"].device)
        stacked, sp = stacked_params(params), self._shared(params)
        heads = self._heads
        ssm, conv_x, conv_bc = [], [], []
        for kind, i in self._layers():
            if kind == "shared":
                h, _ = self._shared_attn(h, sp, positions, (cache["attn_k"], cache["attn_v"]),
                                         t, i)
                continue
            states = (self._ws(cache["conv_x"][i], "batch", None, heads),
                      self._ws(cache["conv_bc"][i], "batch", None, None),
                      self._ws(cache["ssm"][i], "batch", heads, None, None))
            h, hN, (cx, cbc) = self._mamba_block(h, self._weights(stacked, i), states)
            ssm.append(hN)
            conv_x.append(cx)
            conv_bc.append(cbc)
        h = self._head(params, h)
        cache = dict(cache, ssm=torch.stack(ssm), conv_x=torch.stack(conv_x),
                     conv_bc=torch.stack(conv_bc), len=t + 1)
        return logits_f32(h[:, -1], self._gathered(params["lm_head"])), cache

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
