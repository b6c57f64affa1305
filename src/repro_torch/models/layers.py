# Port of src/repro/models/layers.py: rewritten in PyTorch, names and layouts kept.
"""Shared neural building blocks of the transformer family, as plain functions
on tensors over flat parameter dicts (the reference's names and layouts).

RMS/layer norm, RoPE (partial rotary) and M-RoPE, ``repeat_kv``, masked
softmax ``attention`` with a chunked online-softmax path for long sequences,
SwiGLU / GELU MLPs, top-k MoE with capacity-limited, group-local scatter
dispatch, a chunked cross-entropy that never holds the full (B, S, V) logits,
and :func:`remat`, the reference's rematerialization policies
(``jax.checkpoint``) as ``torch.utils.checkpoint``.

What is not here: ``decode_attention_sp`` (``layers.py:247-308``), a
``shard_map`` over a sequence-sharded cache, waits for the mesh slice; on one
card the decode path uses :func:`attention` with ``q_offset``, as the
reference's single-device branch does. The sharding constraints (``ws``) are
dropped. The chunked branch of :func:`attention` computes the reference's
function without its chunk-divisibility assert (a ragged last chunk is fine).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope_table",
    "apply_rope",
    "apply_mrope",
    "repeat_kv",
    "attention",
    "swiglu",
    "gelu_mlp",
    "moe_block",
    "chunked_cross_entropy",
    "remat",
    "check_remat",
    "REMAT_POLICIES",
]

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------

# the reference's remat policies (``--remat``): "nothing" saves nothing of the
# wrapped body and recomputes it in the backward pass
# (``nothing_saveable``); "dots" saves the outputs of the 2-D matmuls and
# recomputes the rest, batched matmuls included
# (``dots_with_no_batch_dims_saveable``); "none" saves everything
REMAT_POLICIES = ("nothing", "dots", "none")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def check_remat(policy: str) -> str:
    """``policy`` if it names one of :data:`REMAT_POLICIES`."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got {policy!r}")
    return policy


def remat(fn: Callable, policy: str = "nothing") -> Callable:
    """``fn`` rematerialized in the backward pass under ``policy`` (one of
    :data:`REMAT_POLICIES`). Without autograd recording (inference) the body
    runs as it is; the numbers never change, only what the backward pass keeps."""
    if check_remat(policy) == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def _inv_freq(rot_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def rope_table(positions: torch.Tensor, rot_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions: (..., S) -> (..., S, rot_dim/2)."""
    angles = positions.float()[..., None] * _inv_freq(rot_dim, theta, positions.device)
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (x1, x2) half-pairs of the rotary slice. x: (..., rot_dim)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S). Partial rotary via rope_pct (phi-4)."""
    d = x.shape[-1]
    rot = int(d * rope_pct)
    rot -= rot % 2
    cos, sin = rope_table(positions, rot, theta)  # (B, S, rot/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xr = _rotate(x[..., :rot], cos, sin)
    if rot < d:
        xr = torch.cat([xr, x[..., rot:].float()], dim=-1)
    return xr.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the three position streams (t, h, w) drive
    disjoint frequency sections of the rotary dim.

    x: (B, S, H, D); positions3: (3, B, S); sum(sections) == D // 2. The
    default split is the published (16, 24, 24) t/h/w ratio scaled to D.
    """
    d = x.shape[-1]
    half = d // 2
    if sections is None:
        t_sec = half // 4
        h_sec = (half - t_sec) // 2
        sections = (t_sec, h_sec, half - t_sec - h_sec)
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    ang = positions3.float()[..., None] * _inv_freq(d, theta, x.device)          # (3, B, S, half)
    sel = torch.repeat_interleave(torch.arange(3, device=x.device),
                                  torch.tensor(sections, device=x.device))       # (half,)
    # each frequency takes its angle from the stream its section belongs to
    ang = torch.gather(ang, 0, sel.expand(1, *ang.shape[1:3], half)).squeeze(0)  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    return _rotate(x, cos, sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (train / prefill / decode on one card), GQA expanded to H heads
# ---------------------------------------------------------------------------


def repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Kv, D) -> (B, S, H, D) by repeating each kv head H/Kv times."""
    Kv = kv.shape[2]
    if Kv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // Kv, dim=2)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              q_offset: int = 0, window: int = 0, chunk_q: int = 1024, chunk_kv: int = 1024,
              score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Masked softmax attention over H-head q/k/v (``layers.py:141``).

    q: (B, Sq, H, D); k, v: (B, Sk, H, D) (GQA already expanded by the caller).
    ``causal`` masks j > i + q_offset; ``window > 0`` additionally masks
    j <= i + q_offset - window (sliding-window attention, Mixtral).

    Sequences up to 2048 take the single-block path: float32 scores, softmax,
    p in v's dtype times v. Longer ones loop over q chunks (outer) and kv
    chunks (inner) with an online-softmax accumulator in float32, as the
    reference's scan does; ``score_dtype`` rounds each score block there, and
    the backward pass recomputes each block instead of keeping it.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape[2] != H:
        raise ValueError(f"k has {k.shape[2]} heads, q {H}: expand with repeat_kv first")
    # the reference's float32 1/sqrt(D), taken exactly as a Python float
    scale = float(1.0 / torch.sqrt(torch.tensor(float(D))))
    dev = q.device
    q_pos_all = torch.arange(Sq, device=dev) + q_offset
    k_pos_all = torch.arange(Sk, device=dev)

    if Sq <= 2048 and Sk <= 2048:
        s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
        if causal or window:
            s = s.masked_fill(~_mask(q_pos_all, k_pos_all, causal, window), NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", p.to(v.dtype), v)

    def kv_body(m, l, o, qblk, kblk, vblk, msk):
        s = torch.einsum("bqhd,bshd->bhqs", qblk, kblk.float()) * scale
        if msk is not None:
            s = s.masked_fill(~msk, NEG_INF)
        if score_dtype != torch.float32:
            s = s.to(score_dtype).float()
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", p.to(vblk.dtype).float(),
                                               vblk.float())
        return m_new, l, o

    # as the reference's checkpointed kv body: the backward pass keeps only
    # the (m, l, o) accumulators of each step and recomputes the score block
    kv_body = remat(kv_body)
    outs = []
    for qs in range(0, Sq, chunk_q):
        qblk = q[:, qs:qs + chunk_q].float()
        cq = qblk.shape[1]
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, H, cq, D), dtype=torch.float32, device=dev)
        for ks in range(0, Sk, chunk_kv):
            kblk, vblk = k[:, ks:ks + chunk_kv], v[:, ks:ks + chunk_kv]
            msk = None
            if causal or window:
                msk = _mask(q_pos_all[qs:qs + cq], k_pos_all[ks:ks + kblk.shape[1]], causal, window)
            m, l, o = kv_body(m, l, o, qblk, kblk, vblk, msk)
        out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)  # (B, H, cq, D)
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = x @ w_in
    if b_in is not None:
        h = h + b_in
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    o = h @ w_out
    if b_out is not None:
        o = o + b_out
    return o


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity + group-local scatter dispatch
# ---------------------------------------------------------------------------


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
              n_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-dropping top-k MoE with group-local scatter dispatch (``layers.py:336``).

    x: (B, S, d); router_w: (d, E); expert weights: (E, d, f) / (E, f, d).
    Returns (output (B, S, d), aux load-balancing loss scalar). The T tokens
    split into G = ``n_groups`` groups of T/G (one group when G does not divide
    T), one per data-parallel shard in the reference; each group dispatches
    into its own (E, C, d) buffer, C = max(1, (T/G)·k·cf / E) slots per expert
    filled in token order, and drops the rest.
    """
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S
    G = n_groups if n_groups > 0 and T % n_groups == 0 else 1
    Tg = T // G
    xt = x.reshape(G, Tg, d)

    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)        # (G, Tg, E)
    gate_w, expert_idx = torch.topk(probs, top_k, dim=-1)                # (G, Tg, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # Switch-style aux loss: E * sum_e (fraction routed to e) * (mean prob e)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (me * ce).sum()

    cap = int(max(1, (Tg * top_k * capacity_factor) / E))
    flat_e = expert_idx.reshape(G, Tg * top_k)
    onehot = F.one_hot(flat_e, E)                                        # (G, Tg·k, E)
    slot = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(dim=-1)        # slots before me
    keep = slot < cap

    xk = xt.repeat_interleave(top_k, dim=1)                              # (G, Tg·k, d)
    e_safe = torch.where(keep, flat_e, 0)
    s_safe = torch.where(keep, slot, 0)
    g_idx = torch.arange(G, device=x.device)[:, None].expand_as(e_safe)
    buf = torch.zeros((G, E, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((g_idx, e_safe, s_safe), torch.where(keep[..., None], xk, 0).to(x.dtype),
                        accumulate=True)

    g = torch.einsum("gecd,edf->gecf", buf, w_gate)
    u = torch.einsum("gecd,edf->gecf", buf, w_up)
    yb = torch.einsum("gecf,efd->gecd", F.silu(g) * u, w_down)          # (G, E, C, d)

    gathered = yb[g_idx, e_safe, s_safe]                                 # (G, Tg·k, d)
    wk = gate_w.reshape(G, Tg * top_k)
    gathered = torch.where(keep[..., None], gathered, 0) * wk[..., None].to(x.dtype)
    return gathered.reshape(G, Tg, top_k, d).sum(dim=2).reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materialize (B, S, V)
# ---------------------------------------------------------------------------


def _ce_chunk(hb: torch.Tensor, w_vocab: torch.Tensor, lb: torch.Tensor):
    """(summed CE, valid count) of one sequence chunk, in float32."""
    logits = hb.float() @ w_vocab.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.clamp(min=0).long()[..., None])[..., 0]
    valid = (lb >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_cross_entropy(h: torch.Tensor, w_vocab: torch.Tensor, labels: torch.Tensor, *,
                          chunk: int = 256) -> torch.Tensor:
    """Mean token CE of h @ w_vocab vs labels, computed in sequence chunks.

    h: (B, S, d); w_vocab: (d, V); labels: (B, S) int (< 0 = ignore). Each
    chunk's float32 logits (B, chunk, V) and the float32 copy of ``w_vocab``
    are transient: the backward pass recomputes them chunk by chunk, as the
    reference's checkpointed chunk body does, so the full (B, S, V) logits
    never exist.
    """
    S = h.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    body = remat(_ce_chunk)
    for s0 in range(0, S, chunk):
        l, c = body(h[:, s0:s0 + chunk], w_vocab, labels[:, s0:s0 + chunk])
        tot = tot + l
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)
