# Port of src/repro/models/layers.py: rewritten in PyTorch, names and layouts kept.
"""Shared neural building blocks of the transformer family, as plain functions
on tensors over flat parameter dicts (the reference's names and layouts).

RMS/layer norm, RoPE (partial rotary) and M-RoPE, ``repeat_kv``, masked
softmax ``attention`` with a chunked online-softmax path for long sequences,
SwiGLU / GELU MLPs, top-k MoE with capacity-limited, group-local scatter
dispatch, a chunked cross-entropy that never holds the full (B, S, V) logits,
and :func:`remat`, the reference's rematerialization policies
(``jax.checkpoint``) as ``torch.utils.checkpoint``.

On a device mesh (DTensor operands): :func:`decode_attention_sp` is the
reference's flash-decoding ``shard_map`` as a ``local_map`` over a
sequence-sharded cache, :func:`moe_block` dispatches one group per data
shard inside a ``local_map``, :func:`unpack_columns` splits a packed weight
into channel-aligned blocks with one all-to-all, and :func:`mesh_sum` reduces
a partial sum inside a ``local_map``; the reference's ``ws`` constraint is the
model's ``redistribute``. The chunked branch of :func:`attention` computes the
reference's function without its chunk-divisibility assert (a ragged last
chunk is fine). :func:`layer_range` is the models' layer loop (the
reference's ``lax.scan``): it publishes the layer index in :data:`LAYER`.
"""

from __future__ import annotations

import contextvars
import functools
import math
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.sharding.rules import PartitionSpec, is_dtensor, spec_placements

# the index of the layer whose body the model's layer loop is running, else
# None; ``repro_torch.launch.op_cost`` charges each op to it
LAYER: contextvars.ContextVar = contextvars.ContextVar("layer", default=None)


def layer_range(n: int) -> Iterator[int]:
    """``range(n)`` for a model's loop over its layers: :data:`LAYER` holds
    the index while each layer's body runs, and None once the loop ends."""
    try:
        for i in range(n):
            LAYER.set(i)
            yield i
    finally:
        LAYER.set(None)

__all__ = [
    "rms_norm",
    "layer_norm",
    "rope_table",
    "apply_rope",
    "apply_mrope",
    "repeat_kv",
    "attention",
    "decode_attention_sp",
    "redistribute",
    "mesh_sum",
    "unpack_columns",
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
                                  torch.tensor(sections, device=x.device),
                                  output_size=half)                              # (half,)
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
# Layouts on a device mesh
# ---------------------------------------------------------------------------


class _Layout(torch.autograd.Function):
    """``x`` laid out as ``placements``, and its gradient laid out so too
    before it goes back (JAX's ``with_sharding_constraint`` constrains the
    cotangent as well)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.before = x.placements
        ctx.after = tuple(placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Partial

        mesh = grad.device_mesh
        grad = grad.redistribute(mesh, ctx.after)   # a partial gradient is reduced here
        # a partial sum's gradient is the whole gradient on every rank (the
        # transpose of an all-reduce is the identity)
        back = [a if isinstance(b, Partial) else b for a, b in zip(ctx.after, ctx.before)]
        return grad.redistribute(mesh, back), None


def redistribute(x, mesh, placements):
    """DTensor ``x`` laid out as ``placements``, its gradient too. DTensor's
    own ``redistribute`` lets a gradient come back as a partial sum, and the
    matmul backward that receives one then gathers its weight to keep it so."""
    if tuple(x.placements) == tuple(placements) and not torch.is_grad_enabled():
        return x
    return _Layout.apply(x, tuple(placements))


class _Sum(torch.autograd.Function):
    """All-reduce (sum) of a plain tensor over one mesh dim. Each rank then
    uses the sum for its own channels only, so the gradient that comes back
    is a partial sum too: the backward pass all-reduces it."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        from torch.distributed import _functional_collectives as funcol

        ctx.group = (mesh, dim)
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", ctx.group))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(grad.contiguous(), "sum", ctx.group)), \
            None, None


def mesh_sum(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Inside ``local_map``: the sum of each rank's partial ``x`` over the
    mesh dims ``dims`` (one all-reduce each; none off the mesh), with the
    gradient of a sum that every rank uses for its own channels."""
    for d in dims:
        x = _Sum.apply(x, mesh, d)
    return x


def _unpack_order(n: int, T: int, r: int):
    """The all-to-all that turns column-block layout into channel layout,
    seen from rank ``r`` of ``T``: the packed dim holds ``n`` blocks of
    ``T`` pieces each (piece g = b·T + s is block b's piece for rank s) and
    rank r holds pieces r·n .. r·n + n - 1. Returns (the order in which r
    sends its own pieces, by destination rank; the pieces it sends to each
    rank; the pieces it receives from each rank), counted in pieces."""
    mine = range(r * n, (r + 1) * n)
    order = sorted(range(n), key=lambda j: ((r * n + j) % T, r * n + j))
    sends = [sum(1 for g in mine if g % T == s) for s in range(T)]
    recvs = [sum(1 for b in range(n) if (b * T + r) // n == s) for s in range(T)]
    return order, sends, recvs


def unpack_columns(w: torch.Tensor, n: int):
    """The ``n`` equal column blocks of a packed weight (..., n·m), such as
    Mamba's ``in_proj`` (x and z side by side), as ``n`` tensors of
    (..., m) laid out as ``w``.

    Off the mesh they are views. On a mesh whose dim cuts the packed dim,
    rank r of T holds packed columns [r·c, (r+1)·c), c = n·m / T: on two
    ranks rank 0 holds all of x and rank 1 all of z, where each rank needs
    its own m / T columns of every block. One all-to-all over that mesh dim
    moves each rank's pieces to their owners (its backward pass is the
    inverse all-to-all): it moves a rank's c columns of its FSDP shard at
    most, where splitting the product (B, S, n·m) would gather it whole."""
    from repro_torch.sharding.rules import is_dtensor

    if not is_dtensor(w):
        return w.chunk(n, dim=-1)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    cut = [i for i, p in enumerate(w.placements) if p == Shard(w.dim() - 1)]
    if len(cut) > 1:
        raise ValueError(f"the packed dim of a {tuple(w.shape)} weight is split over mesh dims "
                         f"{cut}; unpack_columns moves it over one")
    if not cut:
        pl = tuple(w.placements)
        return local_map(lambda t: t.chunk(n, dim=-1), out_placements=(pl,) * n,
                         in_placements=(pl,), device_mesh=mesh)(w)
    dim = cut[0]
    T = mesh.size(dim)
    order, sends, recvs = _unpack_order(n, T, mesh.get_local_rank(dim))

    def local(t):
        k = t.shape[-1] // n                                   # one piece's columns
        rows = t.movedim(-1, 0).reshape(n, k, *t.shape[:-1])   # pieces, columns first
        send = rows[list(order)].reshape(n * k, *t.shape[:-1])
        got = funcol.all_to_all_single_autograd(send, [c * k for c in recvs],
                                                [c * k for c in sends], (mesh, dim))
        got = funcol.wait_tensor(got).reshape(n, k, *t.shape[:-1])
        return tuple(got[b].movedim(0, -1) for b in range(n))

    pl = tuple(w.placements)
    return local_map(local, out_placements=(pl,) * n, in_placements=(pl,),
                     device_mesh=mesh)(w)


# ---------------------------------------------------------------------------
# Decode attention: flash-decoding over a sequence-sharded KV cache
# ---------------------------------------------------------------------------


def decode_attention_sp(q, k_cache, v_cache, cache_len: int, *, mesh, sp_axis: str = "model",
                        batch_axes=None, window: int = 0):
    """One-token attention over a cache whose sequence dim is sharded
    (``layers.py:247-308``).

    q: (B, H, D) DTensor, replicated over ``sp_axis``; k_cache/v_cache:
    (B, S, Kv, D) DTensors laid out as ``(batch_axes[0], sp_axis, None,
    None)``; cache_len: the number of valid cache entries (positions >=
    cache_len are masked; with ``window`` > 0 positions <= cache_len - window
    are also masked). Inputs in another layout are redistributed to these.

    Flash-decoding on the mesh: each rank of ``sp_axis`` computes a partial
    online softmax over its local sequence chunk (its global positions start
    at the chunk's offset in the layout: where ``sp_axis`` does not divide S,
    DTensor gives the last ranks shorter chunks, or none), then the partials
    merge with one all-reduce max and two all-reduce sums of (B, H·D)-sized
    tensors over that axis: bytes moved are O(B·H·D), never a cache all-gather.
    """
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map

    B, H, D = q.shape
    Kv = k_cache.shape[2]
    G = H // Kv
    scale = float(1.0 / torch.sqrt(torch.tensor(float(D))))
    bentry = tuple(batch_axes)[0] if batch_axes is not None else None
    sp_dim = mesh.mesh_dim_names.index(sp_axis)
    group = (mesh, sp_dim)

    q_pl = spec_placements(mesh, PartitionSpec(bentry, None, None))
    c_pl = spec_placements(mesh, PartitionSpec(bentry, sp_axis, None, None))
    lo = compute_local_shape_and_global_offset(k_cache.shape, mesh, c_pl)[1][1]

    def local(q, kc, vc):
        # every shape here is a local shard's
        B, chunk = kc.shape[0], kc.shape[1]
        qg = q.reshape(B, Kv, G, D)
        if chunk == 0:   # an uneven layout left this rank no positions
            m = torch.full((B, Kv, G), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            o = torch.zeros((B, Kv, G, D), dtype=torch.float32, device=q.device)
        else:
            pos = lo + torch.arange(chunk, device=kc.device)
            s = torch.einsum("bkgd,bskd->bkgs", qg.float(), kc.float()) * scale
            valid = pos < cache_len
            if window:
                valid &= pos > cache_len - window
            s = torch.where(valid[None, None, None, :], s, NEG_INF)
            m = s.amax(dim=-1)                                   # (B, Kv, G)
            p = torch.exp(s - m[..., None])
            l = p.sum(dim=-1)
            o = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype).float(), vc.float())
        m_g = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
        corr = torch.exp(m - m_g)
        l_g = funcol.wait_tensor(funcol.all_reduce(l * corr, "sum", group))
        o_g = funcol.wait_tensor(funcol.all_reduce(o * corr[..., None], "sum", group))
        out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
        return out.reshape(B, H, D).to(q.dtype)

    return local_map(local, out_placements=list(q_pl), in_placements=(q_pl, c_pl, c_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k_cache, v_cache)


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


def _moe_groups(x, router_w, w_gate, w_up, w_down, top_k: int, capacity_factor: float,
                n_groups: int):
    """The group-local dispatch of :func:`moe_block`: (output, mean router
    probability per expert, share of first choices per expert)."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S
    G = n_groups if n_groups > 0 and T % n_groups == 0 else 1
    Tg = T // G
    xt = x.reshape(G, Tg, d)

    probs = torch.softmax(xt.float() @ router_w.float(), dim=-1)        # (G, Tg, E)
    gate_w, expert_idx = torch.topk(probs, top_k, dim=-1)                # (G, Tg, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))

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
    return gathered.reshape(G, Tg, top_k, d).sum(dim=2).reshape(B, S, d), me, ce


def _moe_mesh(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor, n_groups):
    """:func:`moe_block` on DTensors: each rank dispatches its own tokens
    (batch-sharded ``x``, replicated elsewhere) to its own slice of the
    experts' d_ff (the weights' FSDP dims gathered by the caller). A data
    shard's tokens are whole groups, so the groups are the reference's.

    On the mesh dims that cut d_ff each rank's output, and its gradients of
    ``x`` and the router, are partial sums; on the batch dims the weights'
    gradients are. The router statistics are returned as partial sums over
    both kinds of dim, each rank's share scaled down by their count, so the
    aux loss and its gradient count every rank once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    # whole values: a Partial x (a norm's output can stay a partial sum) is reduced
    x = x.redistribute(mesh, [Shard(0) if p == Shard(0) else Replicate() for p in x.placements])
    batch = [p == Shard(0) for p in x.placements]
    cut = [any(isinstance(w.placements[i], Shard) for w in (w_gate, w_up, w_down))
           for i in range(mesh.ndim)]
    split = math.prod(mesh.size(i) for i in range(mesh.ndim) if batch[i])
    share = split * math.prod(mesh.size(i) for i in range(mesh.ndim) if cut[i] and not batch[i])
    local_groups = n_groups // split if n_groups % split == 0 else 1

    def placed(own, on_batch, on_cut):
        return tuple(on_batch if batch[i] else on_cut if cut[i] else own[i]
                     for i in range(mesh.ndim))

    rep = [Replicate()] * mesh.ndim
    out_pl = placed(rep, Shard(0), Partial())      # also x's gradient
    stat_pl = placed(rep, Partial(), Partial())    # also the router's gradient
    w_grad = [tuple(Partial() if batch[i] else w.placements[i] for i in range(mesh.ndim))
              for w in (w_gate, w_up, w_down)]

    def local(x, router_w, w_gate, w_up, w_down):
        out, me, ce = _moe_groups(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor,
                                  local_groups)
        return out, me / share, ce / share

    return local_map(local, out_placements=(out_pl, stat_pl, stat_pl),
                     in_grad_placements=(out_pl, stat_pl, *w_grad),
                     device_mesh=mesh)(x, router_w, w_gate, w_up, w_down)


def moe_block(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
              n_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-dropping top-k MoE with group-local scatter dispatch (``layers.py:336``).

    x: (B, S, d); router_w: (d, E); expert weights: (E, d, f) / (E, f, d).
    Returns (output (B, S, d), aux load-balancing loss scalar). The T tokens
    split into G = ``n_groups`` groups of T/G (one group when G does not divide
    T), one per data-parallel shard; each group dispatches into its own
    (E, C, d) buffer, C = max(1, (T/G)·k·cf / E) slots per expert filled in
    token order, and drops the rest. On DTensors (a mesh) each data shard
    dispatches its own groups locally (:func:`_moe_mesh`).
    """
    E = router_w.shape[-1]
    if is_dtensor(x):
        out, me, ce = _moe_mesh(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor,
                                n_groups)
    else:
        out, me, ce = _moe_groups(x, router_w, w_gate, w_up, w_down, top_k, capacity_factor,
                                  n_groups)
    # Switch-style aux loss: E * sum_e (fraction routed to e) * (mean prob e)
    return out, E * (me * ce).sum()


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never materialize (B, S, V)
# ---------------------------------------------------------------------------


def _ce_chunk(hb: torch.Tensor, w_vocab: torch.Tensor, lb: torch.Tensor):
    """(summed CE, valid count) of one sequence chunk, in float32."""
    logits = hb.float() @ w_vocab.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # vocab-sharded logits: each rank picks the gold logit from its own
        # slice (zero elsewhere) and the sum over the vocabulary adds them
        # exactly; DTensor's rule for a gather on the sharded dim fails
        from torch.distributed.tensor import Replicate, distribute_tensor

        vocab = distribute_tensor(torch.arange(logits.shape[-1], device=lb.device),
                                  logits.device_mesh, [Replicate()] * logits.device_mesh.ndim,
                                  src_data_rank=None)
        gold = torch.where(vocab == lb.clamp(min=0).long()[..., None], logits, 0.0).sum(dim=-1)
    else:
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
