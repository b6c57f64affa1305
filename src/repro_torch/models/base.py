"""What the port's four model classes share, on one card or on a device mesh.

:class:`ModelBase` holds a model's config, its full-sequence attention
(``attn``: the flash kernel or plain), its remat policy and, on a mesh, the
``DeviceMesh`` and the :class:`~repro_torch.sharding.rules.ShardingRules`
that lay its DTensors out. ``TransformerLM``, ``MambaLM``, ``Zamba2LM`` and
``WhisperModel`` derive from it. Off the mesh every helper is the plain
computation; on a mesh each is the reference's GSPMD program written out:

* :meth:`_ws` is the reference's ``with_sharding_constraint`` (a
  ``redistribute`` that constrains the gradient too);
* :meth:`_gathered` / :meth:`_layer` gather a layer's weights over their FSDP
  axes where the layer uses them (the backward pass reduce-scatters their
  gradients);
* :meth:`_local` and :meth:`_split` run plain tensor code on each rank's own
  pieces (``local_map``): RoPE, attention and the flash kernel, the SSMs'
  conv and scan;
* :meth:`_lookup` is the vocab-parallel embedding, :meth:`_write_kv` the
  decode's in-place write into a sequence-sharded cache.

The module-level helpers (:func:`stacked_params`, :func:`layer_params`, ...)
are the flat-dict plumbing every model uses.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.sharding.rules import (ParamSpec, PartitionSpec, ShardingRules, axis_sizes,
                                        named_sharding, safe_entry, spec_placements)

__all__ = ["ModelBase", "ATTN_IMPLS", "check_attn", "stacked_params", "layer_params",
           "count_params", "logits_f32"]

ATTN_IMPLS = ("flash", "plain")


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


class ModelBase:
    # cache entries the serving engine grows before decode (along their "sp" axis)
    GROWING_CACHE = ()

    def __init__(self, cfg, attn: str = "flash", remat_policy: str = "nothing", *,
                 mesh=None, rules=None):
        """With ``mesh`` the model runs on DTensors laid out by ``rules`` (the
        mesh's default rules when None)."""
        self.cfg = cfg
        self.attn = check_attn(attn)
        self.remat_policy = L.check_remat(remat_policy)
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None else ShardingRules.for_mesh(mesh)

    def param_count(self) -> int:
        return count_params(self.param_templates())

    def active_param_count(self) -> int:
        """Parameters one token uses: all of them but in a mixture of experts."""
        return self.param_count()

    # ------------------------------------------------------------------
    # Sharding helpers
    # ------------------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def sp_decode(self) -> bool:
        """Decode attends over a sequence-sharded cache (a model axis wider
        than one): :func:`layers.decode_attention_sp`."""
        return self.sharded and axis_sizes(self.mesh).get("model", 1) > 1

    def _ws(self, x, *axes):
        """``x`` laid out as ``axes`` (the reference's
        ``with_sharding_constraint``): a ``redistribute`` on the mesh."""
        if not self.sharded:
            return x
        return L.redistribute(x, self.mesh, named_sharding(self.mesh, axes, self.rules,
                                                           x.shape).placements)

    def _placements(self, axes, shape) -> tuple:
        return named_sharding(self.mesh, axes, self.rules, shape).placements

    def _replicated(self, x):
        """A plain tensor that joins DTensor arithmetic: replicated on the mesh."""
        if not self.sharded:
            return x
        from torch.distributed.tensor import Replicate, distribute_tensor

        return distribute_tensor(x, self.mesh, [Replicate()] * self.mesh.ndim,
                                 src_data_rank=None)

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

    def _unpacked(self, w, n: int):
        """The ``n`` column blocks of a packed weight (``layers.unpack_columns``),
        each gathered over its FSDP axes."""
        return tuple(self._gathered(b) for b in L.unpack_columns(w, n))

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

    def _split(self, fn, work, out_placements, *args):
        """``fn`` on each rank's own pieces of ``args``, as they are laid out
        (``local_map``); plain ``fn`` off the mesh. ``work`` is the DTensor
        whose layout divides the work between ranks (its batch rows, its
        channels): on each mesh dim that cuts it, an input laid out whole
        gets a partial-sum gradient, since each rank uses it for its own rows
        or channels only. Inputs that are not DTensors pass as they are."""
        if not self.sharded:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Partial, Shard
        from torch.distributed.tensor.experimental import local_map

        cut = [isinstance(p, Shard) for p in work.placements]
        in_pl = [a.placements if isinstance(a, DTensor) else None for a in args]
        grads = [None if pl is None else tuple(
            p if isinstance(p, Shard) else Partial() if c else p for p, c in zip(pl, cut))
            for pl in in_pl]
        return local_map(fn, out_placements=out_placements, in_placements=in_pl,
                         in_grad_placements=grads, device_mesh=self.mesh)(*args)

    def _cut_dims(self, x, dim: int) -> tuple:
        """The mesh dims that split tensor dim ``dim`` of DTensor ``x`` (none
        off the mesh): where a contraction over it leaves partial sums."""
        if not self.sharded:
            return ()
        from torch.distributed.tensor import Shard

        return tuple(i for i, p in enumerate(x.placements) if p == Shard(dim % x.dim()))

    # ------------------------------------------------------------------
    # Attention
    # ------------------------------------------------------------------
    def _qkv(self, x, p, positions, positions3=None):
        """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,Kv,hd) with RoPE applied."""
        c = self.cfg
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

    def _merge_heads(self, x):
        """(B, S, H, hd) -> (B, S, H·hd), laid out ("batch", None, "tp") before
        the output projection, so that the backward pass hands its view a
        gradient it can split into heads."""
        B, S = x.shape[:2]
        return self._ws(x.reshape(B, S, -1), "batch", None, "tp")

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

    def _attend(self, q, kH, vH, causal: bool):
        """Full-sequence attention, the kernel or plain (q (B, Sq, H, hd);
        k, v (B, Sk, H, hd)). On a mesh each rank attends over its own batch
        rows and its own heads; where the tp axes do not divide the heads
        (qwen2's 28 on 16) the plain attention splits the query rows over the
        sp axes instead (K and V whole on every rank, each rank's rows at
        their global offset), so no rank repeats another's work. The flash
        kernel has no query offset: there it runs on every head of the rank's
        rows."""
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
            pl = self._placements(("batch", None, "tp", None), q.shape)
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

    def _decode_attend(self, q, k_cache, v_cache, cache_len: int, *, causal: bool = True,
                       window: int = 0):
        """One query token (q (B, 1, H, hd)) against a (B, S, Kv, hd) cache
        holding ``cache_len`` valid positions: (B, H, hd). On a model axis
        wider than one, flash-decoding over the sequence-sharded cache
        (:func:`layers.decode_attention_sp`); else :func:`layers.attention`
        with the query at position ``cache_len - 1`` (``causal``) or over
        the whole cache (not ``causal``)."""
        c = self.cfg
        B = q.shape[0]
        if self.sp_decode:
            bentry = safe_entry(self.mesh, self.rules, "batch", B)
            return L.decode_attention_sp(q[:, 0], k_cache, v_cache, cache_len, mesh=self.mesh,
                                         sp_axis="model", batch_axes=(bentry,), window=window)

        def attend(q, k, v):
            return L.attention(q, k, v, causal=causal, q_offset=cache_len - 1, window=window)

        kH, vH = L.repeat_kv(k_cache, c.n_heads), L.repeat_kv(v_cache, c.n_heads)
        pl = self._placements(("batch", None, None, None), q.shape) if self.sharded else None
        return self._local(attend, pl, q, kH, vH)[:, 0]

    def _write_kv(self, cache, i: int, pos: int, new) -> None:
        """``cache[i, :, pos] = new[:, 0]`` in place (cache (L, B, S, Kv, hd),
        new (B, 1, Kv, hd)). On a mesh only the rank that owns sequence
        position ``pos`` writes, into its own shard: a DTensor ``index_put``
        on the sharded dim would move the cache."""
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

    # ------------------------------------------------------------------
    # Embedding
    # ------------------------------------------------------------------
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

    def _embed_tokens(self, tokens, table):
        """Token embeddings (B, S, d), laid out ("batch", None, None)."""
        return self._ws(self._lookup(tokens, table), "batch", None, None)
