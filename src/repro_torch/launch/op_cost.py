# Port of src/repro/launch/hlo_cost.py and hlo_analysis.py: what they count,
# read from the aten ops a step dispatches instead of from compiled HLO text.
"""Per-device cost of one step, counted op by op.

The reference compiles a step for a mesh and reads the partitioned HLO: dot
and convolution FLOPs from contraction dims, one FLOP per output element of an
elementwise op, HBM bytes at fusion boundaries, collective operand bytes, all
scaled by loop trip counts. Here the step simply runs (on ``meta`` tensors for
the dry run, on the card's tensors for a measured step) under
:class:`OpCost`, a ``TorchDispatchMode`` that sees every aten op:

* FLOPs: dots (``mm``, ``bmm``, ``addmm``, convolutions, attention) through
  ``torch.utils.flop_counter``'s formulas; a pointwise op one per output
  element; a reduction one per input element; views and copies none;
* HBM bytes: the bytes of every operand and output of every op that is not a
  view. In eager PyTorch each op is its own kernel, so this is the honest
  analogue of XLA charging bytes at fusion boundaries (and counts more: a
  fused program would not write most intermediates);
* collectives: operand bytes and counts by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``), from the
  ``c10d_functional`` ops and DTensor's all-to-all;
* peak memory: the bytes the step holds live at once, beside those of its
  arguments (parameters, optimizer state, batch, cache).

Counts are per device. On a mesh, DTensor first runs each op on fake tensors
of the global shape to propagate its sharding, then runs the local op: only
the local op is counted (an op with a fake operand or output is DTensor's
propagation). A python loop replaces ``lax.scan``, so every layer and every
microbatch is counted where it runs, and the backward pass and its
recomputation are counted as they run. Each op is also attributed to the
innermost frame of ``repro_torch`` that issued it, to the layer index the
model's layer loop publishes (``layers.layer_range``), and to its phase
(forward, recompute, backward), for ``repro_torch.launch.hotspots``.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.layers import LAYER

__all__ = ["OpCost", "CostSummary", "COLLECTIVES", "train_dot_flops"]

aten = torch.ops.aten

# c10d_functional op -> the reference's collective kind
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")
_REDUCTIONS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.logsumexp,
    aten._softmax, aten._log_softmax, aten.topk, aten.cumsum, aten.var, aten.var_mean,
    aten.norm, aten.linalg_vector_norm, aten.argmax, aten.argmin, aten.prod, aten.all,
    aten.any, aten._softmax_backward_data, aten._log_softmax_backward_data,
}
_MOVES = {  # data movement: bytes, no FLOPs
    aten.copy_, aten._to_copy, aten.clone, aten.cat, aten.stack, aten.index, aten.index_put,
    aten.index_put_, aten.gather, aten.scatter, aten.scatter_add, aten.embedding,
    aten.embedding_dense_backward, aten.repeat_interleave, aten.repeat, aten.fill_,
    aten.zero_, aten.zeros_like, aten.ones_like, aten.full_like, aten.empty_like,
    aten.constant_pad_nd, aten.where, aten.masked_fill, aten.select_backward,
    aten.slice_backward, aten.index_select, aten.new_zeros, aten.one_hot,
    aten._unsafe_index_put, aten._unsafe_index, aten.masked_fill_, aten.index_add,
    aten.tril, aten.triu,
}
_MODEL = "repro_torch.models"
_HELPERS = ("_ws", "redistribute", "forward", "backward")
_PKG = "repro_torch"


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def _site(pkg: str = _PKG) -> Tuple[Optional[str], Optional[int]]:
    """(innermost frame of ``pkg`` as ``module.function``, or None; the index
    the model's layer loop publishes, ``layers.LAYER``). Layout helpers
    (``_ws``, ``redistribute`` and autograd functions' ``forward`` /
    ``backward``) give their caller's name."""
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        name = f.f_code.co_name
        if (mod.startswith(pkg) and not mod.startswith(f"{_PKG}.launch")
                and name not in _HELPERS):
            return f"{mod.rsplit('.', 1)[-1]}.{name}", LAYER.get()
        f = f.f_back
    return None, LAYER.get()


@dataclass
class CostSummary:
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_count: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def collective_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def add(self, flops: float, dot: float, nbytes: float, kind: Optional[str],
            cbytes: float) -> None:
        self.flops += flops
        self.dot_flops += dot
        self.bytes += nbytes
        if kind is not None:
            self.coll_bytes[kind] += cbytes
            self.coll_count[kind] += 1


class _Sites(TorchFunctionMode):
    """Records, for every autograd node a forward op makes, where the op was
    issued: the backward pass then charges its ops to the same place."""

    def __init__(self, table: Dict[int, Tuple[str, Optional[int]]]):
        super().__init__()
        self.table = table

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled() and torch._C._current_autograd_node() is None:
            # the op's own nodes: from its outputs' grad_fn back to nodes
            # already recorded (a composite op such as matmul makes several)
            todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
            where = None
            while todo:
                node = todo.pop()
                if node is None or node._sequence_nr() in self.table:
                    continue
                if where is None:
                    site, layer = _site()
                    where = (site or "(outside the model)", layer)
                self.table[node._sequence_nr()] = where
                todo.extend(n for n, _ in node.next_functions)
        return out


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCost() as c:`` (per device).

    ``c.total`` is a :class:`CostSummary`; ``c.by_key`` holds one per
    ``(phase, layer, site)``; ``c.census`` counts ops by name;
    ``c.peak_bytes`` is the most bytes the step's own tensors held at once
    (its arguments are not counted; :meth:`arguments` adds them).
    """

    def __init__(self, attribute: bool = True):
        super().__init__()
        self.total = CostSummary()
        self.by_key: Dict[Tuple[str, Optional[int], str], CostSummary] = defaultdict(CostSummary)
        self.census: Dict[str, int] = defaultdict(int)
        self.attribute = attribute
        self._sites: Dict[int, Tuple[str, Optional[int]]] = {}
        self._fn_mode = _Sites(self._sites) if attribute else None
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._storages: Dict[int, int] = {}

    def __enter__(self):
        if self._fn_mode is not None:
            self._fn_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._fn_mode is not None:
            self._fn_mode.__exit__(*exc)
        return out

    def arguments(self, *trees) -> None:
        """Count the bytes each rank holds of ``trees`` (DTensors: their local
        pieces) as the step's arguments."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(trees):
            self.argument_bytes += _nbytes(t.to_local() if isinstance(t, DTensor) else t)

    # ------------------------------------------------------------------
    def _track(self, out_tensors, in_tensors) -> None:
        """Live bytes: a new storage counts from the op that makes it until it
        is freed."""
        ins = {id(t.untyped_storage()) for t in in_tensors}
        for t in out_tensors:
            st = t.untyped_storage()
            key = id(st)
            if key in ins or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def _where(self) -> Tuple[str, Optional[int], str]:
        node = torch._C._current_autograd_node()
        if node is None:
            site, layer = _site()
            return "forward", layer, site or "(outside the model)"
        fwd_site, layer = self._sites.get(node._sequence_nr(), ("(unattributed)", None))
        site, _ = _site(_MODEL)
        if site is not None:  # a model frame on the stack: a checkpoint's recompute
            return "recompute", layer, site
        return "backward", layer, fwd_site

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out  # DTensor's sharding propagation at the global shape
        flops, dot, nbytes, kind, cbytes = self._cost(func, args, kwargs, out, ins, outs)
        name = str(func.overloadpacket)
        self.census[name] += 1
        self.total.add(flops, dot, nbytes, kind, cbytes)
        if self.attribute:
            self.by_key[self._where()].add(flops, dot, nbytes, kind, cbytes)
        if not func.is_view:
            self._track(outs, ins)
        return out

    def _cost(self, func, args, kwargs, out, ins, outs):
        packet = func.overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            kind = COLLECTIVES.get(packet.__name__)
            if kind is None:  # wait_tensor and the like
                return 0.0, 0.0, 0.0, None, 0.0
            cb = float(sum(_nbytes(t) for t in ins))
            return 0.0, 0.0, 0.0, kind, cb
        if func.is_view or not outs:
            return 0.0, 0.0, 0.0, None, 0.0
        nbytes = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            return f, f, nbytes, None, 0.0
        if packet in _MOVES:
            return 0.0, 0.0, nbytes, None, 0.0
        if packet in _REDUCTIONS:
            return float(max(t.numel() for t in ins)), 0.0, nbytes, None, 0.0
        if torch.Tag.pointwise in func.tags:
            return float(max(t.numel() for t in outs)), 0.0, nbytes, None, 0.0
        return 0.0, 0.0, nbytes, None, 0.0

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        c = self.total
        return {
            "collective_total_bytes": c.collective_total,
            "by_op": {k: float(v) for k, v in sorted(c.coll_bytes.items())},
            "counts": {k: int(v) for k, v in sorted(c.coll_count.items())},
        }


def train_dot_flops(cfg, batch: int, seq: int) -> float:
    """Closed form of the dot FLOPs one train step of a dense transformer
    (``TransformerLM``, remat "nothing", sequences of at most 2048 tokens: the
    one-block attention) performs, for ``batch`` sequences of ``seq`` tokens.

    Each weight matmul runs forward once and backward twice (input and weight
    gradients): 3 × 2·T·N. The "nothing" recompute runs each layer's forward
    again up to its last saved tensor: every matmul but the MLP's down
    projection (``torch.utils.checkpoint`` stops early), and the whole
    cross-entropy chunk. Attention's score and value products over the full
    (unmasked) S × S block run forward, recomputed and twice backward:
    4 × 4·B·H·S²·hd per layer. Microbatches split the tokens and change none
    of it."""
    T, L, d, f = batch * seq, cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Kv, hd, V = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab
    if cfg.moe is not None or seq > 2048:
        raise ValueError("the closed form covers dense models at seq <= 2048")
    proj = d * H * hd + 2 * d * Kv * hd + H * hd * d
    return float(3 * 2 * T * (L * (proj + 3 * d * f) + d * V)
                 + 2 * T * (L * (proj + 2 * d * f) + d * V)
                 + 16 * L * batch * H * seq * seq * hd)
