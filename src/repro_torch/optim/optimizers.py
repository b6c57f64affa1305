# Port of src/repro/optim/optimizers.py: rewritten in PyTorch, names kept.
"""Optimizers built in-tree: AdamW and Adafactor, with warmup-cosine
schedules and global-norm clipping.

Both optimizers expose ``state_templates`` (the optimizer state as
:class:`ParamSpec` trees: moments take their parameter's shape and logical
axes; Adafactor's factored second moment drops the last or second-to-last
dim) and ``update(grads, state, params) -> (new_params, new_state)``.

What changes from the reference: ``update`` runs under ``torch.no_grad()``
and writes the new parameters and moments into the given tensors in place
(the reference's jitted step donates them); the returned dicts hold those same
tensors and a new ``step``. The per-step scalars (learning rate, bias
corrections, Adafactor's decay) are computed on the host in float64 from the
step count and rounded once to float32, where the reference computes them in
float32 on the device, correctly rounded; PyTorch's float32 ``pow`` and
``cos`` are not. The moment arithmetic is the reference's, op for op, in
float32. Trees are flat dicts (the moments nested one level), walked in
sorted key order as ``jax.tree_util`` walks them.

On a device mesh the parameters, gradients and moments are DTensors, each
moment placed by ``spec_tree_shardings`` of ``state_templates`` (AdamW's like
its parameter); the updates run in place on each rank's own pieces, and the
global norm's sum of squares is reduced over the whole mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.sharding.rules import ParamSpec

__all__ = ["OptimizerConfig", "make_optimizer", "AdamW", "Adafactor",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128    # factor only dims >= this


def _f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (as a Python float)."""
    return float(np.float32(x))


def warmup_cosine(cfg: OptimizerConfig) -> Callable[[int], float]:
    """step (an int or 0-dim tensor) -> learning rate, a float32 value."""
    def sched(step) -> float:
        step = int(step)
        warm = step / max(cfg.warmup_steps, 1)
        t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        t = min(max(t, 0.0), 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * t))
        return _f32(cfg.lr * (warm if step < cfg.warmup_steps else cos))
    return sched


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32; the tensors'
    sums are added in sorted key order, as ``jax.tree_util`` walks a dict."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree)))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float):
    """(tree scaled by min(1, max_norm / norm) in float32, each leaf back in
    its dtype; the norm before clipping)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, g


def _step_tensor(state) -> tuple:
    """(the next step as an int, as a 0-dim int32 tensor beside the old one)."""
    step = state["step"] + 1
    return int(step), step


def _zeros_of(params, shardings):
    """``z(part, name, shape, like=None)``: float32 zeros of one state leaf.
    With ``shardings`` it is a DTensor laid out by ``shardings[part][name]``,
    of which each rank makes only its own piece; without, ``zeros_like(like)``
    where the leaf has its parameter's shape (a DTensor parameter gives a
    DTensor laid out like it), else plain zeros on the parameters' device."""
    dev = next(iter(params.values())).device if params else None

    def z(part, name, shape, like=None):
        if shardings is not None:
            return shardings[part][name].zeros(shape, torch.float32)
        if like is not None:
            return torch.zeros_like(like, dtype=torch.float32)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return z


def _apply(p: torch.Tensor, delta: torch.Tensor, lr: float) -> None:
    """p <- p - lr * delta in float32, rounded once to p's dtype, in place."""
    if p.dtype == torch.float32:
        p.sub_(delta, alpha=lr)
    else:
        p.copy_(p.float().sub_(delta, alpha=lr))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamW:
    """Decoupled weight decay Adam; fp32 moments regardless of param dtype."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.sched = warmup_cosine(cfg)

    def init(self, params, shardings=None):
        """Zero moments beside ``params``. ``shardings`` (the tree of
        ``spec_tree_shardings`` over :meth:`state_templates`) makes each moment
        a DTensor laid out by it, built shard by shard on every rank."""
        z = _zeros_of(params, shardings)
        dev = next(iter(params.values())).device if params else None
        return {
            "m": {k: z("m", k, p.shape, p) for k, p in params.items()},
            "v": {k: z("v", k, p.shape, p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def state_templates(self, templates: Dict[str, ParamSpec]) -> Dict[str, Dict]:
        f32 = {k: ParamSpec(v.shape, "float32", v.axes, stacked=v.stacked)
               for k, v in templates.items()}
        return {"m": f32, "v": dict(f32), "step": ParamSpec((), "int32", ())}

    @torch.no_grad()
    def update(self, grads, state, params):
        c = self.cfg
        t, step = _step_tensor(state)
        lr = self.sched(t)
        # the reference: 1 - b ** t with b and the power in float32
        bc1 = _f32(1 - _f32(_f32(c.b1) ** t))
        bc2 = _f32(1 - _f32(_f32(c.b2) ** t))
        for k in sorted(params):
            p, m, v = params[k], state["m"][k], state["v"][k]
            g = grads[k].float()
            m.mul_(c.b1).add_(g, alpha=1 - c.b1)
            v.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
            del g
            delta = torch.div(m, bc1)
            delta.div_(torch.div(v, bc2).sqrt_().add_(c.eps))
            if p.ndim >= 2:  # no decay on norms/scalars
                delta.add_(p.float(), alpha=c.weight_decay)
            _apply(p, delta, lr)
        return params, {"m": state["m"], "v": state["v"], "step": step}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), no momentum
# ---------------------------------------------------------------------------

class Adafactor:
    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.sched = warmup_cosine(cfg)

    def _factored(self, shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= self.cfg.factored_min_dim \
            and shape[-2] >= self.cfg.factored_min_dim

    def init(self, params, shardings=None):
        """Zero second moments beside ``params``; ``shardings`` as in
        :meth:`AdamW.init`."""
        z = _zeros_of(params, shardings)
        dev = next(iter(params.values())).device if params else None
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev), "vr": {}, "vc": {},
                 "v": {}}
        for k, p in params.items():
            if self._factored(p.shape):
                state["vr"][k] = z("vr", k, p.shape[:-1])
                state["vc"][k] = z("vc", k, p.shape[:-2] + p.shape[-1:])
            else:
                state["v"][k] = z("v", k, p.shape, p)
        return state

    def state_templates(self, templates: Dict[str, ParamSpec]) -> Dict[str, Dict]:
        out = {"step": ParamSpec((), "int32", ()), "vr": {}, "vc": {}, "v": {}}
        for k, t in templates.items():
            if self._factored(t.shape):
                out["vr"][k] = ParamSpec(t.shape[:-1], "float32", t.axes[:-1], stacked=t.stacked)
                out["vc"][k] = ParamSpec(t.shape[:-2] + t.shape[-1:], "float32",
                                         t.axes[:-2] + t.axes[-1:], stacked=t.stacked)
            else:
                out["v"][k] = ParamSpec(t.shape, "float32", t.axes, stacked=t.stacked)
        return out

    @torch.no_grad()
    def update(self, grads, state, params):
        c = self.cfg
        t, step = _step_tensor(state)
        lr = self.sched(t)
        # the reference: 1 - t ** -decay_rate in float32
        beta2 = _f32(1.0 - _f32(t ** _f32(-c.decay_rate)))
        keep = _f32(1.0 - beta2)
        for k in sorted(params):
            p = params[k]
            g = grads[k].float()
            g2 = torch.square(g).add_(1e-30)
            if self._factored(p.shape):
                vr, vc = state["vr"][k], state["vc"][k]
                vr.mul_(beta2).add_(g2.mean(dim=-1), alpha=keep)
                vc.mul_(beta2).add_(g2.mean(dim=-2), alpha=keep)
                denom = vr.mean(dim=-1, keepdim=True)
                u = (g * torch.rsqrt(torch.clamp(vr[..., None] / denom[..., None], min=1e-30))
                     * torch.rsqrt(torch.clamp(vc[..., None, :], min=1e-30)))
            else:
                v = state["v"][k]
                v.mul_(beta2).add_(g2, alpha=keep)
                u = g * torch.rsqrt(torch.clamp(v, min=1e-30))
            del g, g2
            # update clipping (RMS(u) <= 1)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            delta = u / torch.clamp(rms_u, min=1.0)
            if p.ndim >= 2:
                delta.add_(p.float(), alpha=c.weight_decay)
            _apply(p, delta, lr)
        return params, {"step": step, "vr": state["vr"], "vc": state["vc"], "v": state["v"]}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return AdamW(cfg)
    if cfg.name == "adafactor":
        return Adafactor(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
