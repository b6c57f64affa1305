# Port of src/repro/train/step.py: rewritten in PyTorch, names kept.
"""Train step: microbatched gradient accumulation + clipping + update.

One function (``make_train_step``) serves the trainer, the smoke tests and
the card's smoke run.

* ``microbatches`` — the batch splits into G microbatches along its first
  dim; each gets its own forward and backward pass, so activation memory is
  bounded by one microbatch, and its gradients are added into buffers of
  ``grad_dtype``, as the reference's scan adds ``g.astype(gsum.dtype)``.
* ``grad_dtype`` — "float32" (default) or "bfloat16": the accumulator's dtype
  and the dtype the optimizer receives. The fp32 Adam moments act as the
  error-feedback accumulator.

Gradients come from ``torch.autograd.grad`` on detached leaves of the
parameters, never from ``.grad``: autograd would accumulate a bf16
parameter's ``.grad`` in bf16, where the reference accumulates in
``grad_dtype``. The optimizer then updates the parameters in place.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.optim.optimizers import clip_by_global_norm

__all__ = ["make_train_step", "make_eval_step"]


def make_train_step(
    model,
    optimizer,
    *,
    microbatches: int = 1,
    grad_dtype: str = "float32",
    clip_norm: float = 1.0,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""
    gdt = getattr(torch, grad_dtype)

    def value_and_grad(params: Dict[str, torch.Tensor], mb):
        names = sorted(params)
        with torch.enable_grad():
            leaves = {k: params[k].detach().requires_grad_(True) for k in names}
            loss = model.loss(leaves, mb)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return loss.detach(), dict(zip(names, grads))

    def train_step(params, opt_state, batch):
        G = microbatches
        if G > 1:
            def split(x, i):
                return x.reshape((G, x.shape[0] // G) + x.shape[1:])[i]

            gsum = {k: torch.zeros(p.shape, dtype=gdt, device=p.device) for k, p in params.items()}
            lsum = None
            for i in range(G):
                loss, grads = value_and_grad(params, {k: split(x, i) for k, x in batch.items()})
                for k, g in grads.items():
                    gsum[k].add_(g.to(gdt))
                del grads
                lsum = loss if lsum is None else lsum + loss
            grads = {k: (g.float() / G).to(gdt) for k, g in gsum.items()}
            del gsum
            loss = lsum / G
        else:
            loss, grads = value_and_grad(params, batch)
            grads = {k: g.to(gdt) for k, g in grads.items()}

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "step": new_opt["step"],
        }
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return {"loss": model.loss(params, batch)}
    return eval_step
