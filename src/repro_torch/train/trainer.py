# Port of src/repro/train/trainer.py: rewritten in PyTorch, names kept.
"""Training loop: train step + data prefetch + fault-tolerant checkpointing
through the zLLM store, on one device (the card unless ``device`` says
otherwise).

Fault-tolerance contract (exercised by tests and examples):

* checkpoints commit atomically (tmp+fsync+rename, manifest with hash),
* ``resume=True`` restarts from the latest manifest entry — a killed run
  (``FailureInjector``) loses at most ``ckpt_every`` steps, and the resumed
  steps see the batches the killed run would have seen,
* restore is elastic: a checkpoint restores into a run with another global
  batch, the tensors moved to this run's device,
* checkpoint writes are async (write-behind) and go through zLLM, so a run's
  storage footprint is FileDedup+TensorDedup+BitX-compressed against its
  first checkpoint.

What changes from the reference: no mesh and no jit. ``mesh_shape`` is
accepted only when it names one device (a mesh of more waits for the launch
slice); the model runs ``attn="plain"``, as the reference's loss does (the
flash kernel is forward-only); parameters are drawn from a
``torch.Generator`` seeded with ``seed`` on ``device``; each host batch is
copied to the device before its step.
"""

from __future__ import annotations

import math
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
from repro_torch.models.api import get_model, init_params
from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer
from repro_torch.train.step import make_train_step

__all__ = ["TrainConfig", "Trainer", "SimulatedFailure", "FailureInjector", "train_device"]


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector to emulate a node crash mid-run."""


@dataclass
class FailureInjector:
    fail_at_step: Optional[int] = None

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class TrainConfig:
    arch: ArchConfig
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    steps: int = 20
    ckpt_every: int = 10
    run_dir: str = field(default_factory=lambda: tempfile.mkdtemp(prefix="repro-run-"))
    resume: bool = True
    grad_dtype: str = "float32"
    remat_policy: str = "nothing"
    optimizer: Optional[OptimizerConfig] = None
    mesh_shape: Optional[tuple] = None     # (data, model); only one device here
    seed: int = 0
    async_checkpoint: bool = True
    keep_plain_ckpt: bool = True
    device: str = "cuda"


def train_device(device) -> torch.device:
    """``device`` as a torch device the trainer runs on: ``cuda`` only when a
    card is visible (never a silent fall-back to the CPU), or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("training on device 'cuda' needs a CUDA device and none is "
                               "visible; pass device='cpu' to train on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"the trainer runs on 'cuda' or 'cpu', not {dev}")
    return dev


class Trainer:
    def __init__(self, cfg: TrainConfig, store=None, run_id: str = "run",
                 failure: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.failure = failure or FailureInjector()
        if cfg.mesh_shape is not None and math.prod(cfg.mesh_shape) != 1:
            raise ValueError(f"mesh_shape {cfg.mesh_shape} spans {math.prod(cfg.mesh_shape)} "
                             "devices; the port trains on one, and the device mesh waits for "
                             "the launch slice (ROADMAP §1)")
        self.device = train_device(cfg.device)
        self.model = get_model(cfg.arch, attn="plain", remat_policy=cfg.remat_policy)
        ocfg = cfg.optimizer or OptimizerConfig(name=cfg.arch.optimizer,
                                                total_steps=cfg.steps)
        self.optimizer = make_optimizer(ocfg)
        self.ckpt = CheckpointManager(cfg.run_dir, store=store, run_id=run_id,
                                      keep_plain=cfg.keep_plain_ckpt)
        self._step = make_train_step(self.model, self.optimizer,
                                     microbatches=cfg.microbatches,
                                     grad_dtype=cfg.grad_dtype)
        self.data = SyntheticTokens(DataConfig(
            vocab=cfg.arch.vocab, seq_len=cfg.seq_len, global_batch=cfg.global_batch,
            seed=cfg.seed))
        self.history: List[Dict[str, float]] = []
        self.start_step = 0
        self._init_state()

    # ------------------------------------------------------------------
    def _init_state(self):
        cfg = self.cfg
        restored = None
        if cfg.resume:
            opt_tmpl = self.optimizer.state_templates(self.model.param_templates())
            step, params, opt = self.ckpt.restore_sharded(self.device, opt_template=opt_tmpl)
            if step is not None:
                self.params, self.opt_state, self.start_step = params, opt, step
                restored = step
        if restored is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            self.params = init_params(cfg.arch, gen)
            self.opt_state = self.optimizer.init(self.params)
        self.resumed_from = restored

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays) on the trainer's device."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        cfg = self.cfg
        end = steps if steps is not None else cfg.steps
        self.data.step = self.start_step
        it = PrefetchIterator(iter(self.data), prefetch=2)
        try:
            for step in range(self.start_step, end):
                batch = self.to_device(next(it))
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self._step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                rec = {"step": step + 1, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "sec": time.perf_counter() - t0}
                self.history.append(rec)
                if (step + 1) % cfg.ckpt_every == 0 or step + 1 == end:
                    if cfg.async_checkpoint:
                        self.ckpt.save_async(step + 1, self.params, self.opt_state)
                    else:
                        self.ckpt.save(step + 1, self.params, self.opt_state)
                self.failure.check(step + 1)
        finally:
            it.close()
            self.ckpt.wait()
        return self.history
