# Port of src/repro/checkpoint/manager.py: rewritten in PyTorch, names kept.
"""Checkpoint manager: atomic safetensors checkpoints stored THROUGH the zLLM
pipeline — the paper's storage layer as a first-class training-framework
feature.

Every checkpoint of a run is a same-family variant of the run's first
checkpoint (exactly the structure the paper exploits for fine-tuned models),
so the manager:

* serializes the params (+ optionally optimizer state) to one safetensors
  file (tmp + fsync + rename = atomic commit; a manifest records step +
  content hash),
* ingests it into the port's ``ZLLMStore`` — FileDedup across identical
  saves, TensorDedup across steps (frozen tensors are zero-payload), BitX
  against the run's base checkpoint, the planes split and merged by the CUDA
  kernels of the store's backend,
* optionally drops the plain file afterwards (``keep_plain=False``) so the
  run directory holds only the compressed containers,
* restores ELASTICALLY: tensors are stored unsharded and whole, so a
  checkpoint restores onto any device or any device mesh
  (``restore_sharded``, tensor by tensor from the memory-mapped file) and
  into a run with another global batch.

On a mesh (DTensor state) the tensors are gathered whole one at a time
(``full_tensor``, a collective, so every rank calls ``save`` and joins each
gather in the file's order): rank 0 writes each into the file before the next
is gathered, the other ranks drop theirs, and rank 0 alone writes the
manifest and the store's containers while every rank waits for it. The files
are byte-identical to a one-device run's.

The files are byte-identical to the reference manager's for the same
parameters and optimizer state: ``params/<name>`` in the order of the params
dict, then ``opt/<path>`` for every leaf of the optimizer state in
``jax.tree_util`` order (dict keys sorted at every level; empty dicts give no
leaf), bfloat16 as its 16-bit pattern tagged ``BF16``, the same metadata.
Restore gives CPU tensors (``torch.bfloat16`` for ``BF16`` payloads, through
an int16 view) where the reference gives numpy arrays.

``save_async`` moves serialization+ingest off the training thread (the step
only blocks on the previous save's completion — single-buffered
write-behind). It copies the state to the host before it returns: the
optimizer updates the parameters in place, and on the CPU ``.cpu()`` would
hand back the very tensors the next step writes. On a mesh only rank 0 keeps
that copy; the other ranks join its gathers and keep nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dedup import sha256_file
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.sharding.rules import whole

__all__ = ["CheckpointManager"]


def _leaves_with_path(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a tree of dicts, keys sorted at every level (the
    order of ``jax.tree_util.tree_leaves_with_path``); an empty dict has no
    leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (str(k),))
    else:
        yield path, tree


def _tree_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf, the dicts rebuilt."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_map2(fn, tree, other):
    """``fn(leaf, other's leaf)`` over two trees of the same dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _opt_key(path: Tuple[str, ...]) -> str:
    return "opt/" + "/".join(path)


def _to_numpy(x) -> Tuple[np.ndarray, Optional[str]]:
    """Host array + optional safetensors dtype-tag override (for bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16), "BF16"
        return x.cpu().numpy(), None
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "BF16"
    return arr, None


def _tag(x) -> str:
    """The safetensors dtype tag ``x`` is written under, read from its dtype
    alone (a DTensor is not gathered for it)."""
    arr, tag = _to_numpy(torch.empty(0, dtype=x.dtype) if isinstance(x, torch.Tensor) else x)
    return tag or st.DTYPE_TO_STR[arr.dtype.name]


def _payload(x) -> np.ndarray:
    """``x`` whole on the host, as the array written under :func:`_tag`."""
    return _to_numpy(whole(x))[0]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_tensor(ti: st.TensorInfo, arr: np.ndarray) -> torch.Tensor:
    """One tensor of a safetensors file (its bit-view array) as a CPU tensor
    that owns its memory; ``BF16`` becomes ``torch.bfloat16`` with the same
    bits."""
    if ti.dtype_str == "BF16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _dtype_of(leaf) -> torch.dtype:
    """A template leaf's dtype (a tensor's, or a ParamSpec's name)."""
    dt = leaf.dtype
    return dt if isinstance(dt, torch.dtype) else getattr(torch, dt)


def _opt_from_flat(flat: Dict[str, torch.Tensor], template, path: Tuple[str, ...] = ()):
    """The optimizer state shaped as ``template`` (a tree of tensors or of
    ParamSpecs), each leaf read from ``flat`` in the leaf's dtype."""
    if isinstance(template, dict):
        return {k: _opt_from_flat(flat, v, path + (str(k),)) for k, v in template.items()}
    return flat[_opt_key(path)].to(_dtype_of(template))


class CheckpointManager:
    def __init__(self, run_dir: str, *, store: Optional[ZLLMStore] = None,
                 run_id: str = "run", keep_plain: bool = True,
                 save_optimizer: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.store = store
        self.run_id = run_id
        self.keep_plain = keep_plain
        self.save_optimizer = save_optimizer
        self._async_thread: Optional[threading.Thread] = None
        self._async_err: Optional[BaseException] = None
        # first checkpoint of the run = BitX base; a RESUMED run rediscovers
        # its base from the store so post-resume checkpoints keep chaining
        self._base_key: Optional[str] = None
        if store is not None:
            self._base_key = store.base_key_of.get(run_id)

    # ------------------------------------------------------------------
    def _flatten(self, params: Dict, opt_state: Optional[Dict]) -> Dict[str, Any]:
        flat = {f"params/{k}": v for k, v in params.items()}
        if opt_state is not None and self.save_optimizer:
            for path, leaf in _leaves_with_path(opt_state):
                flat[_opt_key(path)] = leaf
        return flat

    def _unflatten(self, flat: Dict[str, torch.Tensor], opt_template=None):
        params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
        opt = None if opt_template is None else _opt_from_flat(flat, opt_template)
        return params, opt

    # ------------------------------------------------------------------
    def ckpt_path(self, step: int) -> str:
        return os.path.join(self.run_dir, f"checkpoint-{step:08d}.safetensors")

    def save(self, step: int, params: Dict, opt_state: Optional[Dict] = None) -> str:
        """Write checkpoint ``step`` (and ingest it into the store). On a mesh
        every rank calls it: each gathers the tensors, rank 0 writes, and all
        return when the write is done."""
        path = self.ckpt_path(step)
        flat = self._flatten(params, opt_state)
        if _rank() == 0:
            self._write(step, flat, path)
        else:
            for v in flat.values():
                whole(v)          # rank 0's gather of this tensor, in the file's order
        _barrier()
        return path

    def _write(self, step: int, flat: Dict[str, Any], path: str) -> None:
        """The file, gathered and written one tensor at a time, its manifest
        entry, and its ingest into the store."""
        entries = [(k, _tag(v), tuple(v.shape)) for k, v in flat.items()]
        st.save_stream(entries, (_payload(v) for v in flat.values()), path,
                       metadata={"step": str(step), "run_id": self.run_id})
        digest, _ = sha256_file(path)
        manifest = {"step": step, "file": os.path.basename(path), "sha256": digest,
                    "time": time.time()}
        mpath = os.path.join(self.run_dir, "manifest.json")
        entries = []
        if os.path.exists(mpath):
            with open(mpath) as f:
                entries = json.load(f)
        entries = [e for e in entries if e["step"] != step] + [manifest]
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sorted(entries, key=lambda e: e["step"]), f, indent=1)
        os.replace(tmp, mpath)

        if self.store is not None:
            fname = f"checkpoint-{step:08d}.safetensors"
            self.store.ingest_file(path, self.run_id, fname,
                                   declared_base=self._base_key)
            if self._base_key is None:
                self._base_key = f"{self.run_id}/{fname}"
            if not self.keep_plain:
                os.remove(path)

    def save_async(self, step: int, params: Dict, opt_state: Optional[Dict] = None):
        """Write-behind save. Blocks only if the previous save is still running.
        On a mesh every rank calls it; rank 0's thread writes."""
        self.wait()
        # snapshot to host, as copies, BEFORE returning control: the next
        # optimizer step writes the parameters and moments in place. Each
        # tensor is gathered whole in turn; only rank 0 keeps it.
        rank0 = _rank() == 0

        def host_copy(x):
            x = whole(x.detach())
            return x.to("cpu", copy=True) if rank0 else None

        host_params = {k: host_copy(v) for k, v in params.items()}
        host_opt = _tree_map(host_copy, opt_state) if opt_state is not None else None
        if not rank0:
            return

        def work():
            try:
                self._write(step, self._flatten(host_params, host_opt), self.ckpt_path(step))
            except BaseException as e:  # surfaced on next wait()
                self._async_err = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self):
        """Until the last write-behind save is done (on a mesh, on rank 0:
        every rank waits for it)."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        _barrier()
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise err

    # ------------------------------------------------------------------
    def steps(self):
        mpath = os.path.join(self.run_dir, "manifest.json")
        if not os.path.exists(mpath):
            return []
        with open(mpath) as f:
            return [e["step"] for e in json.load(f)]

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return max(s) if s else None

    def restore(self, step: Optional[int] = None, opt_template=None,
                verify: bool = True):
        """Returns (step, params dict of CPU tensors, opt_state or None).
        Reads the plain file when kept, else reconstructs it from the zLLM
        store. ``opt_template`` is the optimizer state's tree (tensors or
        ``state_templates``' ParamSpecs): its structure and dtypes. In a
        process group of more than one rank every rank calls it."""
        return self._restore(step, opt_template, torch.device("cpu"), {}, verify)

    @contextlib.contextmanager
    def _mapped(self, step: int, verify: bool = True) -> Iterator[st.SafetensorsFile]:
        """Checkpoint ``step`` memory-mapped: the plain file, or, when only the
        store holds it, a copy that rank 0 rebuilds from the store beside it
        for every rank to map (unlinked once all have). In a process group
        every rank enters it."""
        path = self.ckpt_path(step)
        rebuilt = None
        if not os.path.exists(path):
            if self.store is None:
                raise FileNotFoundError(f"{path} is gone and the manager has no store")
            rebuilt = path + ".restore"
            if _rank() == 0:
                data = self.store.retrieve_file(self.run_id, os.path.basename(path),
                                                verify=verify)
                with open(rebuilt + ".tmp", "wb") as f:
                    f.write(data)
                del data
                os.replace(rebuilt + ".tmp", rebuilt)
            _barrier()
            path = rebuilt
        with st.SafetensorsFile(path) as f:
            if rebuilt is not None:
                _barrier()          # every rank has mapped it
                if _rank() == 0:
                    os.remove(rebuilt)
            yield f

    def _restore(self, step: Optional[int], opt_template, dev: torch.device,
                 placed_by: Dict[str, Any], verify: bool = True):
        """(step, params, opt_state) of checkpoint ``step`` (default: the
        latest), each tensor read from the mapped file on its own, in its
        template's dtype, moved to ``dev`` and distributed by its entry of
        ``placed_by`` (flat key -> NamedSharding) where it has one: no rank
        holds the checkpoint whole in its memory."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        dtypes = ({} if opt_template is None else
                  {_opt_key(p): _dtype_of(t) for p, t in _leaves_with_path(opt_template)})
        flat = {}
        with self._mapped(step, verify) as f:
            for ti in f.infos:
                if ti.name.startswith("opt/") and opt_template is None:
                    continue
                x = _host_tensor(ti, f.tensor(ti.name))
                if ti.name in dtypes:
                    x = x.to(dtypes[ti.name])
                x = x.to(dev)
                flat[ti.name] = placed_by[ti.name].distribute(x) if ti.name in placed_by else x
        params, opt = self._unflatten(flat, opt_template)
        return step, params, opt

    def restore_sharded(self, target, step: Optional[int] = None, opt_template=None, *,
                        shardings=None, opt_shardings=None):
        """Elastic restore: :meth:`restore`'s tensors placed on ``target``.
        ``target`` is a device, or a device mesh with ``shardings`` (a
        NamedSharding per parameter, ``param_shardings``) and
        ``opt_shardings`` (the tree of ``spec_tree_shardings``): each tensor
        becomes a DTensor laid out by them, on a mesh of any shape (the
        reference's ``device_put``). The optimizer's step counter stays a
        plain tensor on the mesh's device. On a mesh every rank calls it."""
        if shardings is None:
            return self._restore(step, opt_template, torch.device(target), {})
        dev = torch.device(target.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        placed_by = {f"params/{k}": sh for k, sh in shardings.items()}
        if opt_shardings is not None:
            placed_by.update({_opt_key(p): sh for p, sh in _leaves_with_path(opt_shardings)
                              if p != ("step",)})
        return self._restore(step, opt_template, dev, placed_by)
