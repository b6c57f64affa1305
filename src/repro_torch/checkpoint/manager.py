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
  checkpoint restores onto any device (``restore_sharded``) and into a run
  with another global batch.

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
hand back the very tensors the next step writes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dedup import sha256_bytes
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st

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


def _host_copy(x) -> torch.Tensor:
    return x.detach().to("cpu", copy=True)


def _load_tensors(data: bytes) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file's bytes, as CPU tensors that own
    their memory; ``BF16`` payloads become ``torch.bfloat16`` with the same
    bits."""
    infos, _, start = st.read_header_blob(data)
    out = {}
    for ti in infos:
        dt = ti.np_view_dtype
        lo, hi = ti.data_offsets
        arr = np.frombuffer(data, dtype=dt, count=(hi - lo) // dt.itemsize,
                            offset=start + lo).reshape(ti.shape)
        if ti.dtype_str == "BF16":
            out[ti.name] = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            out[ti.name] = torch.from_numpy(arr.copy())
    return out


def _opt_from_flat(flat: Dict[str, torch.Tensor], template, path: Tuple[str, ...] = ()):
    """The optimizer state shaped as ``template`` (a tree of tensors or of
    ParamSpecs), each leaf read from ``flat`` in the leaf's dtype."""
    if isinstance(template, dict):
        return {k: _opt_from_flat(flat, v, path + (str(k),)) for k, v in template.items()}
    dt = template.dtype
    return flat[_opt_key(path)].to(dt if isinstance(dt, torch.dtype) else getattr(torch, dt))


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
        flat = self._flatten(params, opt_state)
        tensors, tags = {}, {}
        for k, v in flat.items():
            arr, tag = _to_numpy(v)
            tensors[k] = arr
            if tag:
                tags[k] = tag
        path = self.ckpt_path(step)
        st.save_file(tensors, path, metadata={"step": str(step), "run_id": self.run_id},
                     dtype_tags=tags)
        del tensors, flat
        with open(path, "rb") as f:
            digest = sha256_bytes(f.read())
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
        return path

    def save_async(self, step: int, params: Dict, opt_state: Optional[Dict] = None):
        """Write-behind save. Blocks only if the previous save is still running."""
        self.wait()
        # snapshot to host, as copies, BEFORE returning control: the next
        # optimizer step writes the parameters and moments in place
        host_params = {k: _host_copy(v) for k, v in params.items()}
        host_opt = _tree_map(_host_copy, opt_state) if opt_state is not None else None

        def work():
            try:
                self.save(step, host_params, host_opt)
            except BaseException as e:  # surfaced on next wait()
                self._async_err = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
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
        ``state_templates``' ParamSpecs): its structure and dtypes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        fname = f"checkpoint-{step:08d}.safetensors"
        path = self.ckpt_path(step)
        if not os.path.exists(path):
            if self.store is None:
                raise FileNotFoundError(f"{path} is gone and the manager has no store")
            data = self.store.retrieve_file(self.run_id, fname, verify=verify)
        else:
            with open(path, "rb") as f:
                data = f.read()
        params, opt = self._unflatten(_load_tensors(data), opt_template)
        return step, params, opt

    def restore_sharded(self, device, step: Optional[int] = None, opt_template=None):
        """Elastic restore: :meth:`restore`, then every tensor moved to
        ``device`` (the reference's ``device_put`` with a mesh's shardings;
        the port has one device)."""
        step, params, opt = self.restore(step, opt_template)
        if params is None:
            return None, None, None
        params = {k: v.to(device) for k, v in params.items()}
        if opt is not None:
            opt = _tree_map(lambda x: x.to(device), opt)
        return step, params, opt
