# Port of src/repro/serve/engine.py: rewritten in PyTorch, names kept.
"""Serving engine: batched prefill + decode over the model API, with
cold-start loading straight from the compressed zLLM store (paper §4.4.4).

``generate`` prefills the prompts, pads the KV cache once by the number of
new tokens and then decodes greedily, each step writing its K/V into that
cache in place (the reference jits the step and donates the cache; eager
PyTorch needs neither). ``RequestBatcher`` groups pending requests into
fixed-size, left-padded batches — static batching; the per-request
bookkeeping lives host-side.

``ServeEngine.from_store`` is the paper's model-serving cold start: retrieve
the checkpoint from the port's zLLM store (the BitX decode runs on the store's
backend, the card by default), verify its content hash, parse the safetensors
bytes in memory and move the parameters to the device. The engine runs on the
card unless it is given ``device="cpu"``.

With a device mesh (``mesh`` and ``rules``; any family) the parameters are
laid out by ``param_shardings``, each prompt batch (Whisper's frames too) by
the batch axes, the growing cache by ``cache_shardings`` (sequence-sharded,
so decode runs flash-decoding over the model axis; the SSMs' O(1) states keep
the layout the model gives them from step to step); the logits are gathered
whole before each greedy pick, so every rank picks the same tokens.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import distribute, get_model, param_shardings
from repro_torch.sharding.rules import named_sharding

__all__ = ["ServeEngine", "RequestBatcher", "GenerateResult"]


@dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, prompt+new)
    prompt_len: int
    n_new: int


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda') needs a CUDA device and none is "
                               "visible; pass device='cpu' to serve on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"ServeEngine runs on 'cuda' or 'cpu', not {dev}")
    return dev


def _tensor_from_bytes(data: bytes, start: int, end: int, dtype_str: str, np_dtype,
                       shape) -> torch.Tensor:
    """One safetensors payload as a host tensor that owns its memory; a BF16
    payload keeps its bits and becomes ``torch.bfloat16``."""
    arr = np.frombuffer(data, dtype=np_dtype, count=(end - start) // np.dtype(np_dtype).itemsize,
                        offset=start).reshape(shape)
    if dtype_str == "BF16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: Dict[str, torch.Tensor], device="cuda",
                 attn: str = "flash", *, mesh=None, rules=None):
        self.cfg = cfg
        self.device = _device(device)
        self.mesh, self.rules = mesh, rules
        self.model = get_model(cfg, attn=attn, mesh=mesh, rules=rules)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        if mesh is not None:
            self.params = distribute(self.params, param_shardings(cfg, mesh, rules))
        # the cache entries that grow during decode (the model names them) and
        # their sequence axis (tagged "sp" in the template). Whisper's cross
        # K/V carry "sp" too but stay the encoder's length, where the
        # reference's engine pads them
        tmpl = self.model.cache_templates(1, 8)
        self._grow_axes = {k: tmpl[k].axes.index("sp") for k in self.model.GROWING_CACHE}
        self._cache_axes = {k: tmpl[k].axes for k in self.model.GROWING_CACHE}

    # ------------------------------------------------------------------
    @classmethod
    def from_store(cls, store, repo_id: str, filename: str, cfg: ArchConfig, device="cuda",
                   param_prefix: str = "params/", *, mesh=None, rules=None) -> "ServeEngine":
        """Cold start from the compressed store: BitX-decode, verify, load.

        ``store.retrieve_file(..., verify=True)`` reconstructs the file
        bit-exactly (its BitX and ZipNN merges run on the store's backend) and
        checks its sha256 against the ingest-time hash. The bytes are parsed in
        memory with the port's safetensors header reader, with no spool file;
        BF16-tagged tensors become ``torch.bfloat16`` with the same bits. With
        ``mesh`` and ``rules`` each rank reads the file and keeps its own
        pieces of every tensor (``param_shardings``).
        """
        from repro_torch.formats import safetensors as st

        dev = _device(device)
        data = store.retrieve_file(repo_id, filename, verify=True)
        infos, _, data_start = st.read_header_blob(data)
        params = {}
        for ti in infos:
            if not ti.name.startswith(param_prefix):
                continue
            t = _tensor_from_bytes(data, data_start + ti.data_offsets[0],
                                   data_start + ti.data_offsets[1], ti.dtype_str,
                                   ti.np_view_dtype, ti.shape)
            params[ti.name[len(param_prefix):]] = t.to(dev)
        del data
        return cls(cfg, params, dev, mesh=mesh, rules=rules)

    # ------------------------------------------------------------------
    def _pad_cache(self, cache: Dict, extra: int) -> Dict:
        """Extend the growing cache arrays by ``extra`` positions (zeros),
        once, so the decode steps can write into them in place: the
        transformer's ``k``/``v``, zamba2's ``attn_k``/``attn_v``, whisper's
        ``self_k``/``self_v``; falcon-mamba's O(1) states not at all."""
        out = dict(cache)
        for k, ax in self._grow_axes.items():
            arr = cache[k]
            if self.mesh is not None:
                arr = arr.full_tensor()
            shape = list(arr.shape)
            shape[ax] += extra
            grown = torch.zeros(shape, dtype=arr.dtype, device=arr.device)
            grown.narrow(ax, 0, arr.shape[ax]).copy_(arr)
            out[k] = grown
        if self.mesh is not None:
            out.update({k: named_sharding(self.mesh, self._cache_axes[k], self.rules,
                                          out[k].shape).distribute(out[k])
                        for k in self._grow_axes})
        return out

    def _place(self, x: torch.Tensor) -> torch.Tensor:
        """An input batch tensor on the device; on a mesh split on its batch dim."""
        x = x.to(self.device)
        if self.mesh is None:
            return x
        return named_sharding(self.mesh, ("batch",) + (None,) * (x.dim() - 1), self.rules,
                              x.shape).distribute(x)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy tokens (B,) of a step's logits, gathered whole on a mesh."""
        if self.mesh is not None:
            logits = logits.full_tensor()
        return logits.argmax(dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int,
                 extra_inputs: Optional[Dict] = None) -> GenerateResult:
        """Greedy generation. prompts: (B, S) int32. ``extra_inputs`` (such as
        whisper's ``frames``) go into the prefill batch: a tensor as it is (a
        bf16 one too), anything else through numpy, moved to the device."""
        B, S = prompts.shape
        batch = {"tokens": self._place(torch.as_tensor(np.asarray(prompts, np.int32)))}
        if extra_inputs:
            batch.update({k: self._place(v if isinstance(v, torch.Tensor)
                                         else torch.as_tensor(np.asarray(v)))
                          for k, v in extra_inputs.items()})
        logits, cache = self.model.prefill(self.params, batch)
        cache = self._pad_cache(cache, n_new)
        toks = [self._pick(logits)]
        for _ in range(n_new - 1):
            logits, cache = self.model.decode_step(
                self.params, {"tokens": self._place(toks[-1][:, None])}, cache)
            toks.append(self._pick(logits))
        new = torch.stack(toks, dim=1).cpu().numpy()
        return GenerateResult(np.concatenate([prompts, new], axis=1), S, n_new)


class RequestBatcher:
    """Static batcher: groups queued prompts into fixed-size generation calls."""

    def __init__(self, engine: ServeEngine, batch_size: int, n_new: int, pad_id: int = 0):
        self.engine = engine
        self.batch_size = batch_size
        self.n_new = n_new
        self.pad_id = pad_id
        self._q: "queue.Queue[Tuple[int, np.ndarray]]" = queue.Queue()
        self._results: Dict[int, np.ndarray] = {}
        self._next_id = 0

    def submit(self, prompt: Sequence[int]) -> int:
        rid = self._next_id
        self._next_id += 1
        self._q.put((rid, np.asarray(prompt, np.int32)))
        return rid

    def run_once(self) -> List[int]:
        """Serve one batch; returns completed request ids."""
        batch: List[Tuple[int, np.ndarray]] = []
        while len(batch) < self.batch_size and not self._q.empty():
            batch.append(self._q.get())
        if not batch:
            return []
        maxlen = max(len(p) for _, p in batch)
        rows = np.full((self.batch_size, maxlen), self.pad_id, np.int32)
        for i, (_, p) in enumerate(batch):
            rows[i, maxlen - len(p):] = p      # left-pad
        res = self.engine.generate(rows, self.n_new)
        done = []
        for i, (rid, _) in enumerate(batch):
            self._results[rid] = res.tokens[i, maxlen:]
            done.append(rid)
        return done

    def result(self, rid: int) -> Optional[np.ndarray]:
        return self._results.get(rid)
