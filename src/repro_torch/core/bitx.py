# Port copy of src/repro/core/bitx.py: containers and NumpyBackend unchanged; the
# JaxBackend section is replaced by TorchBackend and get_backend("torch"|"numpy").
"""BitX lossless delta compression (paper §4.3).

Encode: align the floats of a fine-tuned tensor with its base tensor in
serialization order, bitcast both to unsigned words, XOR, split the delta into
byte planes (MSB plane ≈ all zeros within a family, Fig. 5), entropy-code each
plane with zstd. Decode is the exact inverse; the pipeline verifies bit-exact
reconstruction.

Array math goes through an :class:`ArrayBackend` selected once per store
(``get_backend("torch"|"numpy")``), two implementations tested
bit-identical:

* ``numpy`` — host path for mmap'd safetensors ingestion (the reference
  semantics, mirroring the paper's C++ engine);
* ``torch`` — the hand-written CUDA kernels (``repro_torch.kernels``), the
  H100 deployment path: same-width tensors are concatenated per bucket and
  transformed in ONE kernel launch (``device="cpu"`` runs the same bucketing
  over the kernels' plain PyTorch versions, which is how the tests validate
  it without a card).

The per-codec encode/decode lanes live in the :mod:`repro_torch.core.codecs`
registry; :class:`BitXCodec` remains as a thin back-compat facade over it.

Container format (``.bitx``): a 16-byte magic+version, a JSON header
describing per-tensor records, then concatenated zstd frames. Per-tensor
records keep the base tensor's content hash so retrieval can fetch the base
from the CAS pool (§4.4.4).
"""

from __future__ import annotations

import io
import json
import mmap
import os
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import zstd_compat as zstd
from repro_torch.core.codecs import CodecRuntime, EncodeInput, get_codec, raw_or_stored
from repro_torch.kernels.bitx_xor import merge_xor, xor_split
from repro_torch.kernels.byte_planes import merge, split

__all__ = [
    "ArrayBackend",
    "BitXCodec",
    "TensorRecord",
    "BitXWriter",
    "BitXReader",
    "NumpyBackend",
    "TMP_SUFFIX",
    "TorchBackend",
    "get_backend",
]

MAGIC = b"BITX0001"
DEFAULT_ZSTD_LEVEL = 3

# Containers are written to ``<path>.part`` and atomically renamed into
# place, so a crash mid-write can never leave a torn file at a path the
# index might reference. Leftover ``.part`` files are crash debris; the
# store's fsck orphan scan recognizes the suffix and deletes them under
# repair (they are never referenced by the version graph).
TMP_SUFFIX = ".part"


def _bit_view_np(arr: np.ndarray) -> np.ndarray:
    """View a numpy array as unsigned words of the same width (no copy)."""
    if arr.dtype.kind == "u":
        return arr
    if arr.dtype.kind in ("f", "i"):
        return arr.view(f"<u{arr.dtype.itemsize}")
    raise ValueError(f"unsupported dtype {arr.dtype}")


# ---------------------------------------------------------------------------
# Host (numpy) transform implementations — the reference semantics every
# ArrayBackend must match bit for bit.
# ---------------------------------------------------------------------------

def _xor_delta_planes_host(base: np.ndarray, ft: np.ndarray) -> List[np.ndarray]:
    """XOR bit views and split into byte planes (MSB first). The plane split
    is a strided view of the little-endian byte buffer, so the whole encode
    is two passes over memory (XOR, then per-plane copy)."""
    a = _bit_view_np(np.ascontiguousarray(base)).reshape(-1)
    b = _bit_view_np(np.ascontiguousarray(ft)).reshape(-1)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    delta = np.bitwise_xor(a, b)
    nb = delta.dtype.itemsize
    raw = delta.view(np.uint8).reshape(-1, nb)
    # little-endian: byte column nb-1 is the MSB
    return [np.ascontiguousarray(raw[:, nb - 1 - i]) for i in range(nb)]


def _byte_planes_host(x: np.ndarray) -> List[np.ndarray]:
    """MSB-first byte planes of ``x``'s bit view (the ZipNN split)."""
    v = _bit_view_np(np.ascontiguousarray(x)).reshape(-1)
    nb = v.dtype.itemsize
    raw = v.view(np.uint8).reshape(-1, nb)
    return [np.ascontiguousarray(raw[:, nb - 1 - i]) for i in range(nb)]


def _merge_planes_xor_host(planes: Sequence[np.ndarray], base: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_xor_delta_planes_host`; returns the ft bit view
    shaped like ``base``."""
    a = _bit_view_np(np.ascontiguousarray(base))
    nb = a.dtype.itemsize
    assert len(planes) == nb
    n = a.size
    raw = np.empty((n, nb), np.uint8)
    for i, p in enumerate(planes):
        raw[:, nb - 1 - i] = p
    delta = raw.reshape(-1).view(a.dtype.str)
    return np.bitwise_xor(delta, a.reshape(-1)).reshape(a.shape)


def _merge_planes_host(planes: Sequence[np.ndarray], dtype_np, shape) -> np.ndarray:
    """Inverse of :func:`_byte_planes_host`; returns an array of ``dtype_np``
    (the ZipNN merge)."""
    nb = np.dtype(dtype_np).itemsize
    assert len(planes) == nb
    n = int(np.prod(shape)) if len(shape) else 1
    raw = np.empty((n, nb), np.uint8)
    for i, p in enumerate(planes):
        raw[:, nb - 1 - i] = p
    return raw.reshape(-1).view(np.dtype(dtype_np).str).reshape(shape)


# ---------------------------------------------------------------------------
# ArrayBackend: the one dispatch point for the pipeline's array math.
# ---------------------------------------------------------------------------

class ArrayBackend(Protocol):
    """Array-transform provider selected once at ``ZLLMStore`` construction.

    Single-tensor ops are the reference semantics; the ``*_batch`` variants
    take many tensors at once and MUST produce per-tensor results identical
    to mapping the single op — backends exploit that freedom to concatenate
    same-width tensors and run one fused kernel launch per bucket. The
    transforms are elementwise in the bit view, so batching can never change
    the emitted bytes.
    """

    name: str
    supports_batching: bool

    def xor_delta_planes(self, base: np.ndarray, ft: np.ndarray) -> List[np.ndarray]: ...
    def byte_planes(self, x: np.ndarray) -> List[np.ndarray]: ...
    def merge_planes_xor(self, planes: Sequence[np.ndarray], base: np.ndarray) -> np.ndarray: ...
    def merge_planes(self, planes: Sequence[np.ndarray], dtype_np, shape) -> np.ndarray: ...
    def xor_delta_planes_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> List[List[np.ndarray]]: ...
    def byte_planes_batch(self, xs: Sequence[np.ndarray]) -> List[List[np.ndarray]]: ...
    def merge_planes_xor_batch(self, items: Sequence[Tuple[Sequence[np.ndarray], np.ndarray]]) -> List[np.ndarray]: ...
    def merge_planes_batch(self, items: Sequence[Tuple[Sequence[np.ndarray], np.dtype, Tuple[int, ...]]]) -> List[np.ndarray]: ...


class NumpyBackend:
    """Host path: strided-view plane splits on the ingest thread(s). Batched
    entry points degenerate to a loop — numpy gains nothing from fusion, and
    the pipeline only engages its batching stage for backends that declare
    ``supports_batching``."""

    name = "numpy"
    supports_batching = False

    def xor_delta_planes(self, base, ft):
        return _xor_delta_planes_host(base, ft)

    def byte_planes(self, x):
        return _byte_planes_host(x)

    def merge_planes_xor(self, planes, base):
        return _merge_planes_xor_host(planes, base)

    def merge_planes(self, planes, dtype_np, shape):
        return _merge_planes_host(planes, dtype_np, shape)

    def xor_delta_planes_batch(self, pairs):
        return [_xor_delta_planes_host(b, f) for b, f in pairs]

    def byte_planes_batch(self, xs):
        return [_byte_planes_host(x) for x in xs]

    def merge_planes_xor_batch(self, items):
        return [_merge_planes_xor_host(p, b) for p, b in items]

    def merge_planes_batch(self, items):
        return [_merge_planes_host(p, d, s) for p, d, s in items]


def _width_buckets(itemsizes: Sequence[int]) -> Dict[int, List[int]]:
    """Indices grouped by word width: the kernels are dtype-agnostic byte
    shuffles, so every tensor of one width shares a launch."""
    groups: Dict[int, List[int]] = {}
    for i, nb in enumerate(itemsizes):
        groups.setdefault(int(nb), []).append(i)
    return groups


class TorchBackend:
    """Device path over the hand-written CUDA kernels (:mod:`repro_torch.kernels`).

    Inputs are converted to their unsigned bit views host-side (int kinds
    too), then each batch is bucketed by word width. Per bucket the host
    concatenates the bucket's bytes into one staging buffer, makes ONE
    host-to-device copy (as uint8), ONE kernel launch writing a single
    ``(nb, n)`` plane buffer (or the merged words) and ONE device-to-host copy,
    and slices the result back per tensor by numel — bit-identical to the
    per-tensor host path because the transforms are elementwise. 8-byte words
    go through the kernels as well (torch has no x64 switch to respect).

    ``device`` is explicit: ``"cuda"`` (the default) raises when no card is
    visible, and ``"cpu"`` runs the same bucketing over the plain PyTorch
    versions of the kernels. The counters (per-kernel calls, host<->device
    bytes and, on the card, CUDA-event times of kernels and copies) sit behind
    a lock, because the store's worker threads call the single ops
    concurrently on the per-record decode path.
    """

    name = "torch"
    supports_batching = True

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend(device='cuda') needs a CUDA device and none is "
                    "visible; pass device='cpu' to run the plain PyTorch versions")
        elif self.device.type != "cpu":
            raise ValueError(f"TorchBackend runs on 'cuda' or 'cpu', not {self.device}")
        self._lock = threading.Lock()
        self._counts = self._zero_counts()

    # the kernels the four plane ops run (the bit-distance kernels are not theirs)
    KERNELS = ("xor_split", "merge_xor", "split", "merge")

    @classmethod
    def _zero_counts(cls) -> Dict:
        return {"kernel_calls": {k: 0 for k in cls.KERNELS},
                "h2d_bytes": 0, "d2h_bytes": 0, "kernel_ms": 0.0, "copy_ms": 0.0}

    def counters(self) -> Dict:
        """Snapshot: ``kernel_calls`` per kernel (one per non-empty bucket;
        launches on the card, plain versions on the CPU), ``h2d_bytes`` /
        ``d2h_bytes`` moved to and from the card, and the summed CUDA-event
        times ``kernel_ms`` / ``copy_ms`` (0 on the CPU)."""
        with self._lock:
            c = dict(self._counts)
            c["kernel_calls"] = dict(c["kernel_calls"])
        c["device"] = str(self.device)
        return c

    def reset_counters(self) -> None:
        with self._lock:
            self._counts = self._zero_counts()

    def _run(self, kernel: str, staged: np.ndarray, fn, out_shape) -> np.ndarray:
        """One bucket: copy the staged bytes to the device, call ``fn`` (one
        kernel wrapper call) on them, copy its uint8 result back."""
        if staged.size == 0:  # an empty bucket launches nothing
            return np.empty(out_shape, np.uint8)
        if self.device.type == "cpu":
            out = fn(torch.from_numpy(staged)).numpy()
            with self._lock:
                self._counts["kernel_calls"][kernel] += 1
            return out
        with torch.cuda.device(self.device):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            dev = torch.from_numpy(staged).to(self.device)
            ev[1].record()
            out_d = fn(dev)
            ev[2].record()
            out = out_d.cpu().numpy()
            ev[3].record()
            ev[3].synchronize()
        with self._lock:
            c = self._counts
            c["kernel_calls"][kernel] += 1
            c["h2d_bytes"] += staged.nbytes
            c["d2h_bytes"] += out.nbytes
            c["copy_ms"] += ev[0].elapsed_time(ev[1]) + ev[2].elapsed_time(ev[3])
            c["kernel_ms"] += ev[1].elapsed_time(ev[2])
        return out

    # -- single-tensor ops (reference semantics) -----------------------------
    def xor_delta_planes(self, base, ft):
        return self.xor_delta_planes_batch([(base, ft)])[0]

    def byte_planes(self, x):
        return self.byte_planes_batch([x])[0]

    def merge_planes_xor(self, planes, base):
        return self.merge_planes_xor_batch([(planes, base)])[0]

    def merge_planes(self, planes, dtype_np, shape):
        return self.merge_planes_batch([(planes, dtype_np, shape)])[0]

    # -- batched ops: one copy in, one launch, one copy out per width bucket --
    def xor_delta_planes_batch(self, pairs):
        out: List[Optional[List[np.ndarray]]] = [None] * len(pairs)
        views = []
        for base, ft in pairs:
            a = _bit_view_np(np.ascontiguousarray(base)).reshape(-1)
            b = _bit_view_np(np.ascontiguousarray(ft)).reshape(-1)
            assert a.shape == b.shape and a.dtype == b.dtype, \
                (a.shape, b.shape, a.dtype, b.dtype)
            views.append((a, b))
        for nb, idxs in _width_buckets([a.itemsize for a, _ in views]).items():
            total = sum(views[i][0].size for i in idxs)
            half = total * nb
            staged = np.empty(2 * half, np.uint8)  # [base words | ft words]
            off = 0
            for i in idxs:
                a, b = views[i]
                staged[off:off + a.nbytes] = a.view(np.uint8)
                staged[half + off:half + off + a.nbytes] = b.view(np.uint8)
                off += a.nbytes
            planes = self._run("xor_split", staged,
                               lambda d: xor_split(d[:half], d[half:], nb), (nb, 0))
            off = 0
            for i in idxs:
                n = views[i][0].size
                out[i] = [planes[k, off:off + n] for k in range(nb)]
                off += n
        return out

    def byte_planes_batch(self, xs):
        out: List[Optional[List[np.ndarray]]] = [None] * len(xs)
        views = [_bit_view_np(np.ascontiguousarray(x)).reshape(-1) for x in xs]
        for nb, idxs in _width_buckets([v.itemsize for v in views]).items():
            staged = np.concatenate([views[i].view(np.uint8) for i in idxs])
            planes = self._run("split", staged, lambda d: split(d, nb), (nb, 0))
            off = 0
            for i in idxs:
                n = views[i].size
                out[i] = [planes[k, off:off + n] for k in range(nb)]
                off += n
        return out

    def merge_planes_xor_batch(self, items):
        out: List[Optional[np.ndarray]] = [None] * len(items)
        views = [_bit_view_np(np.ascontiguousarray(base)) for _, base in items]
        for nb, idxs in _width_buckets([v.itemsize for v in views]).items():
            total = sum(views[i].size for i in idxs)
            half = total * nb
            staged = np.empty(2 * half, np.uint8)  # [(nb, total) planes | base words]
            planes = staged[:half].reshape(nb, total)
            off = 0
            for i in idxs:
                n = views[i].size
                assert len(items[i][0]) == nb
                for k, p in enumerate(items[i][0]):
                    planes[k, off:off + n] = np.asarray(p).reshape(-1)
                staged[half + off * nb:half + (off + n) * nb] = \
                    views[i].reshape(-1).view(np.uint8)
                off += n
            merged = self._run("merge_xor", staged,
                               lambda d: merge_xor(d[:half].view(nb, total), d[half:]), (0,))
            off = 0
            for i in idxs:
                n = views[i].size
                out[i] = merged[off * nb:(off + n) * nb].view(views[i].dtype).reshape(
                    views[i].shape)
                off += n
        return out

    def merge_planes_batch(self, items):
        out: List[Optional[np.ndarray]] = [None] * len(items)
        dtypes = [np.dtype(d) for _, d, _ in items]
        sizes = [int(np.prod(shape)) if len(shape) else 1 for _, _, shape in items]
        for nb, idxs in _width_buckets([d.itemsize for d in dtypes]).items():
            total = sum(sizes[i] for i in idxs)
            staged = np.empty(total * nb, np.uint8)
            planes = staged.reshape(nb, total)
            off = 0
            for i in idxs:
                assert len(items[i][0]) == nb
                for k, p in enumerate(items[i][0]):
                    planes[k, off:off + sizes[i]] = np.asarray(p).reshape(-1)
                off += sizes[i]
            merged = self._run("merge", staged, lambda d: merge(d.view(nb, total)), (0,))
            off = 0
            for i in idxs:
                out[i] = merged[off * nb:(off + sizes[i]) * nb].view(dtypes[i]).reshape(
                    items[i][2])
                off += sizes[i]
        return out


def get_backend(spec="torch") -> ArrayBackend:
    """Resolve an array backend: ``"torch"`` (a :class:`TorchBackend` on the
    card; raises without one), ``"numpy"`` (the host reference), or an
    :class:`ArrayBackend` instance (passed through). Each call makes a fresh
    backend, so each store keeps its own counters. ``"jax"`` and ``"auto"``
    belong to the reference package and raise ``ValueError`` here."""
    if not isinstance(spec, str):
        return spec
    if spec == "torch":
        return TorchBackend()
    if spec == "numpy":
        return NumpyBackend()
    raise ValueError(f"unknown array backend {spec!r} "
                     f"(expected 'torch', 'numpy' or an ArrayBackend instance)")


@dataclass
class TensorRecord:
    """Header record for one tensor inside a .bitx container."""

    name: str
    dtype_str: str            # safetensors tag of the original tensor ("BF16", "F32", ...)
    shape: Tuple[int, ...]
    codec: str                # "bitx" | "bitxq" | "zipnn" | "raw" | "stored" | "dedup"
    base_hash: Optional[str]  # CAS hash of the base tensor (bitx/bitxq) / None
    self_hash: str            # CAS hash of this tensor's raw bytes (dedup + verify)
    plane_sizes: List[int] = field(default_factory=list)  # compressed bytes per plane
    raw_size: int = 0
    # quantized-delta (bitxq) stamp — emitted only when set, so containers
    # that never use the lane stay byte-identical to pre-bitxq builds.
    # ``qscale_bits`` is the float32 scale's raw bit pattern (uint32): round-
    # tripping the scale through JSON as a decimal float could perturb the
    # last bit and break the decode-side prediction replay.
    base_dtype: Optional[str] = None   # safetensors tag of the base ("BF16", ...)
    qscale_bits: Optional[int] = None  # float32 bit pattern of the quant scale
    qzero_point: Optional[int] = None  # integer zero point of the quant grid

    def to_json(self) -> Dict:
        d = {
            "name": self.name,
            "dtype": self.dtype_str,
            "shape": list(self.shape),
            "codec": self.codec,
            "base_hash": self.base_hash,
            "self_hash": self.self_hash,
            "plane_sizes": self.plane_sizes,
            "raw_size": self.raw_size,
        }
        if self.base_dtype is not None:
            d["base_dtype"] = self.base_dtype
        if self.qscale_bits is not None:
            d["qscale_bits"] = self.qscale_bits
        if self.qzero_point is not None:
            d["qzero_point"] = self.qzero_point
        return d

    @staticmethod
    def from_json(d: Dict) -> "TensorRecord":
        qs = d.get("qscale_bits")
        qz = d.get("qzero_point")
        return TensorRecord(
            name=d["name"],
            dtype_str=d["dtype"],
            shape=tuple(d["shape"]),
            codec=d["codec"],
            base_hash=d.get("base_hash"),
            self_hash=d["self_hash"],
            plane_sizes=list(d.get("plane_sizes", [])),
            raw_size=int(d.get("raw_size", 0)),
            base_dtype=d.get("base_dtype"),
            qscale_bits=int(qs) if qs is not None else None,
            qzero_point=int(qz) if qz is not None else None,
        )


class BitXCodec:
    """Back-compat facade over the codec registry (kept for one release).

    New code goes through :mod:`repro_torch.core.codecs` directly; this class maps
    the old per-codec ``encode_*``/``decode_*`` methods onto registry lanes
    sharing one :class:`~repro_torch.core.codecs.CodecRuntime`. The runtime owns
    the zstd contexts per worker thread (compressor objects are not
    thread-safe), so a codec instance is still safe to share across a pool.
    ``threads`` is forwarded to ``zstd.ZstdCompressor(threads=...)``.
    """

    def __init__(self, level: int = DEFAULT_ZSTD_LEVEL, threads: int = 0,
                 backend=None):
        self.level = level
        self.threads = threads
        self.runtime = CodecRuntime(level=level, threads=threads,
                                    backend=get_backend(backend or "torch"))

    @property
    def _cctx(self):
        return self.runtime._compressor()

    @property
    def _dctx(self):
        return self.runtime._decompressor()

    # -- BitX ---------------------------------------------------------------
    def encode_delta(self, base: np.ndarray, ft: np.ndarray) -> Tuple[List[bytes], int]:
        """Returns (compressed plane frames MSB-first, raw byte size)."""
        _, frames, raw = get_codec("bitx").encode(
            self.runtime, EncodeInput(data=ft, base=base))
        return frames, raw

    def decode_delta(
        self, frames: Sequence[bytes], base: np.ndarray
    ) -> np.ndarray:
        planes = [np.frombuffer(self.runtime.decompress(f), np.uint8) for f in frames]
        return self.runtime.backend.merge_planes_xor(planes, base)

    # -- ZipNN fallback (no base available, §4.4.3) ---------------------------
    def encode_planes(self, x: np.ndarray) -> Tuple[List[bytes], int]:
        _, frames, raw = get_codec("zipnn").encode(self.runtime, EncodeInput(data=x))
        return frames, raw

    def decode_planes(self, frames: Sequence[bytes], dtype_np: np.dtype, shape) -> np.ndarray:
        planes = [np.frombuffer(self.runtime.decompress(f), np.uint8) for f in frames]
        return self.runtime.backend.merge_planes(planes, dtype_np, shape)

    # -- raw zstd (non-float / last resort) ----------------------------------
    def encode_raw(self, data: bytes) -> bytes:
        return self.runtime.compress(data)

    def decode_raw(self, frame: bytes) -> bytes:
        return self.runtime.decompress(frame)

    # -- stored (verbatim) ----------------------------------------------------
    @staticmethod
    def choose_raw_codec(data: bytes, frame: bytes) -> Tuple[str, bytes]:
        """Deprecated alias of :func:`repro_torch.core.codecs.raw_or_stored`."""
        return raw_or_stored(data, frame)


class BitXWriter:
    """Streams TensorRecords + frames into a .bitx container."""

    def __init__(self, level: int = DEFAULT_ZSTD_LEVEL, file_metadata: Optional[Dict] = None,
                 threads: int = 0, backend=None):
        self.codec = BitXCodec(level=level, threads=threads, backend=backend)
        self.records: List[TensorRecord] = []
        self.frames: List[bytes] = []
        self.file_metadata = dict(file_metadata or {})

    def add_bitx(
        self, name: str, dtype_str: str, shape, base: np.ndarray, ft: np.ndarray,
        base_hash: str, self_hash: str,
    ) -> int:
        frames, raw = self.codec.encode_delta(base, ft)
        self.records.append(
            TensorRecord(name, dtype_str, tuple(shape), "bitx", base_hash, self_hash,
                         [len(f) for f in frames], raw)
        )
        self.frames.extend(frames)
        return sum(len(f) for f in frames)

    def add_zipnn(self, name: str, dtype_str: str, shape, x: np.ndarray, self_hash: str) -> int:
        frames, raw = self.codec.encode_planes(x)
        self.records.append(
            TensorRecord(name, dtype_str, tuple(shape), "zipnn", None, self_hash,
                         [len(f) for f in frames], raw)
        )
        self.frames.extend(frames)
        return sum(len(f) for f in frames)

    def add_raw(self, name: str, dtype_str: str, shape, data: bytes, self_hash: str) -> int:
        frame = self.codec.encode_raw(data)
        self.records.append(
            TensorRecord(name, dtype_str, tuple(shape), "raw", None, self_hash,
                         [len(frame)], len(data))
        )
        self.frames.append(frame)
        return len(frame)

    def add_dedup(self, name: str, dtype_str: str, shape, self_hash: str, raw_size: int) -> int:
        """Tensor already in the pool — store only the reference (0 payload)."""
        self.records.append(
            TensorRecord(name, dtype_str, tuple(shape), "dedup", None, self_hash, [], raw_size)
        )
        return 0

    def add_precomputed(self, name: str, dtype_str: str, shape, codec: str,
                        base_hash: Optional[str], self_hash: str,
                        frames: Sequence[bytes], raw_size: int,
                        extras: Optional[Dict] = None) -> int:
        """Append a record whose frames were encoded elsewhere (the parallel
        ingest engine encodes off-thread, then merges in tensor order so the
        container bytes match the serial path exactly). ``extras`` carries
        optional stamp fields a lane needs replayed at decode time (the
        quantized-delta lane's ``base_dtype``/``qscale_bits``/``qzero_point``).
        Zero-payload dedup records go through :meth:`add_dedup` instead."""
        assert codec in ("bitx", "bitxq", "zipnn", "raw", "stored"), codec
        self.records.append(
            TensorRecord(name, dtype_str, tuple(shape), codec, base_hash, self_hash,
                         [len(f) for f in frames], raw_size, **(extras or {}))
        )
        self.frames.extend(frames)
        return sum(len(f) for f in frames)

    def tobytes(self) -> bytes:
        header = {
            "metadata": self.file_metadata,
            "backend": zstd.BACKEND,
            "tensors": [r.to_json() for r in self.records],
        }
        hjson = json.dumps(header, separators=(",", ":")).encode()
        out = io.BytesIO()
        out.write(MAGIC)
        out.write(struct.pack("<Q", len(hjson)))
        out.write(hjson)
        for f in self.frames:
            out.write(f)
        return out.getvalue()

    def write(self, path: str, *, fault_hook=None, fsync: bool = False) -> int:
        """Write the container atomically: bytes land at ``path + TMP_SUFFIX``
        first and are renamed into place, so a crash at any instant leaves
        either no file, a ``.part`` temp (orphan-scan debris), or the
        complete container — never a torn file at the final path.

        ``fault_hook(point_name)`` is the crash-injection hook for the
        recovery test harness; it may raise to simulate a kill at that
        point. No cleanup runs when it does — the on-disk state is exactly
        what a real crash would leave (callers that *handle* failures, e.g.
        the ingest rollback, remove both ``path`` and the temp themselves).
        ``fsync=True`` flushes the temp file to stable storage before the
        rename (the compaction path, where the old copies are deleted soon
        after)."""
        blob = self.tobytes()
        if fault_hook is not None:
            fault_hook("writer.before_write")
        tmp = path + TMP_SUFFIX
        with open(tmp, "wb") as f:
            f.write(blob)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if fault_hook is not None:
            fault_hook("writer.after_temp")
        os.replace(tmp, path)
        if fault_hook is not None:
            fault_hook("writer.after_rename")
        return len(blob)


class BitXReader:
    """Reads a .bitx container; decode requires a base-tensor resolver for
    bitx-coded records and a pool resolver for dedup'd records.

    ``open(path)`` memory-maps the container: only the header is parsed
    eagerly, frames are lazy zero-copy slices of the map
    (:meth:`frames_for` returns memoryviews), so resolving a single tensor
    out of a multi-GB container touches just that tensor's pages. A reader
    is safe to share across decode worker threads (the runtime keeps its
    zstd contexts thread-local); call :meth:`close` to drop the map.

    ``runtime`` selects the entropy settings and array backend used for
    decode (the store passes its own); the default is a torch-backed
    runtime on the card at default settings — decode output is identical
    either way.
    """

    def __init__(self, data, runtime: Optional[CodecRuntime] = None):
        view = memoryview(data)
        assert bytes(view[:8]) == MAGIC, "not a BitX container"
        (hlen,) = struct.unpack("<Q", view[8:16])
        header = json.loads(bytes(view[16 : 16 + hlen]))
        backend = header.get("backend", zstd.BACKEND)
        if backend != zstd.BACKEND:
            raise ValueError(
                f"container written with entropy backend {backend!r} but this "
                f"process runs {zstd.BACKEND!r} (see repro_torch.core.zstd_compat)")
        self.file_metadata: Dict = header.get("metadata", {})
        self.records = [TensorRecord.from_json(r) for r in header["tensors"]]
        self._name_to_idx: Optional[Dict[str, int]] = None
        self._payload = view[16 + hlen :]
        # absolute file offset where the frame payload begins — frame spans
        # (``frame_span``) are payload-relative and need this to become
        # sendfile-able (path, offset, length) triples
        self.payload_offset = 16 + hlen
        self.path: Optional[str] = None  # set by open(); None for byte-backed
        self._mmap: Optional[mmap.mmap] = None
        self._file = None
        # frame offsets in record order
        self._offsets: List[List[Tuple[int, int]]] = []
        off = 0
        for r in self.records:
            sizes = r.plane_sizes
            spans = []
            for s in sizes:
                spans.append((off, off + s))
                off += s
            self._offsets.append(spans)
        self.runtime = runtime if runtime is not None else CodecRuntime()

    @staticmethod
    def open(path: str, use_mmap: bool = True,
             runtime: Optional[CodecRuntime] = None) -> "BitXReader":
        if not use_mmap:
            with open(path, "rb") as f:
                return BitXReader(f.read(), runtime=runtime)
        f = open(path, "rb")
        mm = None
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            reader = BitXReader(mm, runtime=runtime)  # may raise (bad magic, backend mismatch)
        except Exception:
            if mm is not None:
                try:
                    mm.close()
                except BufferError:
                    # the raising frame still exports a view over the map;
                    # GC finalizes it once the traceback is released
                    pass
            f.close()  # the fd is the scarce resource — always release it
            raise
        reader._mmap, reader._file = mm, f
        reader.path = path
        return reader

    def close(self) -> None:
        """Release the memory map (no-op for byte-backed readers). Frames
        already handed out keep the map alive until they are collected."""
        self._payload = memoryview(b"")
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                pass  # exported frame views still alive; GC finishes the job
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None

    @property
    def payload_size(self) -> int:
        """Actual payload bytes behind the header (mmap/bytes length)."""
        return len(self._payload)

    @property
    def expected_payload_size(self) -> int:
        """Payload bytes the header's plane_sizes promise. A container whose
        actual payload is shorter was truncated — fsck flags it corrupt."""
        return sum(s for r in self.records for s in r.plane_sizes)

    def index_of(self, name: str) -> int:
        """Record index for a tensor name (KeyError if absent). The map is
        built lazily once per reader — tensor-granular serving resolves by
        name on every request, so the lookup must not rescan the records.
        Safe under concurrent builders: both compute the same dict and the
        attribute store is atomic."""
        m = self._name_to_idx
        if m is None:
            m = self._name_to_idx = {r.name: i for i, r in enumerate(self.records)}
        return m[name]

    def frames_for(self, idx: int) -> List[memoryview]:
        return [self._payload[b:e] for b, e in self._offsets[idx]]

    def frame_span(self, idx: int) -> Tuple[int, int]:
        """(absolute file offset, length) of record ``idx``'s contiguous
        frame bytes. For ``stored`` records this span IS the tensor's raw
        little-endian bytes on disk — the serving layer's zero-copy
        ``os.sendfile`` source."""
        spans = self._offsets[idx]
        if not spans:
            return self.payload_offset, 0
        return self.payload_offset + spans[0][0], spans[-1][1] - spans[0][0]

    def decode_tensor(self, idx: int, base_resolver, pool_resolver) -> np.ndarray:
        """Decode record ``idx`` to its raw bit-view array via the codec
        registry (an unknown stamped codec raises ``ValueError`` naming it).

        ``base_resolver(base_hash) -> np.ndarray`` and
        ``pool_resolver(self_hash) -> np.ndarray`` fetch dependencies (CAS pool).
        """
        from repro_torch.formats.safetensors import STR_TO_DTYPE

        r = self.records[idx]
        codec = get_codec(r.codec)
        return codec.decode(self.runtime, r, self.frames_for(idx),
                            STR_TO_DTYPE[r.dtype_str], base_resolver, pool_resolver)
