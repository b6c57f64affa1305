# Port copy of src/repro/core/codecs.py: host-only, logic unchanged except that
# a runtime made without a backend gets the torch backend.
"""Codec registry: the store's pluggable per-tensor encode/decode lanes.

Every payload lane a container can stamp (``bitx`` / ``bitxq`` / ``zipnn`` /
``raw`` / ``stored`` / ``dedup``) is registered here as a pair of PURE
functions of (bytes, backend): given the same tensor bytes, the same entropy
settings and the same :class:`~repro_torch.core.bitx.ArrayBackend`, a codec must
emit identical frames on every engine (serial, threaded, process-entropy,
device-batched) — that purity is what lets the pipeline's ordered merge
produce bit-identical containers no matter how the work is scheduled.

Registry contract:

* ``register_codec(name, encode, decode)`` — ``encode(runtime, EncodeInput)
  -> (final_codec, frames, raw_size)`` may *downgrade* the lane (``raw`` →
  ``stored`` when entropy coding would grow the bytes; ``bitxq`` → the
  standalone ``raw``/``stored`` outcome when the delta does not beat it).
  An encode may instead return a 4-tuple ``(final_codec, frames, raw_size,
  extras)`` where ``extras`` is a dict of :class:`TensorRecord` stamp
  fields the decode side must see (the quantized-delta lane stamps
  ``base_dtype``/``qscale_bits``/``qzero_point`` this way). ``decode(runtime,
  record, frames, np_dtype, base_resolver, pool_resolver) -> np.ndarray``
  must invert it bit-exactly.
* ``get_codec(name)`` — raises ``ValueError`` naming the unknown codec (a
  container stamped by a newer build fails loudly, never silently).
* Codecs never touch zstd contexts directly: the :class:`CodecRuntime`
  handle owns them per-thread (compressor contexts are NOT thread-safe) and
  asserts ownership on every use, so an implementation cannot accidentally
  smuggle a context across threads.

Array math (XOR delta, byte-plane split/merge) goes through
``runtime.backend`` — the :class:`~repro_torch.core.bitx.ArrayBackend` selected at
store construction — so the numpy host path and the batched torch/CUDA
device path share one dispatch point.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import zstd_compat as zstd

__all__ = [
    "Codec",
    "CodecRuntime",
    "EncodeInput",
    "get_codec",
    "raw_or_stored",
    "register_codec",
    "registered_codecs",
]


class _ThreadGuardedCtx:
    """A zstd context bound to the thread that materialized it.

    zstd compressor/decompressor contexts are not thread-safe; sharing one
    mid-operation corrupts frames silently. The guard makes the failure mode
    loud: every use asserts the calling thread is the owning thread.
    """

    __slots__ = ("_ctx", "_owner")

    def __init__(self, ctx):
        self._ctx = ctx
        self._owner = threading.get_ident()

    def _check(self) -> None:
        assert self._owner == threading.get_ident(), (
            f"zstd context created on thread {self._owner} used from thread "
            f"{threading.get_ident()} — contexts are not thread-safe; go "
            f"through CodecRuntime.compress/decompress, which are per-thread")

    def compress(self, data) -> bytes:
        self._check()
        return self._ctx.compress(data)

    def decompress(self, data) -> bytes:
        self._check()
        return self._ctx.decompress(data)


class CodecRuntime:
    """Execution handle passed to every registered codec.

    Owns (a) the :class:`~repro_torch.core.bitx.ArrayBackend` for array math and
    (b) the zstd entropy contexts, kept in thread-local storage and wrapped
    in an owner-thread assertion — one runtime is shared across a worker
    pool and each worker lazily gets its own context pair. Frames are a pure
    function of (bytes, level, threads), so per-thread contexts never change
    the emitted bytes.
    """

    def __init__(self, level: int = 3, threads: int = 0, backend=None):
        if backend is None:
            from repro_torch.core.bitx import get_backend
            backend = get_backend("torch")
        self.level = level
        self.threads = threads
        self.backend = backend
        self._tls = threading.local()

    def _compressor(self) -> _ThreadGuardedCtx:
        ctx = getattr(self._tls, "cctx", None)
        if ctx is None:
            ctx = self._tls.cctx = _ThreadGuardedCtx(
                zstd.ZstdCompressor(level=self.level, threads=self.threads))
        return ctx

    def _decompressor(self) -> _ThreadGuardedCtx:
        ctx = getattr(self._tls, "dctx", None)
        if ctx is None:
            ctx = self._tls.dctx = _ThreadGuardedCtx(zstd.ZstdDecompressor())
        return ctx

    def compress(self, data) -> bytes:
        return self._compressor().compress(data)

    def decompress(self, data) -> bytes:
        return self._decompressor().decompress(data)


@dataclass
class EncodeInput:
    """What a codec's encode lane consumes.

    ``data`` is the tensor payload: an ndarray for the plane codecs, raw
    bytes for ``raw``/``stored``. ``base`` is the aligned base tensor for
    ``bitx``/``bitxq``. ``base_dtype`` names the base's safetensors tag for
    the dtype-crossing ``bitxq`` lane (the base arrives as a bit view —
    uint16 for BF16 — so its dtype is not recoverable from the array alone).
    ``planes`` short-circuits the array stage: the device-batched encode
    path splits planes for a whole bucket in one kernel launch and hands
    them in pre-computed, leaving the codec only the entropy stage — the
    frames are identical either way because the plane bytes are.
    ``raw_size`` carries the pool payload size for zero-frame ``dedup``
    records.
    """

    data: Any = None
    base: Optional[np.ndarray] = None
    planes: Optional[Sequence[np.ndarray]] = None
    raw_size: int = 0
    base_dtype: Optional[str] = None


@dataclass(frozen=True)
class Codec:
    name: str
    encode: Callable[[CodecRuntime, EncodeInput], Tuple[str, List[bytes], int]]
    decode: Callable[..., np.ndarray]


_REGISTRY: Dict[str, Codec] = {}


def register_codec(name: str, encode: Callable, decode: Callable,
                   *, replace: bool = False) -> Codec:
    """Register a codec lane. ``encode``/``decode`` must be pure functions of
    (bytes, backend) — see the module docstring for the exact signatures."""
    if name in _REGISTRY and not replace:
        raise ValueError(f"codec {name!r} already registered "
                         f"(pass replace=True to override)")
    codec = Codec(name, encode, decode)
    _REGISTRY[name] = codec
    return codec


def get_codec(name: str) -> Codec:
    """Look a codec up by its stamped name; unknown names fail loudly so a
    container written by a newer build is never mis-decoded."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r} (registered: "
            f"{', '.join(sorted(_REGISTRY))})") from None


def registered_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def raw_or_stored(data: bytes, frame: bytes) -> Tuple[str, bytes]:
    """Entropy-stage decision for raw-kind tensors: keep the compressed frame
    only when it actually shrank the input; otherwise store the bytes
    VERBATIM under codec ``stored`` (the serving layer's zero-copy
    ``os.sendfile`` span). Pure function of (bytes, entropy backend), so
    every engine emits identical containers."""
    if len(frame) < len(data):
        return "raw", frame
    return "stored", data


# ---------------------------------------------------------------------------
# The six built-in lanes (paper §4.3/§4.4): BitX XOR-delta planes, the
# quantized dtype-crossing delta (bitxq), ZipNN byte planes, raw zstd with
# the stored downgrade, verbatim stored bytes, and zero-payload dedup
# references.
# ---------------------------------------------------------------------------

def _entropy_planes(rt: CodecRuntime, planes: Sequence) -> List[bytes]:
    return [rt.compress(p.tobytes() if isinstance(p, np.ndarray) else bytes(p))
            for p in planes]


def _plane_arrays(rt: CodecRuntime, frames: Sequence) -> List[np.ndarray]:
    return [np.frombuffer(rt.decompress(bytes(f)), np.uint8) for f in frames]


def _encode_bitx(rt: CodecRuntime, inp: EncodeInput):
    if inp.data is not None:
        ft = np.asarray(inp.data)
        raw = int(ft.nbytes)
        planes = (inp.planes if inp.planes is not None else
                  rt.backend.xor_delta_planes(np.asarray(inp.base).reshape(-1),
                                              ft.reshape(-1)))
    else:  # device-batched path: planes pre-split, only entropy remains
        planes, raw = inp.planes, int(inp.raw_size)
    return "bitx", _entropy_planes(rt, planes), raw


def _decode_bitx(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    base = base_resolver(r.base_hash)
    if isinstance(base, (bytes, memoryview)):
        base = np.frombuffer(base, np_dtype)
    planes = _plane_arrays(rt, frames)
    return rt.backend.merge_planes_xor(planes, base.reshape(-1)).reshape(r.shape)


# -- quantized (dtype-crossing) delta lane ----------------------------------
# An int8 repack of a float family base deltas against the ORIGINAL base via
# dequantize-predict-residual: the base is expanded to float32, a symmetric
# per-tensor scale is derived from the base itself, the base is re-quantized
# onto the int8 grid as a *prediction*, and only the XOR residual between
# prediction and actual quantized bytes is entropy-coded. Everything the
# decode side needs to replay the prediction (base hash, base dtype, the
# scale's exact f32 bit pattern, the zero point) is stamped on the record,
# so the lane is lossless by construction — ZipNN (arXiv:2411.05239) and
# Huff-LLM (arXiv:2502.00922) both motivate keeping dtype-aware lanes
# bit-exact. The prediction is ALWAYS computed host-side in numpy (float32
# arithmetic is not guaranteed bit-stable across accelerators); only the
# elementwise XOR/merge goes through the ArrayBackend, so numpy and torch
# engines emit and decode identical containers.

_QDELTA_INT_RANGE = 127  # symmetric int8 grid: [-127, 127]


def _base_to_f32(base: Any, base_dtype: str) -> np.ndarray:
    """Expand a base tensor (bytes or bit-view ndarray) to float32, exactly.

    BF16 arrives as a uint16 bit view; shifting into the high half of a
    uint32 reconstructs the float32 it truncates — exact by definition, no
    ml_dtypes dependency. F16/F32 widen losslessly via astype.
    """
    from repro_torch.formats.safetensors import STR_TO_DTYPE
    np_dtype = STR_TO_DTYPE[base_dtype]
    if isinstance(base, (bytes, memoryview)):
        base = np.frombuffer(base, np_dtype)
    else:
        base = np.asarray(base).reshape(-1).view(np_dtype)
    if base_dtype == "BF16":
        bits = base.view("<u2").astype(np.uint32) << np.uint32(16)
        return bits.view(np.float32)
    return base.astype(np.float32)


def _qdelta_scale_bits(base_f32: np.ndarray) -> int:
    """Symmetric per-tensor scale derived from the BASE: max finite |x| / 127,
    returned as the float32 bit pattern (the container stamps bits, not a
    decimal, so encode and decode replay the identical scale). Degenerate
    bases (all-zero / no finite values) fall back to scale 1.0."""
    finite = base_f32[np.isfinite(base_f32)]
    amax = float(np.abs(finite).max()) if finite.size else 0.0
    scale = np.float32(amax / _QDELTA_INT_RANGE) if amax > 0.0 else np.float32(1.0)
    if not np.isfinite(scale) or scale == 0.0:
        scale = np.float32(1.0)
    return int(scale.view(np.uint32))


def _qdelta_predict(base_f32: np.ndarray, scale_bits: int,
                    zero_point: int) -> np.ndarray:
    """Re-quantize the base onto the int8 grid — the decode side's prediction.
    Pure float32 numpy math: divide, round-to-nearest-even, shift by the zero
    point, clip to the symmetric range. Non-finite base elements predict the
    zero point (their residual then carries the actual bits verbatim)."""
    scale = np.array(scale_bits, dtype=np.uint32).view(np.float32)[()]
    bf = np.where(np.isfinite(base_f32), base_f32, np.float32(0.0))
    q = np.rint(bf / scale) + np.float32(zero_point)
    return np.clip(q, -_QDELTA_INT_RANGE, _QDELTA_INT_RANGE).astype(np.int8)


def _encode_bitxq(rt: CodecRuntime, inp: EncodeInput):
    q = np.asarray(inp.data).reshape(-1).view(np.int8)
    raw = int(q.nbytes)
    base_f32 = _base_to_f32(inp.base, inp.base_dtype)
    scale_bits = _qdelta_scale_bits(base_f32)
    zero_point = 0
    pred = _qdelta_predict(base_f32, scale_bits, zero_point)
    planes = rt.backend.xor_delta_planes(pred, q)
    frames = _entropy_planes(rt, planes)
    # lane-vs-standalone decision, a pure function of the tensor bytes: the
    # delta only ships when it beats what the standalone raw lane would
    # store for the same bytes; otherwise downgrade to that exact outcome
    # (the merge stage nulls the base reference on a 3-tuple downgrade).
    data = q.tobytes()
    final, payload = raw_or_stored(data, rt.compress(data))
    if sum(len(f) for f in frames) < len(payload):
        return "bitxq", frames, raw, {"base_dtype": inp.base_dtype,
                                      "qscale_bits": scale_bits,
                                      "qzero_point": zero_point}
    return final, [payload], raw


def _decode_bitxq(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    base_f32 = _base_to_f32(base_resolver(r.base_hash), r.base_dtype)
    pred = _qdelta_predict(base_f32, r.qscale_bits, r.qzero_point or 0)
    planes = _plane_arrays(rt, frames)
    q = rt.backend.merge_planes_xor(planes, pred)
    return q.view(np_dtype).reshape(r.shape)


def _encode_zipnn(rt: CodecRuntime, inp: EncodeInput):
    if inp.data is not None:
        x = np.asarray(inp.data)
        raw = int(x.nbytes)
        planes = (inp.planes if inp.planes is not None else
                  rt.backend.byte_planes(x))
    else:  # device-batched path: planes pre-split, only entropy remains
        planes, raw = inp.planes, int(inp.raw_size)
    return "zipnn", _entropy_planes(rt, planes), raw


def _decode_zipnn(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    planes = _plane_arrays(rt, frames)
    return rt.backend.merge_planes(planes, np_dtype, r.shape)


def _encode_raw(rt: CodecRuntime, inp: EncodeInput):
    data = bytes(inp.data)
    final, payload = raw_or_stored(data, rt.compress(data))
    return final, [payload], len(data)


def _decode_raw(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    return np.frombuffer(rt.decompress(bytes(frames[0])), np_dtype).reshape(r.shape)


def _encode_stored(rt: CodecRuntime, inp: EncodeInput):
    data = bytes(inp.data)
    return "stored", [data], len(data)


def _decode_stored(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    # verbatim frame: the on-disk bytes ARE the tensor bytes
    return np.frombuffer(frames[0], np_dtype).reshape(r.shape)


def _encode_dedup(rt: CodecRuntime, inp: EncodeInput):
    return "dedup", [], int(inp.raw_size)


def _decode_dedup(rt, r, frames, np_dtype, base_resolver, pool_resolver):
    arr = pool_resolver(r.self_hash)
    if isinstance(arr, (bytes, memoryview)):
        return np.frombuffer(arr, np_dtype).reshape(r.shape)
    return arr.reshape(r.shape)


register_codec("bitx", _encode_bitx, _decode_bitx)
register_codec("bitxq", _encode_bitxq, _decode_bitxq)
register_codec("zipnn", _encode_zipnn, _decode_zipnn)
register_codec("raw", _encode_raw, _decode_raw)
register_codec("stored", _encode_stored, _decode_stored)
register_codec("dedup", _encode_dedup, _decode_dedup)
