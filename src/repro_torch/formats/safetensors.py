# Port copy of src/repro/formats/safetensors.py: host-only, logic unchanged;
# ``save_stream`` added (``save_file`` writes through it).
"""Dependency-free safetensors reader/writer.

Implements the safetensors on-disk format (https://github.com/huggingface/safetensors):

    [8 bytes LE u64: header_len][header_len bytes: JSON header][tensor data]

Header JSON maps tensor name -> {"dtype": str, "shape": [...], "data_offsets": [b, e]}
plus an optional "__metadata__" string->string map. Offsets are relative to the
end of the header. Tensors are serialized little-endian, row-major, unaligned.

The paper's pipeline (§4.1) depends on exactly this structure: the header gives
tensor boundaries for TensorDedup and float alignment for BitX, with zero-copy
per-tensor access. We implement it from scratch (no `safetensors` dependency in
this container) with two additions the paper calls for in §6:

* ``tensor_order`` — we always write tensors in *insertion order* and record it,
  so BitX alignment never degrades from alphabetical reordering.
* memory-mapped reads — per-tensor ``np.memmap`` views so TensorDedup can hash
  tensors in parallel without loading the full file.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DTYPE_TO_STR",
    "STR_TO_DTYPE",
    "TensorInfo",
    "SafetensorsFile",
    "save_file",
    "save_stream",
    "load_file",
    "read_header",
    "read_header_blob",
    "iter_tensors",
]

# safetensors dtype tags. bfloat16 has no numpy dtype; we represent it as a
# uint16 view tagged "BF16" (bit-identical, which is all the storage layer needs).
DTYPE_TO_STR: Dict[str, str] = {
    "float64": "F64",
    "float32": "F32",
    "float16": "F16",
    "bfloat16": "BF16",
    "int64": "I64",
    "int32": "I32",
    "int16": "I16",
    "int8": "I8",
    "uint8": "U8",
    "uint16": "U16",
    "uint32": "U32",
    "uint64": "U64",
    "bool": "BOOL",
}

STR_TO_DTYPE: Dict[str, np.dtype] = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"),  # bit view; semantic dtype kept in TensorInfo.dtype_str
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "U16": np.dtype("<u2"),
    "U32": np.dtype("<u4"),
    "U64": np.dtype("<u8"),
    "BOOL": np.dtype("?"),
}

ITEMSIZE: Dict[str, int] = {k: v.itemsize for k, v in STR_TO_DTYPE.items()}

_HEADER_LEN_FMT = "<Q"


@dataclass(frozen=True)
class TensorInfo:
    """Metadata for one tensor inside a safetensors file."""

    name: str
    dtype_str: str  # safetensors tag, e.g. "BF16"
    shape: Tuple[int, ...]
    data_offsets: Tuple[int, int]  # relative to end of header

    @property
    def nbytes(self) -> int:
        return self.data_offsets[1] - self.data_offsets[0]

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def np_view_dtype(self) -> np.dtype:
        return STR_TO_DTYPE[self.dtype_str]


def _normalize_array(arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """Return (safetensors dtype tag, contiguous LE byte-compatible array)."""
    # ml_dtypes bfloat16 support: detect by name so we do not import ml_dtypes here.
    name = arr.dtype.name
    if name == "bfloat16":
        return "BF16", np.ascontiguousarray(arr).view(np.uint16)
    if name not in DTYPE_TO_STR:
        raise ValueError(f"unsupported dtype for safetensors: {arr.dtype}")
    tag = DTYPE_TO_STR[name]
    out = np.ascontiguousarray(arr)
    if out.dtype.byteorder == ">":
        out = out.astype(out.dtype.newbyteorder("<"))
    return tag, out


def save_file(
    tensors: Mapping[str, np.ndarray],
    path: str | os.PathLike,
    metadata: Optional[Mapping[str, str]] = None,
    dtype_tags: Optional[Mapping[str, str]] = None,
) -> None:
    """Write ``tensors`` to ``path`` in safetensors format.

    ``dtype_tags`` optionally overrides the dtype tag per tensor — used to write
    a uint16 bit-view as "BF16" (the storage layer moves raw bits around).
    Tensors are written in *insertion order* and that order is recorded in
    ``__metadata__["tensor_order"]`` (§6 of the paper: order-preserving headers).
    """
    entries: List[Tuple[str, str, Tuple[int, ...]]] = []
    payloads: List[np.ndarray] = []
    for name, arr in tensors.items():
        if dtype_tags and name in dtype_tags:
            tag = dtype_tags[name]
            buf = np.ascontiguousarray(arr).view(STR_TO_DTYPE[tag])
        else:
            tag, buf = _normalize_array(np.asarray(arr))
        entries.append((name, tag, np.asarray(arr).shape))
        payloads.append(buf)
    save_stream(entries, payloads, path, metadata)


def save_stream(
    entries: Sequence[Tuple[str, str, Sequence[int]]],
    payloads: Iterable[np.ndarray],
    path: str | os.PathLike,
    metadata: Optional[Mapping[str, str]] = None,
) -> None:
    """Write a safetensors file whose payloads arrive one at a time.

    ``entries`` gives every tensor's (name, dtype tag, shape) up front, for the
    header; ``payloads`` then yields the tensors' arrays in that order, each
    written before the next is drawn, so the caller never holds more than one
    (a checkpoint gathered tensor by tensor). Bytes are :func:`save_file`'s.
    """
    header: Dict[str, object] = {}
    offset = 0
    order: List[str] = []
    for name, tag, shape in entries:
        nbytes = ITEMSIZE[tag] * math.prod(shape)
        header[name] = {
            "dtype": tag,
            "shape": [int(s) for s in shape],
            "data_offsets": [offset, offset + nbytes],
        }
        order.append(name)
        offset += nbytes

    meta: Dict[str, str] = dict(metadata or {})
    meta.setdefault("tensor_order", json.dumps(order))
    header["__metadata__"] = meta

    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    # safetensors pads the header with spaces to 8-byte alignment.
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad

    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack(_HEADER_LEN_FMT, len(hjson)))
            f.write(hjson)
            it = iter(payloads)
            for name, _, _ in entries:
                buf = next(it, None)
                if buf is None:
                    raise ValueError(f"no payload for {name}")
                lo, hi = header[name]["data_offsets"]
                buf = np.ascontiguousarray(buf)
                if buf.nbytes != hi - lo:
                    raise ValueError(f"{name}: payload of {buf.nbytes} bytes, "
                                     f"header says {hi - lo}")
                f.write(buf.reshape(-1).view(np.uint8))
                del buf  # before the next payload is drawn
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        os.remove(tmp)
        raise
    os.replace(tmp, path)  # atomic commit


def read_header(path: str | os.PathLike) -> Tuple[List[TensorInfo], Dict[str, str], int]:
    """Parse just the header. Returns (infos in serialization order, metadata,
    absolute byte offset where tensor data begins)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack(_HEADER_LEN_FMT, f.read(8))
        hjson = f.read(hlen)
    return _parse_header(hjson, hlen)


def read_header_blob(blob: bytes) -> Tuple[List[TensorInfo], Dict[str, str], int]:
    """:func:`read_header` over in-memory file bytes (``[8-byte len][JSON
    header]...``) — e.g. the header blob a near-dup index entry stores."""
    (hlen,) = struct.unpack(_HEADER_LEN_FMT, blob[:8])
    return _parse_header(bytes(blob[8:8 + hlen]), hlen)


def _parse_header(hjson: bytes, hlen: int) -> Tuple[List[TensorInfo], Dict[str, str], int]:
    header = json.loads(hjson)
    metadata = {str(k): str(v) for k, v in (header.pop("__metadata__", {}) or {}).items()}
    infos = [
        TensorInfo(
            name=name,
            dtype_str=spec["dtype"],
            shape=tuple(int(s) for s in spec["shape"]),
            data_offsets=(int(spec["data_offsets"][0]), int(spec["data_offsets"][1])),
        )
        for name, spec in header.items()
    ]
    # Serialization order == offset order (the property BitX alignment needs).
    infos.sort(key=lambda ti: ti.data_offsets[0])
    return infos, metadata, 8 + hlen


class SafetensorsFile:
    """Zero-copy reader: per-tensor memory-mapped views.

    The paper's TensorDedup (§4.4.2) hashes tensors independently and in
    parallel; mmap views let workers touch only their tensor's pages.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self.infos, self.metadata, self.data_start = read_header(self.path)
        self._by_name = {ti.name: ti for ti in self.infos}
        self._file = open(self.path, "rb")
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        try:
            self._mmap.close()
        except BufferError:
            # zero-copy views handed out (np.frombuffer) are still alive; the
            # mmap closes when they are collected. Intentional: TensorDedup /
            # BitX hold tensor views only transiently.
            pass
        finally:
            self._file.close()

    # -- access -----------------------------------------------------------
    _ADVICE = {"sequential": "MADV_SEQUENTIAL", "random": "MADV_RANDOM",
               "willneed": "MADV_WILLNEED"}

    def advise(self, mode: str = "sequential") -> None:
        """Hint the kernel about the upcoming access pattern (madvise).

        The ingest engine walks tensors in serialization order
        ("sequential"); parallel workers resolving base tensors jump around
        ("random"). No-op on platforms without mmap.madvise.
        """
        flag = getattr(mmap, self._ADVICE[mode], None)
        if flag is not None and hasattr(self._mmap, "madvise"):
            self._mmap.madvise(flag)

    def names(self) -> List[str]:
        return [ti.name for ti in self.infos]

    def info(self, name: str) -> TensorInfo:
        return self._by_name[name]

    def tensor_bytes(self, name: str) -> memoryview:
        ti = self._by_name[name]
        b, e = ti.data_offsets
        return memoryview(self._mmap)[self.data_start + b : self.data_start + e]

    def tensor(self, name: str) -> np.ndarray:
        """Bit-view array (BF16 tensors come back as uint16 views)."""
        ti = self._by_name[name]
        arr = np.frombuffer(self.tensor_bytes(name), dtype=ti.np_view_dtype)
        return arr.reshape(ti.shape)

    def __iter__(self) -> Iterator[Tuple[TensorInfo, np.ndarray]]:
        for ti in self.infos:
            yield ti, self.tensor(ti.name)


def load_file(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Load every tensor into memory (bit views for BF16). Copies out of mmap."""
    with SafetensorsFile(path) as sf:
        return {ti.name: np.array(sf.tensor(ti.name)) for ti in sf.infos}


def iter_tensors(path: str | os.PathLike) -> Iterator[Tuple[TensorInfo, np.ndarray]]:
    with SafetensorsFile(path) as sf:
        for ti, arr in sf:
            yield ti, arr
