# Port copy of src/repro/core/pipeline.py: host-only, logic unchanged except the
# ZLLMStore backend default ("torch", so the store runs on the card), the
# backend counters in summary(), and _elect_base, which unbinds a family base
# whose tensors gc or compaction retired before an upload is coded against it
# (the reference BitX-codes such an upload against hashes with no record), or
# rebinds a repo id to its key's live binding.
"""zLLM end-to-end storage reduction pipeline (paper §4.4, Fig. 7).

Ingest path per uploaded repo:

  ① FileDedup      — sha256 whole-file prefilter; duplicates become refs.
  ② TensorDedup    — per-tensor hashes against the global tensor pool;
                     repeated tensors become zero-payload "dedup" records.
  ③a Model tree    — base-model lineage from config.json / README metadata.
  ③b Bit distance  — when metadata is missing: shape-signature prefilter +
                     sampled bit distance against registered bases (≤ a few
                     comparisons), threshold 4 bits/element.
  ③c BitX          — unique tensors of family-matched models are XOR-delta'd
                     against the aligned base tensor and byte-plane split.
  ④ zstd           — entropy stage per plane. No-family models fall back to
                     ZipNN byte-plane coding; non-float tensors to raw zstd.

Retrieval reconstructs the original safetensors file BIT-EXACTLY (the stored
header blob + decoded tensors in serialization order, verified against the
ingest-time file hash).

Parallel engine (paper §4.4.5 — the C++ pipeline, reproduced here with a
thread pool; sha256, zstd/zlib and numpy's XOR all release the GIL):

* **Ingest** is a three-stage pipeline per file. Stage 1 fans per-tensor
  sha256 hashing out across the pool. Stage 2 — the *decision loop* — runs
  serially in tensor order: dedup lookups, codec selection and
  ``tensor_locations`` registration are order-dependent, so they are never
  parallelized. Stage 3 fans the per-tensor encode jobs (XOR-delta,
  byte-plane split, entropy coding) back out across the pool.
* **Ordered-merge determinism rule:** workers may finish out of order, but
  records and frames are appended to the container strictly in tensor
  (serialization) order, and every frame is a pure function of
  (tensor bytes, base bytes, zstd level/threads). A container written with
  ``workers=N`` is therefore *bit-identical* to the serial ``workers=0``
  container — verified by test. Worker threads get their own zstd contexts
  (thread-local inside ``repro_torch.core.codecs.CodecRuntime``, each wrapped in
  an owner-thread assertion); compressor objects are not thread-safe and
  must never be shared mid-operation.
* **Array backend:** XOR-delta and byte-plane math routes through the
  ``ArrayBackend`` chosen at construction (``backend="torch"|"numpy"``).
  A batching backend (torch, over the CUDA kernels) makes ``_plan_loop`` defer the array stage
  of bitx/zipnn tensors into dtype-bucketed flushes — one fused kernel
  launch per bucket — and ``_decode_container`` merge whole containers in
  bucketed launches. The decision stage stays serial and the transforms are
  elementwise, so containers are bit-identical to the numpy path (verified
  by the backend-equivalence tests).
* **Base-map cache:** registering a base *primes* a ``_BaseTensorMap``
  (name → dtype/shape/hash + lazy mmap loader) from hashes already computed
  during that base's own ingest, so ingesting N fine-tunes of one base
  performs exactly ONE hash pass over the base (at its own ingest) instead
  of N+1. Re-registering a base invalidates the cached map.
* **Retrieval:** containers are memory-mapped (``BitXReader.open``) and
  cached in an LRU; decoded dependency tensors are cached in a byte-budgeted
  LRU so dedup/bitx resolution stops re-reading whole containers per tensor.
  ``_decode_container`` decodes records across the pool (order restored at
  the join).

Concurrency layer (this store is a *serving system*, not a single-caller
library — ``repro.serve.store_server`` builds directly on these pieces):

* **Cross-file pipelined ingest** (``ingest_many`` / ``ingest_repos``):
  stage A (whole-file sha256 + header parse) of upload N+1 runs on the pool
  while upload N encodes; stage B — the cross-file decision stage — runs
  strictly serially in submission order and owns ALL global dedup/lifecycle
  state, so the emitted containers are bit-identical to per-file serial
  ingest; stage C (merge + container write) is deferred to a dedicated
  writer thread. Hand-offs are bounded queues (``pipeline_depth``).
* **Publish epochs:** stage B registers the new version + index entry
  immediately (later decisions must see them) and marks the container path
  *pending*; any reader of that path blocks on the per-file publish event
  until stage C has the bytes on disk — nobody ever maps a torn container.
* **Process-pool entropy backend** (opt-in ``entropy_procs=N``): the zstd
  stage — where thread scaling is capped by the measured
  ``hardware_thread_ceiling`` — ships plane bytes to worker processes;
  frames are pure functions of (bytes, level, threads), so containers stay
  bit-identical. Broken/missing fork support degrades to threads.
* **Pin-counted readers:** the reader LRU stores pinned handles; eviction
  (overflow, gc, quarantine) closes the mmap deterministically when idle or
  at the last in-flight release — no fd accumulation under churn, and never
  a close under a concurrent decode.
* **Read gate + read generations:** retrievals hold a shared gate for their
  whole decode; ``gc()`` and fsck quarantine hold it exclusively, so a
  reader is never handed a reclaimed generation (snapshot isolation).
  ``read_gen`` increments on every visible mutation; the async serving
  layer keys its single-flight table and response caches by it.

Container lifecycle & GC (``repro_torch.core.lifecycle``):

* **Generations.** Containers are immutable versions ``key@gN``. Gen 0
  keeps the legacy ``containers/<key>.bitx`` path (v1 stores load
  unchanged); re-registering a key writes ``<key>@gN.bitx`` copy-on-write
  and never touches the superseded bytes. ``tensor_locations`` pins
  ``(key, gen, record idx)`` per tensor hash, so dedup records and BitX
  base references held by earlier dependants keep resolving against the
  generation they were ingested against — re-registering a base can no
  longer orphan its fine-tunes. ``file_dedup`` and near-dup index entries
  pin their target generation the same way.
* **Refcounts.** Every ingest records dependency edges (this container
  version → the versions its dedup/bitx records resolve into) in a
  ``ContainerLifecycle`` graph. ``delete_file``/``delete_repo`` drop index
  entries (anchors); ``gc()`` reclaims every version unreachable from the
  remaining anchors — a cascading refcount sweep — deletes the files,
  scrubs ``tensor_locations`` hashes that pointed into them, and reports
  live/reclaimed bytes (also surfaced in ``StoreStats`` / ``summary()``).
* **Near-identical re-ingest.** A file whose tensors all hash-match one
  existing container version in order (same tensors, different header
  metadata) is stored as a ``near_dup`` index entry — just the header blob
  plus a pinned reference — instead of a redundant container.
* **fsck.** ``fsck(repair=False)`` walks every live version and index
  entry: structural checks (magic/truncation), every tensor-dedup target
  and base reference must resolve to a live container frame (sha256
  spot-checks decode a sample per container), and every index ref must
  point at a live generation. ``repair=True`` re-pins dangling hashes to a
  surviving copy when one exists and quarantines corrupt containers
  (moved aside, graph node kept so dependants stay repairable).
* **Compaction & incremental GC.** After churn, payload tensors stay
  pinned inside superseded generations that gc cannot reclaim (some
  dependant still resolves into them). ``compact()`` rewrites exactly the
  still-referenced records — verbatim frame copies, so the BitX math and
  every byte are preserved — into a fresh ``.compact/pool@gN`` container,
  re-pins ``tensor_locations`` under one short exclusive gate hold, and
  retires the old generations entirely. ``gc(incremental=True)`` replaces
  the stop-the-world sweep with bounded steps (target
  ``max_pause_ms`` exclusive hold each, resumable cursor persisted in the
  v3 index) that interleave with ingest and serving. Both persist the
  index *before* unlinking retired files and write containers via
  temp-suffix + atomic rename, so a crash at any instant leaves only
  orphan debris that ``fsck(repair=True)`` removes — never a dangling
  index or a lost live tensor (proven by tests/test_crash_recovery.py).

This module is also the storage backend of the training framework: the
checkpoint manager (`repro.checkpoint`) ingests every checkpoint through a
``ZLLMStore``, so checkpoint chains dedup + delta-compress against their run's
first checkpoint exactly like fine-tuned models against a base.
"""

from __future__ import annotations

import base64
import bisect
import itertools
import json
import os
import queue
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque
from concurrent.futures import Future, ProcessPoolExecutor, ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import zstd_compat as zstd
from repro_torch.core.bitx import (TMP_SUFFIX, BitXReader, BitXWriter, get_backend)
from repro_torch.core.clustering import FamilyRegistry
from repro_torch.core.codecs import CodecRuntime, EncodeInput, get_codec, raw_or_stored
from repro_torch.core.dedup import FileDedup, TensorDedup, sha256_bytes, sha256_file
from repro_torch.core.lifecycle import ContainerLifecycle, FsckReport, make_vid
from repro_torch.formats.modelcard import parse_repo_metadata
from repro_torch.formats.safetensors import (STR_TO_DTYPE, SafetensorsFile,
                                       read_header_blob)

__all__ = ["ZLLMStore", "IngestResult", "IngestJob", "StoreStats", "COMPACT_KEY",
           "COMPACT_FAULT_POINTS", "GC_FAULT_POINTS"]


def _entropy_compress(level: int, threads: int, blobs: List[bytes]) -> List[bytes]:
    """Entropy-code ``blobs`` in a worker *process* (the opt-in
    ``entropy_procs`` backend for the stage where thread scaling is capped by
    the GIL-adjacent hardware ceiling). Must stay a module-level function so
    ``ProcessPoolExecutor`` can pickle it. Frames are a pure function of
    (bytes, level, threads, backend), so routing the entropy stage through a
    child process cannot change the emitted container bytes."""
    c = zstd.ZstdCompressor(level=level, threads=threads)
    return [c.compress(b) for b in blobs]

# v1 = no generations; v2 adds lifecycle + pinned gens; v3 adds the
# incremental-GC cursor + compaction state (compact-pool versions travel in
# the v2 lifecycle section unchanged — v3 is structurally v2 plus optional
# keys, and v2/v1 indexes load with the new fields defaulted); v4 adds
# delete tombstones inside the lifecycle blob (replica anti-entropy needs
# "deleted" to be distinguishable from "never seen" — again optional keys,
# so v1-v3 indexes load with tombstones defaulted empty)
INDEX_FORMAT = 4

# Synthetic container key owned by compact(): rewritten survivor records
# land in ``containers/.compact/pool@gN.bitx`` versions. The leading dot
# keeps it out of any plausible ``repo_id/filename`` namespace; compact-pool
# versions have no file_index entry and stay alive purely through dependant
# edges (gc reclaims them once the last dependant dies).
COMPACT_KEY = ".compact/pool"

# Fault points the crash-injection harness (tests/test_crash_recovery.py)
# may kill compact()/gc() at, via ``store.fault_hook``. The writer.* points
# fire inside BitXWriter.write (temp write / atomic rename).
COMPACT_FAULT_POINTS = ("compact.begin", "writer.before_write",
                        "writer.after_temp", "writer.after_rename",
                        "compact.after_commit", "compact.after_index",
                        "compact.after_unlink")
GC_FAULT_POINTS = ("gc.step.begin", "gc.step.after_commit",
                   "gc.step.after_index", "gc.step.after_unlink")

# Tombstones older than this are pruned by gc(): by then anti-entropy has
# converged every replica many times over, and an eternal marker would make
# the index grow monotonically with delete churn.
TOMBSTONE_TTL_S = 30 * 24 * 3600.0


@dataclass
class AutoCompactPolicy:
    """When should gc() chain into compact() on its own?

    Two independent triggers, evaluated after every completed gc sweep (the
    watermark math itself is :meth:`should_compact`, a pure function so the
    thresholds are unit-testable without building a store):

    * a superseded-bytes watermark: compact once pinned-but-superseded
      generations hold at least ``min_superseded_bytes`` AND at least
      ``superseded_ratio`` of the store's live bytes — small stores don't
      churn containers for kilobytes, big stores don't wait forever;
    * a sweep counter: ``every_n_gc`` completed gc runs since the last
      compaction (None disables), a coarse backstop for workloads whose
      superseded bytes grow too slowly to cross the watermark.
    """

    min_superseded_bytes: int = 64 << 20
    superseded_ratio: float = 0.25
    every_n_gc: Optional[int] = None

    def should_compact(self, superseded_bytes: int, live_bytes: int,
                       gc_since_compact: int) -> bool:
        if self.every_n_gc is not None and gc_since_compact >= self.every_n_gc:
            return True
        if superseded_bytes < self.min_superseded_bytes:
            return False
        return superseded_bytes >= self.superseded_ratio * max(live_bytes, 1)

_FLOAT_TAGS = {"F64", "F32", "F16", "BF16"}

# Base dtypes the quantized (dtype-crossing) delta lane can predict from: an
# int8 repack of a float family base re-quantizes the base as its prediction
# and ships only the XOR residual (codec "bitxq"). BF16 expands to float32
# exactly via a 16-bit shift; F16/F32 widen losslessly.
_QDELTA_BASE_TAGS = {"BF16", "F32", "F16"}

# Tensors below this size are hashed/encoded inline on the decision thread:
# pool dispatch costs more than the work itself (and sha256 only releases
# the GIL above ~2 KB anyway). Big tensors dominate bytes, so this trims
# per-task overhead without hurting parallel coverage.
_PARALLEL_MIN_BYTES = 64 << 10

# Device-batched encode (backends with ``supports_batching``): the plan loop
# accumulates bitx/zipnn tensors and flushes once a batch holds this many raw
# bytes, bounding the host copies of the concatenated bit views that feed the
# fused kernel launches.
_DEVICE_BATCH_MAX_BYTES = 256 << 20


@dataclass
class IngestResult:
    repo_id: str
    filename: str
    raw_bytes: int
    stored_bytes: int
    file_dedup_hit: bool = False
    near_dup_hit: bool = False       # all tensors matched one container version
    base_id: Optional[str] = None
    base_source: str = ""            # "metadata" | "bitdistance" | ""
    n_tensors: int = 0
    n_dedup: int = 0
    n_bitx: int = 0
    n_bitxq: int = 0
    n_zipnn: int = 0
    n_raw: int = 0
    ingest_seconds: float = 0.0

    @property
    def reduction(self) -> float:
        return 1.0 - self.stored_bytes / self.raw_bytes if self.raw_bytes else 0.0


@dataclass
class IngestJob:
    """Bookkeeping for one spooled-ingest job (the server's remote write
    path): a batch of uploads queued for the background ingest worker.
    States advance ``queued → running → done|failed``; terminal jobs keep
    their per-file results (or the error) for ``/admin/jobs``."""

    job_id: str
    kind: str    # "files" (ingest_many specs) | "repo" (dirs) | "repair" (thunk)
    specs: List[Tuple]
    cleanup: bool = False        # delete spooled source files when finished
    state: str = "queued"
    error: str = ""
    results: List[Dict] = field(default_factory=list)
    enqueued_at: float = field(default_factory=time.time)
    started_at: float = 0.0
    finished_at: float = 0.0

    def to_json(self) -> Dict:
        return {"job_id": self.job_id, "kind": self.kind, "state": self.state,
                "n_uploads": len(self.specs), "error": self.error,
                "results": self.results,
                "enqueued_at": round(self.enqueued_at, 3),
                "started_at": round(self.started_at, 3),
                "finished_at": round(self.finished_at, 3)}


@dataclass
class StoreStats:
    raw_bytes: int = 0
    stored_bytes: int = 0
    n_files: int = 0
    n_file_dedup: int = 0
    n_near_dup: int = 0
    ingest_seconds: float = 0.0
    # lifecycle accounting: bytes currently on disk in live container
    # versions vs bytes reclaimed by gc() over the store's lifetime
    live_bytes: int = 0
    reclaimed_bytes: int = 0
    n_deleted: int = 0
    # compaction + incremental-GC accounting: net bytes freed by compact()
    # (retired superseded generations minus the rewritten survivor bytes)
    # and the longest exclusive read-gate hold of any incremental gc step
    compaction_reclaimed_bytes: int = 0
    compact_runs: int = 0
    gc_max_pause_ms: float = 0.0
    # compactions fired by an AutoCompactPolicy watermark (subset of
    # compact_runs): the soak asserts the trigger actually fires
    auto_compact_runs: int = 0

    @property
    def reduction_ratio(self) -> float:
        return 1.0 - self.stored_bytes / self.raw_bytes if self.raw_bytes else 0.0

    @property
    def ingest_throughput_mbps(self) -> float:
        return (self.raw_bytes / 2**20) / self.ingest_seconds if self.ingest_seconds else 0.0


class _ReadGate:
    """Writer-priority read/write gate + monotonic read generation.

    Retrievals hold the gate *shared* for their whole decode; destructive
    admin operations (``gc()``, fsck quarantine) hold it *exclusive*, so a
    reader is never handed a reclaimed generation mid-decode — the store-side
    half of the serving layer's snapshot isolation. ``read_gen`` increments
    on every visible mutation (ingest commit, delete, each exclusive
    section); the async engine keys its single-flight table and response
    cache by it, so a request issued after a mutation never coalesces onto a
    stale in-flight decode.

    Writer priority: arriving readers queue behind a waiting writer, so a
    steady read load cannot starve ``gc()``. Do not nest ``read()`` inside
    ``read()`` on one thread — a pending writer between the two acquisitions
    would deadlock (entry points below never nest)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self.read_gen = 0

    @contextmanager
    def read(self):
        with self._cv:
            while self._writer or self._writers_waiting:
                self._cv.wait()
            self._readers += 1
            gen = self.read_gen
        try:
            yield gen
        finally:
            with self._cv:
                self._readers -= 1
                if not self._readers:
                    self._cv.notify_all()

    @contextmanager
    def write(self):
        with self._cv:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cv.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1
                if not self._writer:
                    # interrupted (e.g. KeyboardInterrupt) while waiting: a
                    # leaked waiting count would block readers forever
                    self._cv.notify_all()
        try:
            yield
        finally:
            with self._cv:
                self._writer = False
                self.read_gen += 1
                self._cv.notify_all()

    def bump(self) -> None:
        """Advance ``read_gen`` for a non-destructive mutation (ingest commit,
        delete): existing readers are unaffected (copy-on-write generations),
        but caches keyed by read_gen must stop serving the old view."""
        with self._cv:
            self.read_gen += 1


class _ReaderHandle:
    """Pin-counted cache entry for one mmap'd :class:`BitXReader`.

    Eviction (LRU overflow, gc, quarantine) *retires* the handle: the map is
    closed immediately when unpinned, else deterministically by the last
    ``release`` — no reliance on GC finalizers, so container fds cannot
    accumulate under churn (the v2-era leak), and a reader mid-decode on
    another thread is never yanked."""

    __slots__ = ("reader", "pins", "retired")

    def __init__(self, reader: BitXReader):
        self.reader = reader
        self.pins = 0
        self.retired = False


class _LRUCache:
    """Tiny LRU with an item cap and an optional byte budget. NOT thread-safe;
    callers hold the store's cache lock."""

    def __init__(self, max_items: int = 16, max_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[Any], None]] = None):
        self.max_items = max_items
        self.max_bytes = max_bytes
        self.on_evict = on_evict
        self._od: "OrderedDict[Any, Tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        ent = self._od.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return ent[0]

    def put(self, key, value, nbytes: int = 0):
        if key in self._od:
            self._bytes -= self._od.pop(key)[1]
        self._od[key] = (value, nbytes)
        self._bytes += nbytes
        while len(self._od) > self.max_items or (
                self.max_bytes is not None and self._bytes > self.max_bytes
                and len(self._od) > 1):
            self._evict_oldest()

    def pop(self, key):
        ent = self._od.pop(key, None)
        if ent is not None:
            self._bytes -= ent[1]
            if self.on_evict:
                self.on_evict(ent[0])

    def discard(self, key):
        """Drop an entry WITHOUT firing ``on_evict`` — for callers
        retiring dead entries whose eviction side effect (e.g. a disk
        spill) must not run."""
        ent = self._od.pop(key, None)
        if ent is not None:
            self._bytes -= ent[1]

    def keys(self):
        return list(self._od)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def values(self):
        return [v for v, _ in self._od.values()]

    def clear(self):
        while self._od:
            self._evict_oldest()

    def _evict_oldest(self):
        _, (value, nbytes) = self._od.popitem(last=False)
        self._bytes -= nbytes
        if self.on_evict:
            self.on_evict(value)

    def __len__(self):
        return len(self._od)


class _BaseTensorMap:
    """Cached per-base tensor map: name -> (dtype_str, shape, loader, hash).

    ``entries`` carry the hashes, so a map primed at base-ingest time costs
    zero extra hash passes. The backing safetensors file is opened lazily
    (and at most once — guarded by a lock, since encode workers resolve base
    tensors concurrently) the first time any loader fires.
    """

    def __init__(self, path: str, entries: List[Tuple[str, str, Tuple[int, ...], str]]):
        self.path = path
        self.entries = entries
        self._lock = threading.Lock()
        self._sf: Optional[SafetensorsFile] = None
        self.tensors: Dict[str, Tuple] = {
            name: (dtype_str, tuple(shape), self._loader(name), thash)
            for name, dtype_str, shape, thash in entries
        }

    def _loader(self, name: str):
        def load(name=name) -> np.ndarray:
            return self._open().tensor(name)
        return load

    def _open(self) -> SafetensorsFile:
        with self._lock:
            if self._sf is None:
                self._sf = SafetensorsFile(self.path)
                self._sf.advise("random")  # encode workers resolve out of order
            return self._sf

    def close(self):
        with self._lock:
            if self._sf is not None:
                self._sf.close()
                self._sf = None


class _PreparedUpload:
    """Stage-A output of the cross-file pipeline: whole-file hash, open
    safetensors map, header blob. Pure reads only — no store state is
    touched, so preparation of upload N+1 can run on a worker thread while
    upload N encodes."""

    __slots__ = ("path", "repo_id", "filename", "key", "declared_base",
                 "raw_size", "fhash", "sf", "header_blob", "t0", "error")

    def __init__(self, path: str, repo_id: str, filename: str,
                 declared_base: Optional[str]):
        self.path = path
        self.repo_id = repo_id
        self.filename = filename
        self.key = f"{repo_id}/{filename}"
        self.declared_base = declared_base
        self.t0 = time.perf_counter()
        self.raw_size = 0
        self.fhash = ""
        self.sf: Optional[SafetensorsFile] = None
        self.header_blob = b""
        self.error: Optional[BaseException] = None

    def close(self) -> None:
        if self.sf is not None:
            self.sf.close()
            self.sf = None


@dataclass
class _PendingWrite:
    """A container whose decisions are committed (stage B) but whose
    merge+write is still in flight (stage C on the writer thread).
    ``prev_rec`` snapshots the index record this upload replaced (a
    re-registration), so a failed write can restore it instead of leaving
    the key unretrievable."""

    pf: _PreparedUpload
    res: IngestResult
    writer: BitXWriter
    plan: List
    cpath: str
    key: str
    gen: int
    prev_rec: Optional[Dict] = None
    future: Optional[Future] = None


class ZLLMStore:
    """Content-addressed zLLM store rooted at a directory.

    ``workers`` selects the engine: ``0``/``1`` runs the serial reference
    path; ``N > 1`` runs the pipelined thread-pool engine (bit-identical
    containers, see the module docstring's ordered-merge rule).
    """

    def __init__(self, root: str, *, threshold: float = 4.0, zstd_level: int = 3,
                 sample_elems: int = 65536, use_bitx: bool = True,
                 use_tensor_dedup: bool = True, workers: int = 0,
                 zstd_threads: int = 0, tensor_cache_bytes: int = 256 << 20,
                 reader_cache_size: int = 16, pipeline_depth: int = 2,
                 entropy_procs: int = 0,
                 auto_compact: Optional[AutoCompactPolicy] = None,
                 backend="torch"):
        self.root = root
        os.makedirs(os.path.join(root, "containers"), exist_ok=True)
        self.zstd_level = zstd_level
        self.zstd_threads = zstd_threads
        # array backend for XOR-delta / byte-plane math ("torch", "numpy",
        # or an ArrayBackend instance); one runtime shared by every
        # encode/decode site so the zstd contexts stay per-thread in one place
        self.backend = get_backend(backend)
        self._codec_runtime = CodecRuntime(level=zstd_level, threads=zstd_threads,
                                           backend=self.backend)
        self.use_bitx = use_bitx
        self.use_tensor_dedup = use_tensor_dedup
        self.workers = max(0, int(workers))
        # cross-file pipelining: how many uploads ahead of the decision stage
        # stage A (whole-file sha256 + header parse) may run, and how many
        # deferred container writes may be in flight (the bounded hand-off)
        self.pipeline_depth = max(0, int(pipeline_depth))
        # opt-in process-pool entropy backend (0 = entropy on worker threads)
        self.entropy_procs = max(0, int(entropy_procs))
        self.file_dedup = FileDedup()
        self.tensor_dedup = TensorDedup()
        self.families = FamilyRegistry(threshold=threshold, sample_elems=sample_elems)
        self.stats = StoreStats()
        # indexes
        self.file_index: Dict[str, Dict] = {}        # "repo/file" -> record
        self.file_hash_to_key: Dict[str, str] = {}   # file sha256 -> first "repo/file"
        # derived reverse map (rebuilt on load, never persisted): file sha256
        # -> every key serving those bytes, for O(1) alias repointing when a
        # key is deleted or re-registered
        self._keys_by_file_hash: Dict[str, set] = {}
        # tensor hash -> (key, generation, record idx): the PINNED container
        # version holding this tensor's payload (survives re-registration)
        self.tensor_locations: Dict[str, Tuple[str, int, int]] = {}
        self.lifecycle = ContainerLifecycle()
        self.base_paths: Dict[str, str] = {}         # base_id -> source path (for alignment)
        self.base_key_of: Dict[str, str] = {}        # base_id -> "repo/file" container key
        self.metadata_base: Dict[str, str] = {}      # repo_id -> declared base id
        self.results: List[IngestResult] = []
        # caches
        self._pool: Optional[ThreadPoolExecutor] = None
        self._writer_pool: Optional[ThreadPoolExecutor] = None
        self._entropy_pool: Optional[ProcessPoolExecutor] = None
        self._entropy_failed = False
        self._cache_lock = threading.RLock()
        # readers are pin-counted handles: eviction retires a handle and the
        # mmap closes deterministically once the last in-flight decode
        # releases it (see _ReaderHandle) — never mid-decode, never left to GC
        self._reader_cache = _LRUCache(reader_cache_size,
                                       on_evict=self._retire_reader)
        self._tensor_cache = _LRUCache(max_items=4096, max_bytes=tensor_cache_bytes)
        self._base_maps: Dict[str, _BaseTensorMap] = {}
        # parsed name->(idx, dtype, shape) maps of near-dup headers, keyed by
        # the entry's pinned target + content hash (tensor-granular serving
        # must not re-parse the header blob per request)
        self._near_dup_name_cache = _LRUCache(64)
        self.base_map_stats = {"hits": 0, "misses": 0, "primed": 0, "invalidations": 0}
        # publish epochs: container paths whose deferred write has not hit
        # disk yet; readers (near-dup probe, concurrent retrieval) block on
        # the event instead of opening a half-written file
        self._publish_lock = threading.Lock()
        self._pending_publish: Dict[str, threading.Event] = {}
        # read/write gate + read generation (serving snapshot isolation)
        self._gate = _ReadGate()
        # admin mutex: ingest batches, deletes, gc and fsck are mutually
        # exclusive (they all mutate index/lifecycle/pin state); retrievals
        # never take it. Reentrant for delete_repo -> delete_file. Lock
        # order is always admin lock THEN gate — never the reverse.
        self._admin_lock = threading.RLock()
        # incremental GC: resumable sweep cursor (last retired vid; persisted
        # in the v3 index so a restarted store continues where it left off)
        self._gc_cursor = ""
        # hinted-handoff log (replication): appends/rewrites of
        # ``<root>/hints.jsonl`` serialize on this lock, independent of the
        # admin lock — recording a hint must not wait on a running gc
        self._hints_lock = threading.Lock()
        self._hint_seq = 0
        # automatic compaction: None keeps compact() admin-only (the
        # pre-existing behavior); a policy makes every completed gc sweep
        # evaluate the superseded-bytes watermark and chain into compact()
        self.auto_compact = auto_compact
        self._gc_since_compact = 0
        # residual superseded bytes a converged compact() could not
        # reclaim (bitx bases, cost-gated moves): the watermark measures
        # GROWTH above this floor, or it would re-fire every sweep
        self._compact_floor = 0
        # spooled-ingest job queue (the server's remote write path): one
        # background worker drains jobs serially — ingest is single-caller
        # by contract, and every job takes the admin lock anyway, so a
        # second worker would only contend
        self._job_cv = threading.Condition()
        self._jobs: "OrderedDict[str, IngestJob]" = OrderedDict()
        self._job_queue: "queue.Queue[Optional[IngestJob]]" = queue.Queue()
        self._job_thread: Optional[threading.Thread] = None
        self._job_seq = itertools.count(1)
        # crash-injection hook: called with a fault-point name (see
        # COMPACT_FAULT_POINTS / GC_FAULT_POINTS) at each crash-consistency
        # boundary of compact()/gc(); the recovery harness raises from it to
        # simulate a kill. Never set in production.
        self.fault_hook: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def _executor(self) -> Optional[ThreadPoolExecutor]:
        if self.workers <= 1:
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                            thread_name_prefix="zllm")
        return self._pool

    def _writer_executor(self) -> ThreadPoolExecutor:
        """Single dedicated thread for deferred container merges/writes. It
        blocks on encode futures, so it must NOT share the main pool: with
        every pool slot occupied by a blocked merge, the encode jobs they
        wait on could never run."""
        if self._writer_pool is None:
            self._writer_pool = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="zllm-write")
        return self._writer_pool

    def _entropy_executor(self) -> Optional[ProcessPoolExecutor]:
        """Opt-in process pool for the entropy stage. Gated: sandboxes
        without working fork/spawn fall back to in-thread compression (the
        containers stay bit-identical either way)."""
        if self.entropy_procs <= 0 or self._entropy_failed:
            return None
        if self._entropy_pool is None:
            pool = None
            try:
                pool = ProcessPoolExecutor(max_workers=self.entropy_procs)
                # probe: surface broken process spawning here, not mid-encode
                pool.submit(_entropy_compress, 1, 0, [b""]).result(timeout=60)
                self._entropy_pool = pool
            except Exception:
                self._entropy_failed = True
                if pool is not None:  # reap any workers the probe spawned
                    pool.shutdown(wait=False, cancel_futures=True)
                return None
        return self._entropy_pool

    def close(self):
        """Shut the worker pools down and drop mmap-backed caches. Must not
        race in-flight retrievals (shut down your own callers first)."""
        if self._job_thread is not None:
            self._job_queue.put(None)  # sentinel: drain queued jobs, then exit
            self._job_thread.join(timeout=120)
            self._job_thread = None
        for attr in ("_pool", "_writer_pool", "_entropy_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=True)
                setattr(self, attr, None)
        with self._cache_lock:
            self._reader_cache.clear()   # on_evict retires + closes handles
            self._tensor_cache.clear()
        for bm in {id(m): m for m in self._base_maps.values()}.values():
            bm.close()
        self._base_maps.clear()

    def __enter__(self) -> "ZLLMStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------
    def ingest_repo(self, repo_dir: str, repo_id: Optional[str] = None) -> List[IngestResult]:
        return self.ingest_repos([(repo_dir, repo_id)])

    def ingest_repos(self, repo_dirs: Iterable) -> List[IngestResult]:
        """Pipelined multi-repo ingest: every shard of every repo flows
        through one bounded cross-file pipeline, so FileDedup hashing of
        upload N+1 overlaps the tensor encode of upload N even across repo
        boundaries. ``repo_dirs`` items are ``repo_dir`` or
        ``(repo_dir, repo_id)``."""
        specs = []
        for item in repo_dirs:
            repo_dir, repo_id = item if isinstance(item, tuple) else (item, None)
            repo_id = repo_id or os.path.basename(os.path.normpath(repo_dir))
            meta = parse_repo_metadata(repo_dir)
            if meta.get("base_model"):
                self.metadata_base[repo_id] = meta["base_model"]
            for fname in sorted(os.listdir(repo_dir)):
                if fname.endswith(".safetensors"):
                    specs.append((os.path.join(repo_dir, fname), repo_id, fname, None))
        return self.ingest_many(specs)

    def ingest_file(self, path: str, repo_id: str, filename: Optional[str] = None,
                    declared_base: Optional[str] = None) -> IngestResult:
        return self.ingest_many([(path, repo_id, filename, declared_base)])[0]

    def ingest_many(self, uploads: Iterable, prefetch: Optional[int] = None) -> List[IngestResult]:
        """Cross-file pipelined ingest over a batch of uploads.

        ``uploads`` items are ``(path, repo_id)``, ``(path, repo_id,
        filename)`` or ``(path, repo_id, filename, declared_base)``.

        Three stages per upload, hand-offs bounded by ``prefetch`` (default
        ``pipeline_depth``):

        * **Stage A (pool):** whole-file sha256 + safetensors open + header
          read — pure reads, so upload N+1's FileDedup hashing overlaps
          upload N's tensor encode.
        * **Stage B (this thread, strictly in submission order):** the
          decision stage. It owns ALL global state — dedup indexes, family
          registry, lifecycle graph, tensor pins — so pipelined decisions
          are literally the serial decisions, and the containers stay
          bit-identical to per-file serial ingest (tested). The new version
          and index entry are published here (per-file publish epoch) while
          the bytes are still being encoded; readers of the not-yet-written
          path block on the epoch instead of seeing a torn file.
        * **Stage C (writer thread):** await the encode futures, merge in
          tensor order, write the container, release the publish epoch.

        ``workers <= 1`` or ``prefetch == 0`` degrades to the serial
        reference path (all three stages inline per file).

        A failed write rolls back its own decisions and poisons the rest of
        the batch (later uploads may have dedup'd against the failed
        container); committed earlier uploads are kept. Ingest is
        single-caller: run one ingest batch at a time (concurrent *serving*
        is fine — that is what the read gate is for). Admin operations —
        gc, delete, fsck — take the same admin lock, so calling them from
        another thread mid-batch is safe: they wait for the batch.
        """
        with self._admin_lock:
            return self._ingest_many_locked(uploads, prefetch)

    def _ingest_many_locked(self, uploads: Iterable,
                            prefetch: Optional[int]) -> List[IngestResult]:
        specs = []
        for u in uploads:
            path, repo_id, filename, declared = (tuple(u) + (None, None))[:4]
            specs.append((path, repo_id, filename or os.path.basename(path), declared))
        depth = self.pipeline_depth if prefetch is None else max(0, int(prefetch))
        pool = self._executor()
        # a batch of one has nothing to overlap with: run it inline (the
        # serial latency path) instead of paying the pool/writer-thread handoff
        pipelined = pool is not None and depth > 0 and len(specs) > 1
        out: List[IngestResult] = []
        inflight: "deque[_PendingWrite]" = deque()
        ahead: "deque[Future]" = deque()
        # (key, res) of whole-file-dedup / near-dup entries decided in this
        # batch: if the batch fails, any of these pinned to a rolled-back
        # container must be undone too (their bytes exist nowhere else)
        ref_entries: List[Tuple[str, IngestResult]] = []
        spec_iter = iter(specs)
        batch_t0 = time.perf_counter()

        def top_up():
            while len(ahead) <= depth:
                spec = next(spec_iter, None)
                if spec is None:
                    break
                ahead.append(pool.submit(self._prepare_upload, *spec))

        try:
            if pipelined:
                top_up()
                while ahead:
                    pf = ahead.popleft().result()
                    top_up()  # keep stage A ``depth`` uploads ahead
                    res, pw = self._ingest_decide(pf)
                    out.append(res)
                    self.results.append(res)
                    if pw is None:
                        if res.file_dedup_hit or res.near_dup_hit:
                            ref_entries.append((f"{res.repo_id}/{res.filename}",
                                                res))
                        self._account_stats(res)
                        continue
                    pw.future = self._writer_executor().submit(
                        self._finish_container, pw)
                    inflight.append(pw)
                    while inflight and inflight[0].future.done():
                        self._commit_write(inflight.popleft())
                    while len(inflight) > depth:  # bound in-flight writes
                        self._commit_write(inflight.popleft())
            else:
                for spec in specs:
                    pf = self._prepare_upload(*spec)
                    res, pw = self._ingest_decide(pf)
                    out.append(res)
                    self.results.append(res)
                    if pw is None:
                        self._account_stats(res)
                    else:
                        self._commit_write(pw)
            while inflight:
                self._commit_write(inflight.popleft())
        except BaseException:
            # Fail fast but leave the store consistent: everything decided
            # after the failure may have resolved against the failed
            # container, so roll the whole in-flight suffix back (even
            # writes that landed — they become unreachable and unsound),
            # then undo dedup/near-dup entries whose pinned target just got
            # rolled back, and release prefetched file handles.
            while inflight:
                pw = inflight.popleft()
                if pw.future is not None:
                    try:
                        pw.future.result()
                    except BaseException:
                        pass
                self._rollback_failed_write(pw)
            for key, res in ref_entries:
                self._rollback_ref_entry(key, res)
            while ahead:
                try:
                    ahead.popleft().result().close()
                except BaseException:
                    pass
            raise
        finally:
            # batch wall-clock, not the sum of (overlapping) per-file times
            self.stats.ingest_seconds += time.perf_counter() - batch_t0
        return out

    def _prepare_upload(self, path: str, repo_id: str, filename: str,
                        declared_base: Optional[str]) -> "_PreparedUpload":
        """Stage A: pure reads only (no store state) — safe on any worker."""
        pf = _PreparedUpload(path, repo_id, filename, declared_base)
        try:
            pf.raw_size = os.path.getsize(path)
            pf.fhash, _ = sha256_file(path)
            pf.sf = SafetensorsFile(path)
            pf.sf.advise("sequential")  # ingest walks tensors in order
            pf.header_blob = self._read_header_blob(path)
        except BaseException as e:
            pf.close()
            pf.error = e
        return pf

    def _ingest_decide(self, pf: "_PreparedUpload") -> Tuple[IngestResult, Optional["_PendingWrite"]]:
        """Stage B: the serial decision stage (see :meth:`ingest_many`).
        Returns ``(result, pending_write)``; the pending write is ``None``
        when the upload fully resolved as a whole-file dup or near-dup."""
        if pf.error is not None:
            raise pf.error
        key, fhash, raw_size = pf.key, pf.fhash, pf.raw_size

        # ① FileDedup (hash computed in stage A, registered here, in order)
        is_new_file = self.file_dedup.observe(fhash, raw_size, key)
        ref = self.file_hash_to_key.get(fhash)
        if not is_new_file and ref is not None and ref in self.file_index:
            pf.close()
            res = IngestResult(pf.repo_id, pf.filename, raw_size, 0,
                               file_dedup_hit=True,
                               ingest_seconds=time.perf_counter() - pf.t0)
            if ref != key:
                self._set_index_entry(key, self._pinned_ref(ref, fhash, raw_size))
            # ref == key: identical content re-ingested under its own key —
            # keep the existing container record (a self-referencing dedup
            # record would send retrieval into infinite recursion)
            self.stats.n_file_dedup += 1
            return res, None
        self.file_hash_to_key[fhash] = key

        res = IngestResult(pf.repo_id, pf.filename, raw_size, 0)
        entries: List[Tuple[str, str, Tuple[int, ...], str]] = []
        sf = pf.sf
        gen: Optional[int] = None
        pw: Optional[_PendingWrite] = None
        try:
            get_hash = self._hash_stage(sf)
            # near-identical re-ingest (same tensors, different header
            # metadata): store the header + a pinned reference, no container.
            # The probe awaits only the first hash unless a candidate matches,
            # so the hash/encode overlap of the parallel engine is preserved.
            near = self._near_dup_probe(sf, get_hash)
            if near is not None:
                res = self._ingest_near_dup(res, sf, key, fhash, raw_size,
                                            pf.header_blob, near, pf.t0)
                pf.close()  # a full probe match awaited every tensor hash
                return res, None
            # ③a/③b family resolution (before encoding, so BitX knows its base)
            base_id, base_source, base_tensors = self._elect_base(pf)
            res.base_id, res.base_source = base_id, base_source
            gen = self.lifecycle.next_generation(key)
            writer = BitXWriter(level=self.zstd_level, threads=self.zstd_threads,
                                backend=self.backend)
            plan = self._plan_tensors(sf, writer, res, key, gen, base_tensors,
                                      entries, get_hash)
            writer.file_metadata.update({
                "repo_id": pf.repo_id, "filename": pf.filename, "file_hash": fhash,
                "base_id": base_id or "", "raw_size": raw_size,
                "header_blob_z": base64.b64encode(zlib.compress(pf.header_blob)).decode(),
            })
            cpath = self._container_path(key, gen)
            pw = _PendingWrite(pf, res, writer, plan, cpath, key, gen,
                               prev_rec=self.file_index.get(key))
            # Publish protocol: the version + index entry become visible NOW
            # so later decisions dedup/pin against this upload exactly as in
            # serial mode, while readers block on the publish epoch until the
            # bytes are actually on disk (size 0 is fixed up at commit).
            self.lifecycle.register_version(key, gen, cpath, 0)
            self._mark_pending(cpath)
            self._set_index_entry(key, {"kind": "container", "path": cpath, "gen": gen,
                                        "file_hash": fhash, "raw_size": raw_size,
                                        "base_id": base_id or ""})
            # register as a family base iff stored standalone (no base of its own)
            if base_id is None:
                self.families.register(pf.repo_id, pf.path)
                self._register_base(pf.repo_id, key, pf.path, entries)
            return res, pw
        except BaseException:
            # Stage B failed (truncated source, unreadable base, ...): undo
            # whatever this upload published. With a _PendingWrite built, the
            # full write-rollback applies (index entry, version, pins, base
            # bindings, publish epoch); before that, only the tensor pins of
            # the planning loop can exist — scrub them so a later ingest can
            # never write a dedup record against a container that was never
            # registered. The source mmap is released either way (a closed fd
            # does not invalidate views still held by in-flight encode jobs).
            if pw is not None:
                self._rollback_failed_write(pw)
            else:
                # the whole-file hash registration above must not survive
                # either: a later identical upload would false-dedup against
                # this key's OLD generation (different bytes)
                self._release_file_hash(key, fhash)
                if gen is not None:
                    self._scrub_tensor_pins(key, gen)
            pf.close()
            raise

    def _scrub_tensor_pins(self, key: str, gen: int) -> int:
        """Drop every tensor-pool pin into container version (key, gen).
        Called exactly when a generation dies outside gc — failed-write
        rollback, stage-B rollback, quarantine — so no future ingest can
        dedup against payloads that are gone (gc has its own multi-version
        sweep)."""
        stale = [h for h, (k, g, _) in self.tensor_locations.items()
                 if k == key and g == gen]
        for h in stale:
            del self.tensor_locations[h]
            self.tensor_dedup.forget(h)
        return len(stale)

    def _finish_container(self, pw: "_PendingWrite") -> int:
        """Stage C: await the encode futures, merge strictly in tensor order,
        write the container, release the publish epoch. Runs inline (serial)
        or on the writer thread (pipelined); the bytes are identical."""
        try:
            self._merge_plan(pw.writer, pw.plan)
            os.makedirs(os.path.dirname(pw.cpath), exist_ok=True)
            stored = pw.writer.write(pw.cpath)
        except BaseException:
            # drain the remaining encode futures before the finally closes
            # the source mmap (mirrors _plan_tensors' stage-B drain)
            for _, _, _, _, payload in pw.plan:
                if isinstance(payload, Future) and not payload.cancel():
                    payload.exception()  # wait + mark retrieved
            raise
        finally:
            pw.pf.close()
            # unblock epoch waiters even on failure: they fail at open
            # instead of hanging, and _commit_write rolls the decisions back
            self._publish(pw.cpath)
        with self._cache_lock:
            self._reader_cache.pop(pw.cpath)  # generation paths are never
            # reused, but drop any stale mmap defensively
        return stored

    def _commit_write(self, pw: "_PendingWrite") -> None:
        """Harvest one deferred write in submission order: fix up sizes and
        account on success, roll the decisions back on failure."""
        try:
            stored = (pw.future.result() if pw.future is not None
                      else self._finish_container(pw))
        except BaseException:
            self._rollback_failed_write(pw)
            raise
        pw.res.stored_bytes = stored
        pw.res.ingest_seconds = time.perf_counter() - pw.pf.t0
        self.lifecycle.set_nbytes(pw.key, pw.gen, stored)
        self._account_stats(pw.res)

    def _rollback_failed_write(self, pw: "_PendingWrite") -> None:
        """Undo stage-B decisions for a container that never (soundly) made
        it to disk: index entry, lifecycle version, tensor pins, base/family
        registration, publish epoch, the on-disk file if any, and the
        result row. A re-registration restores the PREVIOUS index record —
        the old generation is still on disk (copy-on-write) and must stay
        retrievable; only its base/family bindings are conservatively
        dropped (new fine-tunes store standalone until the next successful
        base registration — a space cost, never a correctness one)."""
        rec = self.file_index.get(pw.key)
        if (rec is not None and rec.get("kind") == "container"
                and rec.get("gen") == pw.gen):
            if pw.prev_rec is not None and self._rec_resolvable(pw.key,
                                                               pw.prev_rec):
                # re-point the key at the record it had before this upload;
                # _set_index_entry releases the failed upload's file hash
                self._set_index_entry(pw.key, pw.prev_rec)
                prev_hash = pw.prev_rec.get("file_hash")
                if prev_hash:  # re-arm whole-file dedup for the old bytes
                    self.file_hash_to_key.setdefault(prev_hash, pw.key)
                    self.file_dedup.index.setdefault(prev_hash, pw.key)
            else:
                # no previous record, or it pins a generation that was
                # itself rolled back earlier in this batch (the key was
                # ingested twice) — restoring it would dangle
                self.file_index.pop(pw.key, None)
                self._release_file_hash(pw.key, pw.pf.fhash)
        self.lifecycle.discard(pw.key, pw.gen)
        self._scrub_tensor_pins(pw.key, pw.gen)
        self._unbind_base(pw.key, pw.pf.repo_id)
        self._publish(pw.cpath)  # no-op unless pending: waiters must not hang
        with self._cache_lock:
            # a reader may have slipped in between epoch release and this
            # rollback; retire it so the deleted file's mmap/fd is dropped
            self._reader_cache.pop(pw.cpath)
        for p in (pw.cpath, pw.cpath + TMP_SUFFIX):
            try:
                os.remove(p)
            except OSError:
                pass
        try:
            self.results.remove(pw.res)
        except ValueError:
            pass

    def _rec_resolvable(self, key: str, rec: Dict) -> bool:
        """Does this index record point at a live container version?"""
        if rec.get("kind") == "container":
            return self.lifecycle.exists(key, rec.get("gen", 0))
        return self.lifecycle.exists(rec["ref"], rec["ref_gen"])

    def _rollback_ref_entry(self, key: str, res: IngestResult) -> None:
        """Undo a whole-file-dedup / near-dup index entry whose pinned
        target was rolled back with the failed batch suffix: the entry's
        bytes exist nowhere, so keeping it would claim data the store
        cannot serve. Leaves resolvable entries alone."""
        rec = self.file_index.get(key)
        if (rec is None or rec.get("kind") not in ("file_dedup", "near_dup")
                or self.lifecycle.exists(rec["ref"], rec["ref_gen"])):
            return
        self.file_index.pop(key)
        fhash = rec.get("file_hash")
        if fhash:
            self._release_file_hash(key, fhash)
        # reverse the _account_stats fold and the hit counters
        self.stats.raw_bytes -= res.raw_bytes
        self.stats.stored_bytes -= res.stored_bytes
        self.stats.n_files -= 1
        if rec["kind"] == "file_dedup":
            self.stats.n_file_dedup -= 1
        else:
            self.stats.n_near_dup -= 1
        try:
            self.results.remove(res)
        except ValueError:
            pass

    def _unbind_base(self, key: str, repo_id: str) -> None:
        """Drop base/family registrations that point at ``key`` (shared by
        delete_file and the ingest rollback paths): without this, bit-
        distance matching would keep electing a base whose tensor map is
        gone — a silent zipnn fallback for new fine-tunes."""
        for bid in (key, repo_id):
            if self.base_key_of.get(bid) == key:
                self._drop_base_binding(bid)

    def _drop_base_binding(self, bid: str) -> None:
        self.invalidate_base_map(bid)
        self.base_paths.pop(bid, None)
        self.base_key_of.pop(bid, None)
        self.families.unregister(bid)

    def _set_index_entry(self, key: str, rec: Dict) -> None:
        """Commit an index record, releasing the whole-file hash of any
        record it replaces: after a re-registration the OLD content's hash
        must stop resolving to this key, or a later identical upload would
        dedup against the wrong (new) generation."""
        old = self.file_index.get(key)
        if old is not None:
            old_hash = old.get("file_hash")
            if old_hash and old_hash != rec.get("file_hash"):
                self._release_file_hash(key, old_hash)
        # write stamp: delete-vs-rewrite conflicts on ref-kind records (no
        # monotonic generation to compare) resolve last-writer-wins against
        # the tombstone's timestamp during anti-entropy
        rec.setdefault("mtime", time.time())
        self.file_index[key] = rec
        new_hash = rec.get("file_hash")
        if new_hash:
            self._keys_by_file_hash.setdefault(new_hash, set()).add(key)
        # a re-upload supersedes any delete marker: container records carry
        # a generation above the tombstone's (generations are monotonic);
        # ref-kind records are new live state for the key either way
        self.lifecycle.clear_tombstone(key)
        self._gate.bump()  # new view: serving caches keyed by read_gen roll over

    def _release_file_hash(self, key: str, fhash: str) -> None:
        """``key`` no longer serves the bytes hashing to ``fhash``: repoint
        the whole-file dedup maps at a surviving alias, or forget the hash so
        an identical future upload is stored fresh."""
        keys = self._keys_by_file_hash.get(fhash)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._keys_by_file_hash[fhash]
                keys = None
        if self.file_hash_to_key.get(fhash) != key:
            return
        if keys:
            self.file_hash_to_key[fhash] = min(keys)  # deterministic alias
        else:
            del self.file_hash_to_key[fhash]
            self.file_dedup.forget(fhash)

    def _rebuild_file_hash_map(self) -> None:
        self._keys_by_file_hash = {}
        for k, r in self.file_index.items():
            fh = r.get("file_hash")
            if fh:
                self._keys_by_file_hash.setdefault(fh, set()).add(k)

    def _pinned_ref(self, ref: str, fhash: str, raw_size: int) -> Dict:
        """Index record for a whole-file duplicate of ``ref``, pinned to the
        container generation serving ``ref``'s bytes *right now* — a later
        re-registration of ``ref`` must not change what this key retrieves."""
        rrec = self.file_index[ref]
        if rrec["kind"] == "container":
            return {"kind": "file_dedup", "ref": ref, "ref_gen": rrec["gen"],
                    "file_hash": fhash, "raw_size": raw_size}
        # ref is itself a pinned reference (file_dedup / near_dup): copy its
        # pin so retrieval never chases a mutable key
        out = {"kind": rrec["kind"], "ref": rrec["ref"], "ref_gen": rrec["ref_gen"],
               "file_hash": fhash, "raw_size": raw_size}
        if rrec["kind"] == "near_dup":
            out["header_blob_z"] = rrec["header_blob_z"]
            out["n_tensors"] = rrec.get("n_tensors")
        return out

    def _ingest_near_dup(self, res: IngestResult, sf: SafetensorsFile, key: str,
                         fhash: str, raw_size: int, header_blob: bytes,
                         target: Tuple[str, int], t0: float) -> IngestResult:
        """Satellite fix: a file whose tensors all hash-match one existing
        container version in order needs no container of its own — only its
        header blob differs, so store that plus a pinned reference."""
        tkey, tgen = target
        for ti in sf.infos:
            self.tensor_dedup.stats.observe(ti.nbytes, False)
        n = len(sf.infos)
        res.n_tensors = n
        res.n_dedup = n
        res.near_dup_hit = True
        blob_z = base64.b64encode(zlib.compress(header_blob)).decode()
        self._set_index_entry(key, {"kind": "near_dup", "ref": tkey, "ref_gen": tgen,
                                    "file_hash": fhash, "raw_size": raw_size,
                                    "n_tensors": n, "header_blob_z": blob_z})
        res.stored_bytes = len(blob_z)
        res.ingest_seconds = time.perf_counter() - t0
        self.stats.n_near_dup += 1
        return res

    def _near_dup_probe(self, sf: SafetensorsFile,
                        get_hash: Callable[[int], str]) -> Optional[Tuple[str, int]]:
        """Container version whose records match this file's tensor hashes
        exactly, in order. Best-effort: only the version pinned for the first
        hash is examined (a full match elsewhere just falls back to the
        normal dedup path). Awaits only ``get_hash(0)`` unless a candidate's
        record count matches, so the no-candidate common case keeps the
        pool's hash futures pending for the encode stage to overlap with."""
        if not self.use_tensor_dedup or not sf.infos:
            return None
        loc = self.tensor_locations.get(get_hash(0))
        if loc is None or loc[2] != 0:
            return None
        tkey, tgen, _ = loc
        try:
            with self._reader_ctx(self.lifecycle.version_path(tkey, tgen)) as reader:
                recs = reader.records
                if len(recs) == len(sf.infos) and all(
                        recs[i].self_hash == get_hash(i) for i in range(len(recs))):
                    return tkey, tgen
        except (KeyError, RuntimeError, OSError, ValueError):
            return None
        return None

    def _hash_stage(self, sf: SafetensorsFile) -> Callable[[int], str]:
        """Stage 1: submit big-tensor sha256 jobs to the pool and return a
        memoized per-index getter. Callers resolve hashes lazily, so encode
        submission overlaps the remaining hash work exactly as in the serial engine."""
        pool = self._executor()
        hash_one = self.tensor_dedup.hash_tensor
        infos = sf.infos
        futs = ([pool.submit(hash_one, sf.tensor_bytes(ti.name))
                 if ti.nbytes >= _PARALLEL_MIN_BYTES else None for ti in infos]
                if pool is not None else None)
        cache: Dict[int, str] = {}

        def get_hash(i: int) -> str:
            h = cache.get(i)
            if h is None:
                h = (futs[i].result() if futs is not None and futs[i] is not None
                     else hash_one(sf.tensor_bytes(infos[i].name)))
                cache[i] = h
            return h
        return get_hash

    # ------------------------------------------------------------------
    def _plan_tensors(self, sf: SafetensorsFile, writer: BitXWriter,
                      res: IngestResult, key: str, gen: int,
                      base_tensors: Dict[str, Tuple],
                      entries: List[Tuple[str, str, Tuple[int, ...], str]],
                      get_hash: Callable[[int], str]) -> List[Tuple]:
        """Serial decision loop per pre-hashed tensor (stage 2 of the
        per-file pipeline): dedup lookups, codec selection and
        ``tensor_locations`` registration are order-dependent, so they are
        never parallelized. Encode jobs fan out across the pool; the
        returned plan is merged strictly in tensor order by
        :meth:`_merge_plan`, so the emitted container is bit-identical to
        the serial path. Every dedup hit and BitX base reference also
        records a lifecycle edge from this container version to the pinned
        version it resolves into — the refcount graph gc() sweeps against.
        """
        pool = self._executor()
        epool = self._entropy_executor()
        infos = sf.infos
        self_vid = make_vid(key, gen)

        plan: List[Tuple[Any, str, str, Optional[str], Any]] = []
        try:
            self._plan_loop(sf, writer, res, key, gen, self_vid, base_tensors,
                            entries, get_hash, pool, epool, plan)
        except BaseException:
            # drain already-submitted encode futures before the caller
            # releases the source mmap — doomed jobs must not keep running
            for _, _, _, _, payload in plan:
                if isinstance(payload, Future) and not payload.cancel():
                    payload.exception()  # wait + swallow
            raise
        return plan

    def _plan_loop(self, sf, writer, res, key, gen, self_vid, base_tensors,
                   entries, get_hash, pool, epool,
                   plan: List[Tuple[Any, str, str, Optional[str], Any]]) -> None:
        infos = sf.infos
        # device-batched lane (batching backends only): bitx/zipnn tensors
        # get a placeholder Future in the plan and their array stage runs in
        # dtype-bucketed fused launches at flush time; decisions (this loop)
        # stay strictly serial either way, so containers are bit-identical
        batching = self.backend.supports_batching
        batch: List[Tuple[Future, str, Any, Any]] = []
        batch_bytes = 0
        for i, ti in enumerate(infos):
            res.n_tensors += 1
            thash = get_hash(i)
            entries.append((ti.name, ti.dtype_str, ti.shape, thash))
            dup = self.use_tensor_dedup and thash in self.tensor_locations
            self.tensor_dedup.stats.observe(ti.nbytes, not dup)
            if dup:
                # ② zero-payload reference into the global tensor pool
                res.n_dedup += 1
                tk, tg, _ = self.tensor_locations[thash]
                self.lifecycle.add_edge(self_vid, make_vid(tk, tg))
                plan.append((ti, thash, "dedup", None, None))
            else:
                base = base_tensors.get(ti.name)
                base_dtype = None
                if (self.use_bitx and base is not None and ti.dtype_str in _FLOAT_TAGS
                        and base[0] == ti.dtype_str and base[1] == ti.shape):
                    kind, base_hash, base_loader = "bitx", base[3], base[2]
                    res.n_bitx += 1
                    bloc = self.tensor_locations.get(base_hash)
                    if bloc is not None:
                        self.lifecycle.add_edge(self_vid, make_vid(bloc[0], bloc[1]))
                elif (self.use_bitx and base is not None and ti.dtype_str == "I8"
                        and base[0] in _QDELTA_BASE_TAGS and base[1] == ti.shape):
                    # dtype-crossing delta: int8 repack of a float base. The
                    # encode may still downgrade to the standalone outcome
                    # (merge nulls the base ref then); the lifecycle edge
                    # stays either way — conservative pinning, same as a
                    # dedup edge to a version we later stop referencing.
                    kind, base_hash, base_loader = "bitxq", base[3], base[2]
                    base_dtype = base[0]
                    res.n_bitxq += 1
                    bloc = self.tensor_locations.get(base_hash)
                    if bloc is not None:
                        self.lifecycle.add_edge(self_vid, make_vid(bloc[0], bloc[1]))
                elif ti.dtype_str in _FLOAT_TAGS:
                    kind, base_hash, base_loader = "zipnn", None, None
                    res.n_zipnn += 1
                else:
                    kind, base_hash, base_loader = "raw", None, None
                    res.n_raw += 1
                if batching and kind in ("bitx", "zipnn"):
                    payload: Any = Future()
                    batch.append((payload, kind, ti, base_loader))
                    batch_bytes += ti.nbytes
                    if batch_bytes >= _DEVICE_BATCH_MAX_BYTES:
                        self._flush_device_batch(sf, batch, pool, epool)
                        batch, batch_bytes = [], 0
                else:
                    job = self._encode_job(self._codec_runtime, kind, sf, ti,
                                           base_loader, epool, base_dtype)
                    payload = (pool.submit(job)
                               if pool is not None and ti.nbytes >= _PARALLEL_MIN_BYTES
                               else job())
                plan.append((ti, thash, kind, base_hash, payload))
            # first location wins: a base tensor's hash must keep pointing
            # at its standalone (zipnn/raw) record, never at a later BitX
            # record that references the same hash as ITS base (cycle).
            # Record index == tensor index (dedup entries are records too).
            self.tensor_locations.setdefault(thash, (key, gen, i))
        if batch:
            self._flush_device_batch(sf, batch, pool, epool)

    def _flush_device_batch(self, sf, batch: List[Tuple[Future, str, Any, Any]],
                            pool, epool) -> None:
        """Run the array stage of the accumulated bitx/zipnn tensors in
        dtype-bucketed fused kernel launches (one per bit-width bucket), then
        fan the per-tensor entropy stage back out across the pool. Each
        placeholder resolves to the same ``(codec, frames, raw_size)`` tuple
        the unbatched encode job produces — the transforms are elementwise,
        so the plane bytes (hence the container bytes) are identical."""
        try:
            arrs = [np.frombuffer(sf.tensor_bytes(ti.name),
                                  STR_TO_DTYPE[ti.dtype_str]).reshape(ti.shape)
                    for _, _, ti, _ in batch]
            planes_of: List[Any] = [None] * len(batch)
            xor_idx = [i for i, (_, kind, _, _) in enumerate(batch) if kind == "bitx"]
            pln_idx = [i for i, (_, kind, _, _) in enumerate(batch) if kind == "zipnn"]
            if xor_idx:
                pairs = [(batch[i][3]().reshape(-1), arrs[i].reshape(-1))
                         for i in xor_idx]
                for i, planes in zip(xor_idx,
                                     self.backend.xor_delta_planes_batch(pairs)):
                    planes_of[i] = planes
            if pln_idx:
                split = self.backend.byte_planes_batch([arrs[i] for i in pln_idx])
                for i, planes in zip(pln_idx, split):
                    planes_of[i] = planes
        except BaseException as e:
            for fut, _, _, _ in batch:
                if not fut.done():
                    fut.set_exception(e)
            raise
        # entropy stage: planes are private copies (the kernel outputs), so
        # these jobs never touch the source mmap and may outlive the plan
        for (fut, kind, ti, _), arr, planes in zip(batch, arrs, planes_of):
            job = self._entropy_job(kind, planes, int(arr.nbytes), epool)
            if pool is not None and ti.nbytes >= _PARALLEL_MIN_BYTES:
                self._chain_future(pool.submit(job), fut)
            else:
                try:
                    result = job()
                except BaseException as e:
                    fut.set_exception(e)
                    raise
                if not fut.cancelled():
                    fut.set_result(result)

    def _entropy_job(self, kind: str, planes, raw_size: int,
                     epool) -> Callable[[], Tuple[str, List[bytes], int]]:
        runtime = self._codec_runtime
        def entropy() -> Tuple[str, List[bytes], int]:
            if epool is not None:
                return kind, self._entropy_frames(
                    epool, [p.tobytes() for p in planes]), raw_size
            return get_codec(kind).encode(
                runtime, EncodeInput(planes=planes, raw_size=raw_size))
        return entropy

    @staticmethod
    def _chain_future(src: Future, dst: Future) -> None:
        """Forward ``src``'s outcome into the plan's placeholder ``dst``.
        The placeholder may already be cancelled by the abort drain in
        :meth:`_plan_tensors`; dropping the result there is correct (the
        whole plan is doomed and the job touched no shared state)."""
        def _done(f: Future) -> None:
            try:
                if f.cancelled():
                    dst.cancel()
                    return
                e = f.exception()
                if e is not None:
                    dst.set_exception(e)
                else:
                    dst.set_result(f.result())
            except Exception:
                pass  # placeholder already resolved/cancelled
        src.add_done_callback(_done)

    @staticmethod
    def _merge_plan(writer: BitXWriter, plan: List[Tuple]) -> None:
        """Stage 4: ordered merge — append strictly in tensor order. The
        encode payload carries the final codec: raw-kind tensors the entropy
        stage could not shrink come back as ``stored`` (verbatim bytes, the
        zero-copy sendfile span of the serving layer), and quantized-delta
        tensors the residual could not beat come back as their standalone
        ``raw``/``stored`` outcome — the base reference is nulled then, so
        the record carries no dangling dependency. A 4-tuple payload's
        fourth element is the lane's extra stamp fields (the bitxq
        scale/zero-point replay data)."""
        for ti, thash, kind, base_hash, payload in plan:
            if kind == "dedup":
                writer.add_dedup(ti.name, ti.dtype_str, ti.shape, thash, ti.nbytes)
            else:
                out = (payload.result()
                       if isinstance(payload, Future) else payload)
                codec, frames, raw = out[:3]
                extras = out[3] if len(out) > 3 else None
                writer.add_precomputed(ti.name, ti.dtype_str, ti.shape, codec,
                                       base_hash if codec in ("bitx", "bitxq")
                                       else None,
                                       thash, frames, raw, extras)

    def _encode_job(self, runtime: CodecRuntime, kind: str, sf: SafetensorsFile,
                    ti, base_loader,
                    epool, base_dtype: Optional[str] = None
                    ) -> Callable[[], Tuple[str, List[bytes], int]]:
        """Closure encoding one tensor via the codec registry; safe to run on
        any worker thread (the runtime's zstd contexts are thread-local,
        sf/base reads are mmap slices). Returns ``(final codec, frames, raw
        size)`` — raw-kind tensors are downgraded to ``stored`` when
        compression would grow them (``repro_torch.core.codecs.raw_or_stored``), a
        pure function of (bytes, backend), so every engine emits identical
        containers. With the opt-in process entropy backend the array stages
        (XOR, plane split) stay on the calling thread and only the entropy
        stage ships to a child process — the frames are identical either
        way. The quantized-delta lane (``bitxq``) always runs fully
        in-thread via the registry, even under the entropy pool: its
        lane-vs-standalone decision needs both the residual frames and the
        standalone frame, and the frames are identical executor-independent
        anyway."""
        def encode() -> Tuple[str, List[bytes], int]:
            raw = sf.tensor_bytes(ti.name)
            if kind == "raw":
                data = bytes(raw)
                if epool is not None:
                    frame = self._entropy_frames(epool, [data])[0]
                    final, payload = raw_or_stored(data, frame)
                    return final, [payload], len(data)
                return get_codec("raw").encode(runtime, EncodeInput(data=data))
            arr = np.frombuffer(raw, STR_TO_DTYPE[ti.dtype_str]).reshape(ti.shape)
            if kind == "bitxq":
                return get_codec("bitxq").encode(
                    runtime, EncodeInput(data=arr, base=base_loader(),
                                         base_dtype=base_dtype))
            if kind == "bitx":
                base_arr = base_loader()
                if epool is not None:
                    planes = runtime.backend.xor_delta_planes(
                        base_arr.reshape(-1), arr.reshape(-1))
                    return kind, self._entropy_frames(
                        epool, [p.tobytes() for p in planes]), int(arr.nbytes)
                return get_codec("bitx").encode(
                    runtime, EncodeInput(data=arr, base=base_arr))
            if epool is not None:
                planes = runtime.backend.byte_planes(arr)
                return (kind,
                        self._entropy_frames(epool, [p.tobytes() for p in planes]),
                        int(arr.nbytes))
            return get_codec("zipnn").encode(runtime, EncodeInput(data=arr))
        return encode

    def _entropy_frames(self, epool: ProcessPoolExecutor,
                        blobs: List[bytes]) -> List[bytes]:
        try:
            return epool.submit(_entropy_compress, self.zstd_level,
                                self.zstd_threads, blobs).result()
        except Exception:
            # broken child pool mid-run: fall back to in-thread entropy —
            # the frames are identical, only the executor changes
            self._entropy_failed = True
            c = zstd.ZstdCompressor(level=self.zstd_level,
                                    threads=self.zstd_threads)
            return [c.compress(b) for b in blobs]

    # ------------------------------------------------------------------
    def _resolve_base(self, repo_id: str, path: str,
                      declared_base: Optional[str] = None) -> Tuple[Optional[str], str]:
        # explicit caller hint (e.g. the checkpoint manager naming its run's
        # first checkpoint) takes precedence, then repo metadata, then the
        # bit-distance fallback — the declared id must already be ingested +
        # standalone to serve as a base
        for declared, src in ((declared_base, "declared"),
                              (self.metadata_base.get(repo_id), "metadata")):
            if declared and declared in self.base_paths:
                return declared, src
        m = self.families.match(path)
        if m is not None:
            return m[0], "bitdistance"
        return None, ""

    def _elect_base(self, pf: "_PreparedUpload"
                    ) -> Tuple[Optional[str], str, Dict[str, Tuple]]:
        """The upload's family base, how it was found, and its tensor map.

        A base binding must not outlive the pool entries of the tensors its
        map names. gc and compaction retire a generation and scrub its pins
        without touching the bindings primed from it (a key that a whole-file
        or near-dup re-upload re-pointed keeps its old binding), and a
        fine-tune coded against such a base would name base hashes with no
        record: a ``KeyError`` at retrieval, or, when the upload holds the
        base's own bytes, a BitX record that is its own base (a resolution
        cycle). So a base whose map names an unpinned hash is unbound here
        and the upload is matched again, down to standalone. A repo id whose
        first standalone file is gone takes its key's binding in its place
        when that one is live (the repo's current standalone content), and is
        unbound with it otherwise."""
        while True:
            base_id, src = self._resolve_base(pf.repo_id, pf.path,
                                              pf.declared_base)
            if base_id is None:
                return None, "", {}
            tensors = self._base_tensor_map(base_id)
            if self._base_is_live(tensors):
                return base_id, src, tensors
            key = self.base_key_of.get(base_id)
            self._drop_base_binding(base_id)
            if key is None or key == base_id or key not in self.base_paths:
                continue
            key_tensors = self._base_tensor_map(key)
            if key_tensors and key in self._base_maps and self._base_is_live(key_tensors):
                path = self.base_paths[key]
                self._bind_base(base_id, path, key, self._base_maps[key])
                self.families.register(base_id, path)
            else:
                self._drop_base_binding(key)

    def _base_is_live(self, tensors: Dict[str, Tuple]) -> bool:
        return all(t[3] in self.tensor_locations for t in tensors.values())

    # -- base-map cache -------------------------------------------------
    def _register_base(self, repo_id: str, key: str, path: str,
                       entries: List[Tuple[str, str, Tuple[int, ...], str]]) -> None:
        """Bind a freshly-ingested standalone file as a family base and prime
        its tensor map from the hashes just computed (zero extra hash passes).

        The ``key`` binding always tracks the latest ingest of that key
        (re-registration invalidates any cached map); the ``repo_id`` binding
        keeps seed semantics — the repo's first standalone file wins.

        Re-registration is safe: the superseded container generation stays
        on disk (copy-on-write, see the lifecycle section of the module
        docstring), so dependants of the old version keep resolving their
        pinned references; only NEW fine-tunes delta against the new bytes.
        """
        bm = _BaseTensorMap(path, entries)
        self.base_map_stats["primed"] += 1
        self._bind_base(key, path, key, bm)
        if self.base_paths.setdefault(repo_id, path) == path:
            self.base_key_of.setdefault(repo_id, key)
            self._bind_base(repo_id, path, self.base_key_of[repo_id], bm)

    def _bind_base(self, base_id: str, path: str, key: str, bm: _BaseTensorMap) -> None:
        old = self._base_maps.pop(base_id, None)
        if old is not None and old is not bm:
            # maps may be shared between the repo_id and key bindings, so do
            # not close the old one here — another binding may still use it
            self.base_map_stats["invalidations"] += 1
        self.base_paths[base_id] = path
        self.base_key_of[base_id] = key
        self._base_maps[base_id] = bm

    def invalidate_base_map(self, base_id: Optional[str] = None) -> None:
        """Drop cached base maps (all of them when ``base_id`` is None).
        The next fine-tune ingest rebuilds from disk with one hash pass."""
        ids = [base_id] if base_id is not None else list(self._base_maps)
        for bid in ids:
            if self._base_maps.pop(bid, None) is not None:
                self.base_map_stats["invalidations"] += 1

    def _base_tensor_map(self, base_id: str) -> Dict[str, Tuple]:
        """name -> (dtype_str, shape, lazy loader, tensor hash) for the base."""
        path = self.base_paths.get(base_id)
        if path is None:
            return {}
        if not os.path.exists(path):
            # the ingest-time source was dropped (e.g. keep_plain=False
            # checkpoints) — materialize the base from its own container
            key = self.base_key_of.get(base_id)
            if key is None:
                return {}
            cache_dir = os.path.join(self.root, "basecache")
            os.makedirs(cache_dir, exist_ok=True)
            cpath = os.path.join(cache_dir, key.replace("/", "__"))
            if not os.path.exists(cpath):
                repo, fname = key.split("/", 1)
                data = self.retrieve_file(repo, fname, verify=False)
                with open(cpath, "wb") as f:
                    f.write(data)
            path = cpath
            self.base_paths[base_id] = path
        bm = self._base_maps.get(base_id)
        if bm is not None and bm.path == path:
            self.base_map_stats["hits"] += 1
            return bm.tensors
        if bm is not None:  # stale binding (base re-registered elsewhere)
            self.base_map_stats["invalidations"] += 1
        self.base_map_stats["misses"] += 1
        bm = self._build_base_map(path)
        self._base_maps[base_id] = bm
        return bm.tensors

    def _build_base_map(self, path: str) -> _BaseTensorMap:
        """Cold path: one full hash pass over the base file (cache miss —
        e.g. first use after ``load_index`` in a fresh process)."""
        entries = []
        with SafetensorsFile(path) as sf:
            for ti in sf.infos:
                entries.append((ti.name, ti.dtype_str, ti.shape,
                                self.tensor_dedup.hash_tensor(sf.tensor_bytes(ti.name))))
        return _BaseTensorMap(path, entries)

    @staticmethod
    def _read_header_blob(path: str) -> bytes:
        with open(path, "rb") as f:
            (hlen,) = struct.unpack("<Q", f.read(8))
            f.seek(0)
            return f.read(8 + hlen)

    def _container_path(self, key: str, gen: int = 0) -> str:
        # gen 0 keeps the v1 layout (``<key>.bitx``) so existing stores
        # stay valid; re-registrations get copy-on-write sibling paths
        name = key + (".bitx" if gen == 0 else f"@g{gen}.bitx")
        return os.path.join(self.root, "containers", name)

    def _account_stats(self, res: IngestResult):
        """Fold a finished ingest result into the store totals. Results are
        appended to ``self.results`` at decision time (submission order);
        these sums commute, so deferred-write commits may fold out of order.
        ``stats.ingest_seconds`` is NOT summed here: per-file times overlap
        under the cross-file pipeline, so ``ingest_many`` accounts batch
        wall-clock instead (keeping ``ingest_throughput_mbps`` honest)."""
        self.stats.raw_bytes += res.raw_bytes
        self.stats.stored_bytes += res.stored_bytes
        self.stats.n_files += 1
        self.stats.live_bytes = self.lifecycle.live_bytes()

    # ------------------------------------------------------------------
    # Spooled ingest: the server's remote write path. Uploads are streamed
    # to the spool directory by the HTTP layer, enqueued here, and drained
    # by ONE background worker through the ordinary pipelined
    # ``ingest_many`` / ``ingest_repos`` engines (admin lock and all) —
    # remote writes are exactly local ingests, just asynchronous.
    # ------------------------------------------------------------------
    def spool_dir(self) -> str:
        """Directory for in-flight remote uploads. Lives outside
        ``containers/`` so the fsck orphan scan never sees spool files."""
        p = os.path.join(self.root, ".spool")
        os.makedirs(p, exist_ok=True)
        return p

    def decoded_dir(self) -> str:
        """Directory for the serving layer's decoded-object spill tier
        (``repro.serve.singleflight.TieredResponseCache``). Lives outside
        ``containers/`` like the spool; spill files are disposable cache
        state (wiped on engine construction), and ``.part`` temps left by
        a crash mid-spill are cleaned by the fsck orphan scan."""
        p = os.path.join(self.root, ".decoded")
        os.makedirs(p, exist_ok=True)
        return p

    def enqueue_ingest(self, uploads: Sequence, *, cleanup: bool = False) -> str:
        """Queue an ``ingest_many`` batch for the background worker;
        returns the job id (poll :meth:`ingest_job`). ``cleanup=True``
        deletes the source files once the job finishes (the HTTP layer's
        spooled uploads have no other owner)."""
        specs = []
        for u in uploads:
            path, repo_id, filename, declared = (tuple(u) + (None, None))[:4]
            specs.append((path, repo_id,
                          filename or os.path.basename(path), declared))
        return self._enqueue_job(IngestJob(
            job_id=f"j{next(self._job_seq)}", kind="files", specs=specs,
            cleanup=cleanup))

    def enqueue_ingest_repo(self, repo_dir: str, repo_id: Optional[str] = None,
                            *, cleanup: bool = False) -> str:
        """Queue a whole-repo ingest (metadata parsed exactly as in
        :meth:`ingest_repos`) for the background worker."""
        return self._enqueue_job(IngestJob(
            job_id=f"j{next(self._job_seq)}", kind="repo",
            specs=[(repo_dir, repo_id)], cleanup=cleanup))

    def enqueue_repair(self, thunk: Callable[[], Dict], note: str = "") -> str:
        """Queue an asynchronous repair action (straggler re-replication,
        anti-entropy catch-up) on the existing ingest job worker: repairs
        serialize with remote writes on the same thread, inherit the
        ``/admin/jobs`` bookkeeping, and persist the index on completion
        exactly like a spooled upload. ``thunk`` runs on the worker and its
        returned dict becomes the job's single result row."""
        return self._enqueue_job(IngestJob(
            job_id=f"j{next(self._job_seq)}", kind="repair",
            specs=[(thunk, note)]))

    def _enqueue_job(self, job: IngestJob) -> str:
        with self._job_cv:
            self._jobs[job.job_id] = job
            # bounded history: evict the oldest *terminal* jobs past 256
            while len(self._jobs) > 256:
                for jid, j in self._jobs.items():
                    if j.state in ("done", "failed"):
                        del self._jobs[jid]
                        break
                else:
                    break
            if self._job_thread is None or not self._job_thread.is_alive():
                self._job_thread = threading.Thread(
                    target=self._job_worker_loop, daemon=True,
                    name="zllm-ingest-jobs")
                self._job_thread.start()
        self._job_queue.put(job)
        return job.job_id

    def _job_worker_loop(self) -> None:
        while True:
            job = self._job_queue.get()
            if job is None:
                return
            with self._job_cv:
                job.state = "running"
                job.started_at = time.time()
            try:
                if job.kind == "repair":
                    thunk, note = job.specs[0]
                    out = thunk() or {}
                    out.setdefault("note", note)
                    with self._admin_lock:
                        self.save_index()
                    with self._job_cv:
                        job.results = [out]
                        job.state = "done"
                        job.finished_at = time.time()
                        self._job_cv.notify_all()
                    continue
                if job.kind == "repo":
                    results = self.ingest_repos(job.specs)
                else:
                    results = self.ingest_many(job.specs)
                # adopt/cleanup spool sources BEFORE persisting: the index
                # snapshot must record the post-adoption base paths, never
                # a spool path about to be renamed away
                self._cleanup_job_sources(job)
                # remote writes are durable once acknowledged as done; the
                # admin lock keeps the snapshot consistent against a
                # concurrent delete/gc on another thread
                with self._admin_lock:
                    self.save_index()
            except Exception as e:
                # a poisoned batch may still have committed earlier uploads
                # (possibly a base) — adopt-or-delete runs here too
                self._cleanup_job_sources(job)
                with self._job_cv:
                    job.state = "failed"
                    job.error = f"{type(e).__name__}: {e}"
                    job.finished_at = time.time()
                    self._job_cv.notify_all()
            else:
                rows = [{"repo_id": r.repo_id, "filename": r.filename,
                         "raw_bytes": r.raw_bytes, "stored_bytes": r.stored_bytes,
                         "reduction": round(r.reduction, 4),
                         "base_id": r.base_id, "base_source": r.base_source,
                         "n_tensors": r.n_tensors, "n_dedup": r.n_dedup,
                         "n_bitx": r.n_bitx, "n_bitxq": r.n_bitxq,
                         "file_dedup_hit": r.file_dedup_hit,
                         "near_dup_hit": r.near_dup_hit} for r in results]
                with self._job_cv:
                    job.results = rows
                    job.state = "done"
                    job.finished_at = time.time()
                    self._job_cv.notify_all()

    def _cleanup_job_sources(self, job: "IngestJob") -> None:
        """Adopt-or-delete a finished job's spooled sources (idempotent)."""
        if not (job.cleanup and job.kind == "files"):
            return
        for path, *_ in job.specs:
            try:
                if os.path.exists(path) and not self._adopt_spooled_source(path):
                    os.remove(path)
            except OSError:
                pass

    def _adopt_spooled_source(self, path: str) -> bool:
        """A spooled upload that registered as a family BASE must outlive
        its spool file: the bit-distance matcher and the base-map cache
        read the ingest-time source path when later fine-tunes arrive.
        Move such a file into ``basecache/`` and rebind every path
        reference (base_paths, cached base maps, the family registry).
        Returns True when the file was adopted — the caller must not
        delete it. Plain uploads (fine-tunes, dups) return False."""
        with self._admin_lock:
            bound = [bid for bid, p in self.base_paths.items() if p == path]
            fam_bound = any(p == path
                            for cands in self.families.by_sig.values()
                            for _, p in cands)
            if not bound and not fam_bound:
                return False
            key = self.base_key_of.get(bound[0]) if bound else None
            cache_dir = os.path.join(self.root, "basecache")
            os.makedirs(cache_dir, exist_ok=True)
            dst = os.path.join(cache_dir,
                               (key or os.path.basename(path)).replace("/", "__"))
            os.replace(path, dst)  # same-fs rename: open fds/maps stay valid
            for bid in bound:
                self.base_paths[bid] = dst
                bm = self._base_maps.get(bid)
                if bm is not None and bm.path == path:
                    bm.path = dst
            for cands in self.families.by_sig.values():
                for i, (bid, p) in enumerate(cands):
                    if p == path:
                        cands[i] = (bid, dst)
            return True

    def ingest_job(self, job_id: str) -> Optional[Dict]:
        """Status dict for one job (None if unknown/expired)."""
        with self._job_cv:
            job = self._jobs.get(job_id)
            return job.to_json() if job is not None else None

    def ingest_jobs(self, limit: int = 64) -> List[Dict]:
        """Most recent jobs, newest first."""
        with self._job_cv:
            jobs = list(self._jobs.values())[-limit:]
        return [j.to_json() for j in reversed(jobs)]

    def wait_ingest_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued job reached a terminal state (the
        smoke/test harness's drain barrier). True on idle, False on
        timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._job_cv:
            while any(j.state in ("queued", "running")
                      for j in self._jobs.values()):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._job_cv.wait(timeout=remaining)
        return True

    # ------------------------------------------------------------------
    # Publish epochs + pin-counted readers (the concurrency substrate the
    # serving layer builds on)
    # ------------------------------------------------------------------
    @property
    def read_gen(self) -> int:
        """Monotonic mutation counter: bumped by every ingest commit,
        delete, gc and quarantine. The async serving layer keys its
        single-flight table and response cache by it, so a request issued
        after a mutation never coalesces onto a stale in-flight decode."""
        return self._gate.read_gen

    def _mark_pending(self, cpath: str) -> None:
        with self._publish_lock:
            self._pending_publish[cpath] = threading.Event()

    def _publish(self, cpath: str) -> None:
        with self._publish_lock:
            ev = self._pending_publish.pop(cpath, None)
        if ev is not None:
            ev.set()

    def _await_publish(self, cpath: str) -> None:
        with self._publish_lock:
            ev = self._pending_publish.get(cpath)
        if ev is not None:
            ev.wait()

    @staticmethod
    def _retire_reader(handle: _ReaderHandle) -> None:
        """Eviction hook (LRU overflow / gc / quarantine; runs under the
        cache lock): close the mmap now when idle, else the last in-flight
        release closes it — deterministic either way, never mid-decode."""
        handle.retired = True
        if handle.pins == 0:
            handle.reader.close()

    def _acquire_reader(self, cpath: str) -> _ReaderHandle:
        """Pin an LRU-cached mmap reader for a container path.
        Generation-aware by construction (version paths are never reused);
        blocks until a pending pipelined write of this path is published."""
        self._await_publish(cpath)
        with self._cache_lock:
            handle = self._reader_cache.get(cpath)
            if handle is not None:
                handle.pins += 1
                return handle
        reader = BitXReader.open(cpath, runtime=self._codec_runtime)  # slow path outside the lock
        with self._cache_lock:
            handle = self._reader_cache.get(cpath)
            if handle is None:
                handle = _ReaderHandle(reader)
                self._reader_cache.put(cpath, handle)
            else:
                reader.close()  # lost the open race; keep the cached map
            handle.pins += 1
            return handle

    def _release_reader(self, handle: _ReaderHandle) -> None:
        with self._cache_lock:
            handle.pins -= 1
            if handle.retired and handle.pins == 0:
                handle.reader.close()

    @contextmanager
    def _reader_ctx(self, cpath: str):
        handle = self._acquire_reader(cpath)
        try:
            yield handle.reader
        finally:
            self._release_reader(handle)

    # ------------------------------------------------------------------
    # Retrieval
    # ------------------------------------------------------------------
    def retrieve_file(self, repo_id: str, filename: str, out_path: Optional[str] = None,
                      verify: bool = True) -> bytes:
        """Reconstruct the original safetensors file bit-exactly. Pinned
        references (file_dedup / near_dup) decode the exact container
        generation they were ingested against, regardless of what their
        target key points at today. Holds the read gate: a concurrent
        ``gc()`` cannot reclaim a generation out from under this decode."""
        data, _ = self._retrieve_with_digest(repo_id, filename, verify,
                                             want_digest=False)
        if out_path:
            with open(out_path, "wb") as f:
                f.write(data)
        return data

    def retrieve_file_digest(self, repo_id: str, filename: str,
                             verify: bool = True) -> Tuple[bytes, str]:
        """(file bytes, sha256 hexdigest). The digest is computed under the
        same read-gate hold as the decode, so it is always consistent with
        the returned bytes — and the serving layer never hashes a response
        twice (``verify`` reuses this one digest for the index check)."""
        return self._retrieve_with_digest(repo_id, filename, verify,
                                          want_digest=True)

    def entity_tag(self, repo_id: str, filename: str) -> Optional[str]:
        """Strong HTTP validator for ``repo_id/filename``'s current index
        record, or ``None`` when the key is missing or quarantined.

        Containers are immutable once registered and generations are
        monotonic per key, so ``key@gN`` changes exactly when the served
        bytes can change — a free strong validator. Ref-kind records
        (file_dedup / near_dup) pin an exact target generation instead of
        owning one, so their validator embeds the pinned coordinates plus
        a whole-file-hash prefix: replacing the record (even re-pinning
        the same target for different bytes) can never collide.

        Lock-free on purpose: one dict read of an atomically-replaced
        record — cheap enough for the serving event loop to call per
        request, and consistent-by-construction because no generation is
        ever reused (an observed tag can only mean one byte content)."""
        key = f"{repo_id}/{filename}"
        rec = self.file_index.get(key)
        if rec is None or rec.get("quarantined"):
            return None
        if rec.get("kind") == "container":
            return f"{key}@g{rec['gen']}"
        return (f"{key}@{rec['kind']}:{rec.get('ref', '')}"
                f"@g{rec.get('ref_gen', 0)}:{rec.get('file_hash', '')[:12]}")

    def _retrieve_with_digest(self, repo_id: str, filename: str, verify: bool,
                              want_digest: bool) -> Tuple[bytes, str]:
        with self._gate.read():
            key = f"{repo_id}/{filename}"
            rec = self.file_index[key]
            if rec.get("quarantined"):
                raise RuntimeError(f"{key}: container was quarantined by fsck; "
                                   f"restore from quarantine/ or re-ingest")
            if rec["kind"] == "file_dedup":
                data = self._decode_container(self._ref_path(rec))
            elif rec["kind"] == "near_dup":
                header_blob = zlib.decompress(base64.b64decode(rec["header_blob_z"]))
                data = self._decode_container(self._ref_path(rec),
                                              header_override=header_blob)
            else:
                data = self._decode_container(rec["path"])
            # lazy digest: verify=False callers (throughput benches) skip it
            digest = sha256_bytes(data) if (verify or want_digest) else ""
            if verify:
                assert digest == rec["file_hash"], f"retrieval hash mismatch for {key}"
        return data, digest

    def retrieve_tensor(self, repo_id: str, filename: str, tensor_name: str,
                        verify: bool = True) -> Tuple[bytes, Dict]:
        """Decode ONE tensor of a stored file (the serving hot path: a
        client wants an embedding table, not a 10 GB shard). Returns
        ``(raw little-endian bytes, {"dtype", "shape", "nbytes", "codec"})``.
        Pinned references resolve exactly like :meth:`retrieve_file`; only
        the requested record (plus its dedup/BitX dependencies) is decoded.
        Near-dup entries resolve the name through their OWN header — the
        one part of a near-dup that may differ from its pinned target
        (renamed/permuted tensors over record-identical bytes)."""
        with self._gate.read():
            key = f"{repo_id}/{filename}"
            rec = self.file_index[key]
            if rec.get("quarantined"):
                raise RuntimeError(f"{key}: container was quarantined by fsck; "
                                   f"restore from quarantine/ or re-ingest")
            if rec["kind"] == "near_dup":
                idx, dtype_str, shape = self._near_dup_tensor_lookup(
                    rec, tensor_name, key)
                cpath = self._ref_path(rec)
            else:
                # container: own records. file_dedup: byte-identical file ->
                # identical header -> the target's record names ARE this
                # file's names.
                idx = dtype_str = shape = None
                cpath = (rec["path"] if rec["kind"] == "container"
                         else self._ref_path(rec))
            with self._reader_ctx(cpath) as reader:
                if idx is None:
                    try:
                        idx = reader.index_of(tensor_name)
                    except KeyError:
                        raise KeyError(f"tensor {tensor_name!r} not in {key}") from None
                r = reader.records[idx]
                arr = reader.decode_tensor(idx, self._resolve_tensor_hash,
                                           self._resolve_tensor_hash)
                data = np.ascontiguousarray(arr).tobytes()
                if verify:
                    assert sha256_bytes(data) == r.self_hash, \
                        f"tensor hash mismatch for {key}:{tensor_name}"
                meta = {"dtype": dtype_str or r.dtype_str,
                        "shape": list(shape) if shape is not None else list(r.shape),
                        "nbytes": len(data), "codec": r.codec}
        return data, meta

    def _near_dup_tensor_lookup(self, rec: Dict, tensor_name: str,
                                key: str) -> Tuple[int, str, Tuple[int, ...]]:
        """(record index, dtype tag, shape) of ``tensor_name`` inside a
        near-dup entry, read from the entry's own header blob. The near-dup
        invariant is hash-equality RECORD-FOR-RECORD in serialization
        order, so index i of this header decodes as record i of the pinned
        target — names, dtype tags and shapes come from here. Parsed maps
        are memoized (LRU) so per-tensor serving pays the decompress+parse
        once per entry, not per request."""
        cache_key = (rec["ref"], rec["ref_gen"], rec.get("file_hash"))
        with self._cache_lock:
            name_map = self._near_dup_name_cache.get(cache_key)
        if name_map is None:
            blob = zlib.decompress(base64.b64decode(rec["header_blob_z"]))
            infos, _, _ = read_header_blob(blob)  # serialization == record order
            name_map = {ti.name: (i, ti.dtype_str, ti.shape)
                        for i, ti in enumerate(infos)}
            with self._cache_lock:
                self._near_dup_name_cache.put(cache_key, name_map)
        hit = name_map.get(tensor_name)
        if hit is None:
            raise KeyError(f"tensor {tensor_name!r} not in {key}")
        return hit

    def _ref_path(self, rec: Dict) -> str:
        """Container path for a pinned (ref, ref_gen) index record."""
        return self.lifecycle.version_path(rec["ref"], rec["ref_gen"])

    def tensor_sendfile_span(self, repo_id: str, filename: str,
                             tensor_name: str) -> Optional[Tuple[str, int, int, Dict]]:
        """Zero-copy source for a tensor stored VERBATIM on disk.

        Returns ``(container_path, absolute_offset, nbytes, meta)`` when the
        tensor's payload is a ``stored``-codec frame (raw-kind bytes the
        entropy stage could not shrink) — a contiguous byte span of the
        container file that the serving layer can push straight to a socket
        with ``os.sendfile``, no decode, no copy. Dedup records are chased
        one hop to their pinned payload. Returns ``None`` for every other
        codec or any irregularity; callers fall back to the decode path
        (which raises the proper errors). Containers are immutable and
        writes are temp+rename, so a span resolved here stays valid for as
        long as the caller holds an fd — even across a concurrent
        gc/compact unlink."""
        with self._gate.read():
            key = f"{repo_id}/{filename}"
            rec = self.file_index.get(key)
            if rec is None or rec.get("quarantined"):
                return None
            try:
                if rec["kind"] == "near_dup":
                    idx, dtype_str, shape = self._near_dup_tensor_lookup(
                        rec, tensor_name, key)
                    cpath = self._ref_path(rec)
                else:
                    idx = dtype_str = shape = None
                    cpath = (rec["path"] if rec["kind"] == "container"
                             else self._ref_path(rec))
                with self._reader_ctx(cpath) as reader:
                    if idx is None:
                        idx = reader.index_of(tensor_name)
                    r = reader.records[idx]
                    if r.codec == "dedup":
                        loc = self.tensor_locations.get(r.self_hash)
                        if loc is None:
                            return None
                        cpath = self.lifecycle.version_path(loc[0], loc[1])
                        with self._reader_ctx(cpath) as pool_reader:
                            pr = pool_reader.records[loc[2]]
                            if pr.codec != "stored" or pr.self_hash != r.self_hash:
                                return None
                            off, length = pool_reader.frame_span(loc[2])
                    elif r.codec == "stored":
                        off, length = reader.frame_span(idx)
                    else:
                        return None
            except (KeyError, OSError, RuntimeError, ValueError):
                return None
            if length != r.raw_size or length == 0:
                return None  # a stored span must be exactly the raw bytes
            meta = {"dtype": dtype_str or r.dtype_str,
                    "shape": list(shape) if shape is not None else list(r.shape),
                    "nbytes": length, "codec": "stored",
                    # the record's content hash IS the sha256 of the span
                    # bytes — verifying callers (the server's sendfile path
                    # under verify=True) check it once per immutable span
                    "sha256": r.self_hash}
            return cpath, off, length, meta

    def _decode_container(self, cpath: str,
                          header_override: Optional[bytes] = None) -> bytes:
        with self._reader_ctx(cpath) as reader:
            header_blob = (header_override if header_override is not None else
                           zlib.decompress(
                               base64.b64decode(reader.file_metadata["header_blob_z"])))
            resolver = self._resolve_tensor_hash

            def decode(idx: int) -> bytes:
                arr = reader.decode_tensor(idx, resolver, resolver)
                return np.ascontiguousarray(arr).tobytes()

            n = len(reader.records)
            pool = self._executor()
            n_big = sum(1 for r in reader.records if r.raw_size >= _PARALLEL_MIN_BYTES)
            if self.backend.supports_batching and n > 0:
                # device fan-out: entropy-decode planes across the pool, then
                # merge every bitx/zipnn record in bucketed fused launches
                chunks = self._decode_records_batched(reader)
            elif pool is not None and n_big > 1:
                # workers never re-enter the pool (dependency resolution decodes
                # inline), so mapping from the ingest pool cannot deadlock
                chunks = list(pool.map(decode, range(n)))
            else:
                chunks = [decode(i) for i in range(n)]
            return b"".join([header_blob] + chunks)

    def _decode_records_batched(self, reader: BitXReader) -> List[bytes]:
        """Decode a whole container with the array stage bucketed into fused
        device launches: plane frames entropy-decode across the pool
        (order-preserving map), bases resolve serially, then ONE
        ``merge_planes_xor_batch`` / ``merge_planes_batch`` call covers every
        bitx / zipnn record; the remaining codecs decode per-record. The
        merges are elementwise, so the output bytes are identical to the
        per-record path."""
        rt = self._codec_runtime
        records = reader.records
        out: List[Optional[bytes]] = [None] * len(records)
        bitx_idx = [i for i, r in enumerate(records) if r.codec == "bitx"]
        zip_idx = [i for i, r in enumerate(records) if r.codec == "zipnn"]

        def planes_for(i: int) -> List[np.ndarray]:
            return [np.frombuffer(rt.decompress(bytes(f)), np.uint8)
                    for f in reader.frames_for(i)]

        idxs = bitx_idx + zip_idx
        pool = self._executor()
        if pool is not None and len(idxs) > 1:
            planes_of = dict(zip(idxs, pool.map(planes_for, idxs)))
        else:
            planes_of = {i: planes_for(i) for i in idxs}
        resolver = self._resolve_tensor_hash
        if bitx_idx:
            items = []
            for i in bitx_idx:
                base = resolver(records[i].base_hash)
                if isinstance(base, (bytes, memoryview)):
                    base = np.frombuffer(base, STR_TO_DTYPE[records[i].dtype_str])
                items.append((planes_of[i], base.reshape(-1)))
            for i, merged in zip(bitx_idx,
                                 self.backend.merge_planes_xor_batch(items)):
                out[i] = np.ascontiguousarray(
                    merged.reshape(records[i].shape)).tobytes()
        if zip_idx:
            items = [(planes_of[i], STR_TO_DTYPE[records[i].dtype_str],
                      records[i].shape) for i in zip_idx]
            for i, merged in zip(zip_idx, self.backend.merge_planes_batch(items)):
                out[i] = np.ascontiguousarray(merged).tobytes()
        for i in range(len(records)):
            if out[i] is None:  # dedup / raw / stored / bitxq (never batched)
                arr = reader.decode_tensor(i, resolver, resolver)
                out[i] = np.ascontiguousarray(arr).tobytes()
        return out

    def _resolve_tensor_hash(self, thash: str, _depth: int = 0) -> np.ndarray:
        """Fetch a tensor from the pool by content hash (dedup/bitx deps),
        through the decoded-tensor LRU."""
        if _depth > 4:
            raise RuntimeError(f"tensor resolution cycle at {thash[:12]}")
        with self._cache_lock:
            hit = self._tensor_cache.get(thash)
        if hit is not None:
            return hit
        key, gen, idx = self.tensor_locations[thash]
        resolver = lambda h: self._resolve_tensor_hash(h, _depth + 1)
        with self._reader_ctx(self.lifecycle.version_path(key, gen)) as reader:
            arr = reader.decode_tensor(idx, resolver, resolver)
        with self._cache_lock:
            self._tensor_cache.put(thash, arr, int(arr.nbytes))
        return arr

    @property
    def retrieval_cache_stats(self) -> Dict[str, int]:
        with self._cache_lock:
            return {"tensor_hits": self._tensor_cache.hits,
                    "tensor_misses": self._tensor_cache.misses,
                    "reader_hits": self._reader_cache.hits,
                    "reader_misses": self._reader_cache.misses}

    # ------------------------------------------------------------------
    # Lifecycle: deletion, refcounted GC, fsck
    # ------------------------------------------------------------------
    def _anchor_vids(self):
        """Container versions directly referenced by live index entries —
        the GC roots. Everything transitively reachable from here survives.
        Iterates an atomic snapshot (list() holds the GIL) so stats readers
        on other threads never race a concurrent ingest's insertions."""
        for key, rec in list(self.file_index.items()):
            if rec["kind"] == "container":
                yield make_vid(key, rec.get("gen", 0))
            elif "ref_gen" in rec:
                yield make_vid(rec["ref"], rec["ref_gen"])

    def delete_file(self, repo_id: str, filename: str) -> bool:
        """Drop a file's index entry. Its container version (if any) stays on
        disk until ``gc()`` proves no dependant pins it. Returns False for
        unknown keys."""
        with self._admin_lock:
            return self._delete_file_locked(repo_id, filename)

    def _delete_file_locked(self, repo_id: str, filename: str) -> bool:
        key = f"{repo_id}/{filename}"
        rec = self.file_index.pop(key, None)
        if rec is None:
            return False
        fhash = rec.get("file_hash")
        if fhash:
            self._release_file_hash(key, fhash)
        self._unbind_base(key, repo_id)
        # tombstone: the delete covered every generation up to the highest
        # this store has ever minted for the key (monotonic, never reused),
        # so a replica holding gen <= that must drop it during anti-entropy
        # while a genuine re-upload (gen above it) clears the marker
        self.lifecycle.record_tombstone(
            key, self.lifecycle.max_gen.get(key, rec.get("gen", 0)), time.time())
        self.stats.n_deleted += 1
        self._gate.bump()
        return True

    def delete_repo(self, repo_id: str) -> int:
        """Drop every file of a repo plus its family/base registrations.
        Containers are reclaimed by the next ``gc()`` once unreferenced."""
        with self._admin_lock:
            return self._delete_repo_locked(repo_id)

    def _delete_repo_locked(self, repo_id: str) -> int:
        prefix = repo_id + "/"
        n = 0
        for key in [k for k in self.file_index if k.startswith(prefix)]:
            if self.delete_file(repo_id, key[len(prefix):]):
                n += 1
        self.metadata_base.pop(repo_id, None)
        self.families.unregister(repo_id)
        return n

    # ------------------------------------------------------------------
    # Replication substrate (mechanism only — the replica-group policy
    # lives in repro.serve.router.StoreRouter): verbatim container
    # adoption, remote tombstone application, quarantine-restore.
    # ------------------------------------------------------------------
    def container_digest(self, key: str, gen: int,
                         allow_quarantined: bool = False) -> str:
        """sha256 of a container version's on-disk bytes — the identity
        anti-entropy verifies before and after shipping (replicas must stay
        bit-identical, not just semantically equal)."""
        v = self.lifecycle.get(key, gen)
        if v is None:
            raise KeyError(f"container version {make_vid(key, gen)} is unknown")
        if v.quarantined and not allow_quarantined:
            raise RuntimeError(f"container version {v.vid} is quarantined")
        digest, _ = sha256_file(v.path)
        return digest

    def adopt_container(self, key: str, gen: int, src_path: str,
                        expected_sha256: Optional[str] = None) -> bool:
        """Copy a replica's container version into this store *verbatim*
        (temp-suffix + atomic rename, sha256-verified against the donor's
        digest) and register it: version graph node, payload pins for
        hashes this store doesn't already resolve, and dependency edges
        rebuilt from the container header — the same scan the v1-index
        upgrade performs. Does NOT touch ``file_index``; pair with
        :meth:`adopt_index_record` for the anchor key. Returns False when
        the version already exists locally (adoption is idempotent)."""
        with self._admin_lock:
            if self.lifecycle.get(key, gen) is not None:
                return False
            dst = self._container_path(key, gen)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            tmp = dst + TMP_SUFFIX
            with open(src_path, "rb") as fin, open(tmp, "wb") as fout:
                while True:
                    chunk = fin.read(1 << 20)
                    if not chunk:
                        break
                    fout.write(chunk)
                fout.flush()
                os.fsync(fout.fileno())
            digest, nbytes = sha256_file(tmp)
            if expected_sha256 and digest != expected_sha256:
                os.remove(tmp)
                raise ValueError(
                    f"adopted container {make_vid(key, gen)} failed sha256 "
                    f"verification ({digest[:12]} != {expected_sha256[:12]})")
            os.replace(tmp, dst)
            with self._gate.write():
                self.lifecycle.register_version(key, gen, dst, nbytes)
                vid = make_vid(key, gen)
                with self._reader_ctx(dst) as reader:
                    for i, r in enumerate(reader.records):
                        if r.codec != "dedup" and r.self_hash:
                            self.tensor_locations.setdefault(
                                r.self_hash, (key, gen, i))
                    for r in reader.records:
                        h = (r.self_hash if r.codec == "dedup"
                             else r.base_hash if r.codec in ("bitx", "bitxq")
                             else "")
                        loc = self.tensor_locations.get(h) if h else None
                        if loc is not None:
                            self.lifecycle.add_edge(vid, make_vid(loc[0], loc[1]))
                self.stats.live_bytes = self.lifecycle.live_bytes()
            return True

    def adopt_index_record(self, key: str, rec: Dict) -> None:
        """Publish a replica's ``file_index`` record for ``key`` locally.
        Container records are re-pathed to this store's copy of the pinned
        generation (which must have been adopted first); ref records
        require their pinned target generation to be live. Registers the
        whole-file hash so future identical uploads dedup here exactly as
        they would on the donor — replicas must keep making the same
        decisions or their containers drift apart."""
        with self._admin_lock:
            rec = dict(rec)
            if rec.get("kind") == "container":
                rec["path"] = self.lifecycle.version_path(key, int(rec["gen"]))
                rec.pop("quarantined", None)
            elif "ref" in rec and not self.lifecycle.exists(
                    rec["ref"], int(rec.get("ref_gen", 0))):
                raise KeyError(
                    f"ref target {make_vid(rec['ref'], rec.get('ref_gen', 0))} "
                    f"not live — ship its closure before the record")
            self._set_index_entry(key, rec)
            fh = rec.get("file_hash")
            if fh:
                self.file_hash_to_key.setdefault(fh, key)
                self.file_dedup.index.setdefault(fh, key)

    def apply_tombstone(self, key: str, gen: int, ts: float) -> bool:
        """Apply a replica's delete marker: drop the local record unless it
        carries a generation ABOVE the tombstone's (a re-upload that
        legitimately supersedes the delete — generations are monotonic per
        key, so the comparison is unambiguous). Returns True when a local
        record was deleted."""
        with self._admin_lock:
            rec = self.file_index.get(key)
            if rec is not None:
                if rec.get("kind") == "container":
                    if rec.get("gen", 0) > gen:
                        return False  # local record supersedes the marker
                elif rec.get("mtime", 0.0) > ts:
                    return False  # ref re-written after the delete was issued
            self.lifecycle.record_tombstone(key, gen, ts)
            if rec is None:
                return False
            repo_id, _, filename = key.rpartition("/")
            deleted = self._delete_file_locked(repo_id, filename)
            # _delete_file_locked stamped a local-max-gen marker; re-merge
            # the incoming one so replicas agree on the covered generation
            self.lifecycle.record_tombstone(key, gen, ts)
            if not any(k.startswith(repo_id + "/") for k in self.file_index):
                self.metadata_base.pop(repo_id, None)
                self.families.unregister(repo_id)
            return deleted

    def restore_version(self, key: str, gen: int, staged_path: str,
                        expected_sha256: Optional[str] = None) -> bool:
        """Quarantine-restore: swap a healthy replica's verbatim container
        bytes (already staged on this filesystem) back in for a quarantined
        version, verify, and return the version to the live set — pins
        re-established, index entry un-flagged, the parked corrupt copy
        deleted. The inverse of fsck's quarantine. Returns False when the
        version isn't quarantined (nothing to heal)."""
        with self._admin_lock:
            v = self.lifecycle.get(key, gen)
            if v is None:
                raise KeyError(f"container version {make_vid(key, gen)} is "
                               f"unknown — adopt it instead of restoring")
            if not v.quarantined:
                return False
            digest, nbytes = sha256_file(staged_path)
            if expected_sha256 and digest != expected_sha256:
                raise ValueError(
                    f"restore of {make_vid(key, gen)} failed sha256 "
                    f"verification ({digest[:12]} != {expected_sha256[:12]})")
            qpath = v.path
            dst = self._container_path(key, gen)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            os.replace(staged_path, dst)  # atomic swap-in
            with self._gate.write():
                with self._cache_lock:
                    self._reader_cache.pop(qpath)
                self.lifecycle.unquarantine(key, gen, dst)
                self.lifecycle.set_nbytes(key, gen, nbytes)
                rec = self.file_index.get(key)
                if (rec is not None and rec.get("kind") == "container"
                        and rec.get("gen", 0) == gen):
                    rec.pop("quarantined", None)
                    rec["path"] = dst
                vid = make_vid(key, gen)
                with self._reader_ctx(dst) as reader:
                    # re-establish the pins quarantine scrubbed (only where
                    # no surviving copy was re-pinned in their place)
                    for i, r in enumerate(reader.records):
                        if r.codec != "dedup" and r.self_hash:
                            self.tensor_locations.setdefault(
                                r.self_hash, (key, gen, i))
                    for r in reader.records:
                        h = (r.self_hash if r.codec == "dedup"
                             else r.base_hash if r.codec in ("bitx", "bitxq")
                             else "")
                        loc = self.tensor_locations.get(h) if h else None
                        if loc is not None:
                            self.lifecycle.add_edge(vid, make_vid(loc[0], loc[1]))
                self.stats.live_bytes = self.lifecycle.live_bytes()
            if qpath != dst:
                try:
                    os.remove(qpath)  # the parked corrupt copy is debris now
                except OSError:
                    pass
            self.save_index()
            return True

    # -- hinted handoff log ------------------------------------------------
    # A quorum write that lands below full fan-out owes the missed replica
    # its bytes. The router records that debt here — one JSON line per
    # hint in ``<root>/hints.jsonl``, beside the index it must survive
    # with — and a background drainer re-ships exactly the hinted keys
    # when the peer's health probe recovers, so a brief outage never
    # requires a full anti-entropy sweep.

    def hints_path(self) -> str:
        return os.path.join(self.root, "hints.jsonl")

    def record_hint(self, peer: str, repo_id: str, filename: str,
                    spool_ref: Optional[str] = None,
                    base: Optional[str] = None) -> str:
        """Durably append one handoff hint (fsync'd before returning: a
        hint that vanished in a crash would silently strand the replica
        until the next full sweep). ``spool_ref`` names a spooled copy of
        the written bytes owned by this hint — dropped with it."""
        with self._hints_lock:
            self._hint_seq += 1
            hid = f"h{os.getpid():x}-{self._hint_seq:x}-{time.time_ns():x}"
            row = {"id": hid, "peer": peer, "repo_id": repo_id,
                   "filename": filename, "spool_ref": spool_ref,
                   "base": base, "ts": time.time()}
            with open(self.hints_path(), "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")
                f.flush()
                os.fsync(f.fileno())
            return hid

    def pending_hints(self, peer: Optional[str] = None) -> List[Dict]:
        """All recorded hints (optionally for one peer), oldest first. A
        torn final line (crash mid-append) is skipped, not fatal — the
        write that owned it never got its hint id back."""
        out: List[Dict] = []
        with self._hints_lock:
            try:
                with open(self.hints_path(), "r", encoding="utf-8") as f:
                    lines = f.readlines()
            except OSError:
                return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue  # torn tail from a crash mid-append
            if peer is None or row.get("peer") == peer:
                out.append(row)
        return out

    def drop_hints(self, hint_ids: Sequence[str]) -> int:
        """Atomically rewrite the log without ``hint_ids`` (tmp+replace,
        same discipline as the index) and delete their spooled copies.
        Returns how many hints were actually dropped."""
        drop = set(hint_ids)
        if not drop:
            return 0
        dropped = 0
        refs: List[str] = []
        with self._hints_lock:
            try:
                with open(self.hints_path(), "r", encoding="utf-8") as f:
                    lines = f.readlines()
            except OSError:
                return 0
            keep: List[str] = []
            for line in lines:
                s = line.strip()
                if not s:
                    continue
                try:
                    row = json.loads(s)
                except ValueError:
                    continue
                if row.get("id") in drop:
                    dropped += 1
                    if row.get("spool_ref"):
                        refs.append(row["spool_ref"])
                else:
                    keep.append(s)
            tmp = self.hints_path() + TMP_SUFFIX
            with open(tmp, "w", encoding="utf-8") as f:
                f.write("".join(k + "\n" for k in keep))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.hints_path())
        for ref in refs:
            try:
                os.remove(ref)
            except OSError:
                pass
        return dropped

    def _fault(self, point: str) -> None:
        """Crash-injection boundary: the recovery harness installs
        ``fault_hook`` and raises from it to simulate a kill at ``point``.
        Disk-side crash consistency is by *ordering* (container writes are
        temp+rename; the index is persisted before retired files are
        unlinked), so no cleanup handlers run when the hook raises — the
        on-disk state is exactly what a real crash would leave. The store
        instance may be mid-mutation afterwards; recover by reopening from
        the root, as a restarted process would."""
        if self.fault_hook is not None:
            self.fault_hook(point)

    def gc(self, *, incremental: bool = False, max_pause_ms: float = 50.0,
           persist: Optional[bool] = None) -> Dict[str, int]:
        """Reclaim every container version unreachable from live index
        entries (cascading refcount sweep), delete the files, scrub tensor
        hashes that pointed into them, and evict stale mmap readers.

        **Stop-the-world (default):** holds the admin lock (mutual
        exclusion with ingest batches, deletes and fsck) and then the write
        gate for the whole sweep: in-flight retrievals finish on the pre-gc
        state first (they can never be handed a reclaimed generation),
        retrievals arriving during the sweep wait the few milliseconds it
        takes — the serving layer's snapshot isolation. Both modes persist
        the index (``persist``, default True) *before* unlinking the
        reclaimed files, so the on-disk index never references a deleted
        container — the crash-ordering invariant shared with
        :meth:`compact`.

        **Incremental (``incremental=True``):** the sweep runs as a series
        of :meth:`gc_step` calls that interleave with ingest and serving —
        the admin lock is released between steps (a waiting ingest batch
        gets in) and the write gate is held only for each step's bounded
        reclaim window (target ``max_pause_ms``; the mark phase runs
        outside the gate, so readers keep decoding through it). Each step
        re-marks against the then-current graph, persists the resumable
        cursor + graph to the index (``persist``, default True) *before*
        unlinking the step's files, and records its exclusive hold in
        ``stats.gc_max_pause_ms``. Returns the aggregate sweep dict
        (``steps``, ``max_pause_ms`` on top of the stop-the-world keys).
        """
        if not incremental:
            with self._admin_lock:
                with self._gate.write():
                    out, reclaimed = self._gc_locked()
                self.lifecycle.prune_tombstones(time.time(), TOMBSTONE_TTL_S)
                if persist is None or persist:
                    self.save_index()
                # unlink AFTER the persist (crash window closed) and outside
                # the gate: reclaimed versions are unreachable through
                # tensor_locations the moment the gate drops, and evicted
                # readers are pin-counted
                for v in reclaimed:
                    try:
                        os.remove(v.path)
                    except OSError:
                        pass
            self._maybe_auto_compact()
            return out
        agg = {"collected": 0, "reclaimed_bytes": 0, "dropped_tensor_refs": 0,
               "steps": 0, "max_pause_ms": 0.0}
        while True:
            step = self.gc_step(max_pause_ms=max_pause_ms,
                                persist=persist if persist is not None else True)
            agg["steps"] += 1
            agg["collected"] += step["collected"]
            agg["reclaimed_bytes"] += step["reclaimed_bytes"]
            agg["dropped_tensor_refs"] += step["dropped_tensor_refs"]
            agg["max_pause_ms"] = max(agg["max_pause_ms"], step["pause_ms"])
            if step["done"]:
                break
        agg["live_bytes"] = self.stats.live_bytes
        self._maybe_auto_compact()
        return agg

    def _maybe_auto_compact(self) -> Optional[Dict]:
        """Evaluate the auto-compaction watermark after a completed gc
        sweep; chain into :meth:`compact` when it trips. A no-op unless the
        store was built with an :class:`AutoCompactPolicy` — compact()
        stays admin-only by default, so crash-injection tests that kill gc
        mid-sweep see exactly the pre-existing fault surface."""
        self._gc_since_compact += 1
        pol = self.auto_compact
        if pol is None:
            return None
        with self._admin_lock:
            superseded = max(
                0, self._compactable_superseded_bytes() - self._compact_floor)
            live = self.lifecycle.live_bytes()
            if not pol.should_compact(superseded, live, self._gc_since_compact):
                return None
            rep = self.compact()
        self.stats.auto_compact_runs += 1
        return rep

    def gc_step(self, max_pause_ms: float = 50.0,
                persist: bool = True) -> Dict:
        """One bounded step of the incremental sweep (see :meth:`gc`).

        Marks reachability *without* the write gate (the admin lock
        excludes every mutator; retrievals only read the graph), then holds
        the gate exclusively just long enough to retire a batch of
        unreachable versions — the batch is cut when the ``max_pause_ms``
        budget is spent, always making progress (at least one version),
        and the pool-wide pin scrub runs after the gate drops so the
        exclusive hold is O(victims), not O(pool).
        The resumable cursor (last retired vid, persisted in the v3 index)
        rotates the start point so a long backlog is drained fairly across
        steps and a restarted store resumes where the crash left it.
        Files are unlinked *after* the index is persisted (and outside the
        gate — evicted readers are pin-counted, and retired versions are
        unreachable through ``tensor_locations`` the moment the gate
        drops), so the on-disk index never references a deleted container.
        """
        with self._admin_lock:
            return self._gc_step_locked(max_pause_ms, persist)

    def _gc_step_locked(self, max_pause_ms: float, persist: bool) -> Dict:
        self._fault("gc.step.begin")
        roots = self.lifecycle.gc_roots(self._anchor_vids())
        live = self.lifecycle.reachable(roots)
        garbage = sorted(vid for vid, v in self.lifecycle.versions.items()
                         if vid not in live and not v.quarantined)
        out = {"collected": 0, "reclaimed_bytes": 0, "dropped_tensor_refs": 0,
               "pause_ms": 0.0, "remaining": 0, "done": True}
        if not garbage:
            self._gc_cursor = ""
            self.lifecycle.n_gc_runs += 1  # a completed (possibly empty) sweep
            return out
        # resume after the cursor, wrapping (vids sort stably; a vid that
        # equals the cursor was already retired, so bisect_right is exact)
        start = bisect.bisect_right(garbage, self._gc_cursor) % len(garbage)
        ordered = garbage[start:] + garbage[:start]
        budget = max(max_pause_ms, 0.0) / 1000.0
        victims: List = []
        t0 = time.perf_counter()
        with self._gate.write():
            for vid in ordered:
                v = self.lifecycle.versions.get(vid)
                if v is None:
                    continue
                self.lifecycle.retire(v.key, v.gen)
                with self._cache_lock:
                    self._reader_cache.pop(v.path)
                victims.append(v)
                if time.perf_counter() - t0 >= budget:
                    break
        pause_ms = round((time.perf_counter() - t0) * 1000.0, 3)
        # The O(pool) pin scrub runs OUTSIDE the exclusive hold, keeping the
        # pause O(victims) regardless of pool size: the retired versions
        # were unreachable from every anchor, so no live record can resolve
        # into them — a reader between gate-drop and scrub would need a pin
        # no retrieval path ever reaches (and ingest, which could mint new
        # dedup records against stale pins, is excluded by the admin lock).
        dead = {(v.key, v.gen) for v in victims}
        stale = [h for h, (k, g, _) in self.tensor_locations.items()
                 if (k, g) in dead]
        for h in stale:
            del self.tensor_locations[h]
            self.tensor_dedup.forget(h)
        freed = sum(v.nbytes for v in victims)
        self.stats.reclaimed_bytes += freed
        self.stats.live_bytes = self.lifecycle.live_bytes()
        self.stats.gc_max_pause_ms = max(self.stats.gc_max_pause_ms, pause_ms)
        remaining = len(ordered) - len(victims)
        if remaining:
            self._gc_cursor = victims[-1].vid
        else:
            self._gc_cursor = ""
            self.lifecycle.n_gc_runs += 1
        self._fault("gc.step.after_commit")
        if persist:
            self.save_index()
        self._fault("gc.step.after_index")
        for v in victims:
            try:
                os.remove(v.path)
            except OSError:
                pass
        self._fault("gc.step.after_unlink")
        out.update({"collected": len(victims), "reclaimed_bytes": freed,
                    "dropped_tensor_refs": len(stale),
                    "pause_ms": pause_ms, "remaining": remaining,
                    "done": remaining == 0})
        return out

    # ------------------------------------------------------------------
    # Compaction: dedup-aware rebalancing of superseded generations
    # ------------------------------------------------------------------
    def compact(self, *, persist: bool = True) -> Dict:
        """Rewrite still-referenced tensor records out of superseded
        generations and retire those generations entirely.

        After churn (re-registration chains, ``delete_repo``, gc) payload
        tensors stay pinned inside superseded ``key@gN`` containers: the
        generation is live only because some dependant's dedup record or
        BitX base reference resolves into it, while the rest of its bytes
        are dead weight gc cannot touch. ``compact()``:

        1. **Marks** the anchored versions (live index entries) and scans
           their records for every dedup target and BitX base hash —
           the authoritative reference set.
        2. **Plans** the transitive closure of needed hashes whose pinned
           payload lives in a superseded generation (a copied BitX record
           needs its base hash too, which may sit in another superseded
           generation — the closure chases the whole chain, and kept
           generations' own reference sets feed back into it, to a
           fixpoint). Frames are copied **verbatim** (same codec, same
           bytes — content-addressed base references keep resolving), so
           the BitX math is untouched and the rewrite is bit-preserving by
           construction.
        3. **Skips** any *pure-payload* superseded generation (no
           dedup-record baggage) whose every record is pinned-here and
           needed: copying it would only relocate bytes. This is what
           makes ``compact()`` idempotent — the compact pool's own
           previous output is exactly such a container, skipped until
           dependants die and parts of it go dead.
        4. **Writes** the surviving records into a fresh
           ``.compact/pool@gN`` container (temp-suffix + atomic rename,
           fsync'd — crash-safe at every instant).
        5. **Commits** under one exclusive write-gate hold: registers the
           new version, re-pins ``tensor_locations`` to it, rebuilds the
           scanned survivors' edge sets from the authoritative scan,
           retires the superseded generations and scrubs their dropped
           pins. In-flight retrievals finish on the pre-compact snapshot;
           the hold is pointer swaps only (reported as
           ``exclusive_hold_ms``) — the byte copying in step 4 ran outside
           the gate, concurrent with serving.
        6. **Persists** the index (``persist=True``), then unlinks the
           retired files — the on-disk index never references a deleted
           container, so a crash anywhere leaves either the old state plus
           an orphan compact container, or the new state plus orphan
           retired files; ``fsck(repair=True)`` deletes either kind of
           debris and every live file stays retrievable (proven by the
           crash-injection harness).

        ``file_dedup`` / near-dup index entries anchor their pinned target
        generations, so compaction never moves or retires a version such an
        entry resolves through (re-verified post-commit by fsck's index
        pass). Holds the admin lock: mutually exclusive with ingest
        batches, deletes, gc and fsck; concurrent *retrievals* run
        throughout except for step 5's bounded hold.
        """
        with self._admin_lock:
            rep = self._compact_locked(persist)
            self._gc_since_compact = 0  # the every-N-sweeps backstop restarts
            self._compact_floor = self._compactable_superseded_bytes()
            return rep

    def _compact_locked(self, persist: bool) -> Dict:
        self._fault("compact.begin")
        anchored = set(self._anchor_vids())
        # quarantined versions cannot be re-scanned (their bytes are parked
        # and possibly corrupt): protect everything their recorded edges
        # reach, exactly like the gc quarantine guarantee
        qroots = [vid for vid, v in self.lifecycle.versions.items()
                  if v.quarantined]
        protected = self.lifecycle.reachable(qroots)
        superseded = {vid: v for vid, v in self.lifecycle.versions.items()
                      if vid not in anchored and vid not in protected
                      and not v.quarantined}
        report = {"superseded_versions": len(superseded),
                  "superseded_bytes": sum(v.nbytes for v in superseded.values()),
                  "moved_records": 0, "moved_bytes": 0,
                  "retired_versions": 0, "skipped_versions": 0,
                  "reclaimed_bytes": 0, "net_reclaimed_bytes": 0,
                  "dropped_pins": 0, "unresolved_refs": 0,
                  "container": None, "exclusive_hold_ms": 0.0}
        if not superseded:
            return report

        # -- step 1: authoritative reference scan of the anchored versions
        dep_hashes: Dict[str, List[str]] = {}
        for vid in sorted(anchored):
            v = self.lifecycle.versions.get(vid)
            if v is None or v.quarantined:
                continue
            try:
                with self._reader_ctx(v.path) as reader:
                    hs = []
                    for rec in reader.records:
                        if rec.codec == "dedup":
                            hs.append(rec.self_hash)
                        elif rec.codec in ("bitx", "bitxq"):
                            hs.append(rec.base_hash)
            except (OSError, ValueError, AssertionError) as e:
                # an unreadable anchored container means its reference set
                # is unknown — retiring anything could destroy payloads it
                # needs. fsck will quarantine it (quarantine edges then
                # protect its dependencies) and compact becomes safe again.
                raise RuntimeError(
                    f"compact: anchored container {vid} is unreadable ({e}); "
                    f"run fsck(repair=True) first") from e
            dep_hashes[vid] = hs

        # -- step 2+3: plan which records move and which generations are
        # kept, to a fixpoint. The needed-hash closure is seeded by the
        # anchored reference sets PLUS the reference sets of every kept
        # superseded generation (a kept generation's dedup/base refs must
        # keep resolving after its neighbours are retired), and a
        # generation is kept when either
        #   * it holds an unaccountable pin (``bad``: never retire bytes we
        #     could not prove dead) — everything its recorded edges reach
        #     is then kept too, exactly like the gc quarantine guarantee; or
        #   * it is *pure payload* (no dedup-record baggage) and every
        #     record is pinned-here and needed — copying it would relocate,
        #     not reclaim. This is what makes compact() idempotent: its own
        #     pool output is exactly such a container until dependants die.
        # Keeping a generation can grow the needed set, which can flip
        # another generation to fully-needed; both kept-sets only grow, so
        # the loop terminates.
        sup_records: Dict[str, List] = {}
        bad_gens: set = set()
        for vid, v in superseded.items():
            try:
                with self._reader_ctx(v.path) as reader:
                    sup_records[vid] = list(reader.records)
            except (OSError, ValueError, AssertionError):
                bad_gens.add(vid)

        def deps_of(vid: str) -> List[str]:
            return [r.self_hash if r.codec == "dedup" else r.base_hash
                    for r in sup_records.get(vid, ())
                    if r.codec in ("dedup", "bitx", "bitxq")]

        anchor_seed = [h for hs in dep_hashes.values() for h in hs]
        skipped: set = set()
        while True:
            kept = (set(superseded) & self.lifecycle.reachable(bad_gens)) | skipped
            move_src: Dict[str, Tuple[str, int, int]] = {}  # hash->(key,gen,idx)
            unresolved = 0
            grew_bad = False
            needed: set = set()
            work = deque(anchor_seed)
            for vid in kept:
                work.extend(deps_of(vid))
            while work:
                h = work.popleft()
                if h in needed:
                    continue
                needed.add(h)
                loc = self.tensor_locations.get(h)
                if loc is None:
                    unresolved += 1  # pre-existing dangling ref: fsck territory
                    continue
                k, g, i = loc
                vid = make_vid(k, g)
                if vid not in superseded or vid in kept:
                    continue  # payload lives in a survivor already
                recs = sup_records.get(vid)
                rec = recs[i] if recs is not None and i < len(recs) else None
                if rec is None or rec.codec == "dedup" or rec.self_hash != h:
                    # pin does not name the payload it claims — keep the
                    # whole generation rather than retire unaccounted bytes
                    unresolved += 1
                    if vid not in bad_gens:
                        bad_gens.add(vid)
                        grew_bad = True
                    continue
                if rec.codec in ("bitx", "bitxq"):
                    work.append(rec.base_hash)
                move_src[h] = (k, g, i)
            if grew_bad:
                continue  # protection set changed: replan
            by_src: Dict[str, List[str]] = {}
            for h, (k, g, _) in move_src.items():
                by_src.setdefault(make_vid(k, g), []).append(h)
            new_skips = set()
            for vid, hashes in by_src.items():
                v = superseded[vid]
                recs = sup_records[vid]
                pinned_here = sum(
                    1 for i, r in enumerate(recs)
                    if r.codec != "dedup"
                    and self.tensor_locations.get(r.self_hash) == (v.key, v.gen, i))
                if (all(r.codec != "dedup" for r in recs)
                        and len(hashes) == pinned_here == len(recs)):
                    new_skips.add(vid)
            if new_skips <= skipped:
                break
            skipped |= new_skips
        retire_vids = set(superseded) - kept
        # kept-but-readable generations get their edges rebuilt from their
        # actual reference sets, same as the anchored survivors (their
        # bases may move into the compact pool; a stale edge would let a
        # later gc collect the pool out from under them). Unreadable (bad)
        # generations keep their recorded edges, whose targets are all kept.
        for vid in kept:
            if vid in sup_records:
                dep_hashes[vid] = deps_of(vid)
        report["skipped_versions"] = len(kept)
        report["unresolved_refs"] = unresolved
        if not retire_vids and not move_src:
            return report

        # -- step 4: write the compact container (outside the gate; the
        # copy order is deterministic: source vid, then record index)
        gen = cpath = cvid = None
        new_locs: Dict[str, int] = {}
        stored = 0
        writer = None
        if move_src:
            order = sorted(move_src.items(),
                           key=lambda kv: (make_vid(kv[1][0], kv[1][1]), kv[1][2]))
            gen = self.lifecycle.next_generation(COMPACT_KEY)
            cpath = self._container_path(COMPACT_KEY, gen)
            writer = BitXWriter(level=self.zstd_level, threads=self.zstd_threads,
                                backend=self.backend)
            writer.file_metadata.update({
                "compact": True,
                "sources": sorted({make_vid(k, g)
                                   for (k, g, _) in move_src.values()}),
            })
            for h, (k, g_src, i) in order:
                with self._reader_ctx(self.lifecycle.version_path(k, g_src)) as r:
                    rec = r.records[i]
                    frames = [bytes(f) for f in r.frames_for(i)]
                new_locs[h] = len(writer.records)
                writer.add_precomputed(rec.name, rec.dtype_str, rec.shape,
                                       rec.codec, rec.base_hash, rec.self_hash,
                                       frames, rec.raw_size,
                                       extras={"base_dtype": rec.base_dtype,
                                               "qscale_bits": rec.qscale_bits,
                                               "qzero_point": rec.qzero_point}
                                       if rec.codec == "bitxq" else None)
            os.makedirs(os.path.dirname(cpath), exist_ok=True)
            stored = writer.write(cpath, fault_hook=self._fault
                                  if self.fault_hook else None, fsync=True)

        # -- step 5: commit — one exclusive hold, pointer swaps only
        retire = [superseded[vid] for vid in sorted(retire_vids)]
        t_excl = time.perf_counter()
        with self._gate.write():
            if move_src:
                self.lifecycle.register_version(COMPACT_KEY, gen, cpath, stored)
                cvid = make_vid(COMPACT_KEY, gen)
                for h, idx in new_locs.items():
                    self.tensor_locations[h] = (COMPACT_KEY, gen, idx)
                for rec in writer.records:
                    if rec.codec in ("bitx", "bitxq"):
                        loc = self.tensor_locations.get(rec.base_hash)
                        if loc is not None:
                            self.lifecycle.add_edge(cvid, make_vid(loc[0], loc[1]))
            # survivors' edges, rebuilt from the step-1 scan (more precise
            # than the accumulated ingest/repair edges — and required, or
            # stale edges into retired gens would pin them in later sweeps)
            for vid, hs in dep_hashes.items():
                dsts = set()
                for h in hs:
                    loc = self.tensor_locations.get(h)
                    if loc is not None:
                        dsts.add(make_vid(loc[0], loc[1]))
                dsts.discard(vid)
                if dsts:
                    self.lifecycle.edges[vid] = dsts
                else:
                    self.lifecycle.edges.pop(vid, None)
            freed = 0
            for v in retire:
                self.lifecycle.retire(v.key, v.gen)
                freed += v.nbytes
                with self._cache_lock:
                    self._reader_cache.pop(v.path)
        hold_ms = (time.perf_counter() - t_excl) * 1000.0
        # pool-wide pin scrub outside the exclusive hold (same argument as
        # gc_step: every needed hash was re-pinned above, so the remaining
        # pins into retired generations are unreachable from any retrieval
        # path, and ingest is excluded by the admin lock)
        dead = {(v.key, v.gen) for v in retire}
        stale = [h for h, (k, g, _) in self.tensor_locations.items()
                 if (k, g) in dead]
        for h in stale:
            del self.tensor_locations[h]
            self.tensor_dedup.forget(h)

        self.stats.reclaimed_bytes += freed
        self.stats.compaction_reclaimed_bytes += freed - stored
        self.stats.compact_runs += 1
        self.stats.live_bytes = self.lifecycle.live_bytes()
        self._fault("compact.after_commit")
        # -- step 6: persist, THEN unlink (crash between the two leaves the
        # retired files as orphans for fsck, never a dangling index)
        if persist:
            self.save_index()
        self._fault("compact.after_index")
        for v in retire:
            try:
                os.remove(v.path)
            except OSError:
                pass
        self._fault("compact.after_unlink")
        report.update({"moved_records": len(move_src), "moved_bytes": stored,
                       "retired_versions": len(retire),
                       "reclaimed_bytes": freed,
                       "net_reclaimed_bytes": freed - stored,
                       "dropped_pins": len(stale), "container": cvid,
                       "exclusive_hold_ms": round(hold_ms, 3)})
        return report

    def _gc_locked(self) -> Tuple[Dict[str, int], List]:
        """In-memory half of the stop-the-world sweep (runs under the write
        gate); the caller persists the index and unlinks the returned
        versions' files afterwards."""
        reclaimed = self.lifecycle.collect(set(self._anchor_vids()))
        dropped_refs = 0
        if reclaimed:
            dead = {(v.key, v.gen) for v in reclaimed}
            stale = [h for h, (k, g, _) in self.tensor_locations.items()
                     if (k, g) in dead]
            for h in stale:
                del self.tensor_locations[h]
                self.tensor_dedup.forget(h)
            dropped_refs = len(stale)
            with self._cache_lock:
                for v in reclaimed:
                    self._reader_cache.pop(v.path)  # generation-aware eviction
        freed = sum(v.nbytes for v in reclaimed)
        self.stats.reclaimed_bytes += freed
        self.stats.live_bytes = self.lifecycle.live_bytes()
        return ({"collected": len(reclaimed), "reclaimed_bytes": freed,
                 "dropped_tensor_refs": dropped_refs,
                 "live_bytes": self.stats.live_bytes}, reclaimed)

    def fsck(self, repair: bool = False, spot_check: Optional[int] = 4) -> FsckReport:
        """Verify the store's reference graph and container integrity.

        Per live container version: structural checks (magic/header parse,
        payload truncation) and, for every dedup record and BitX base
        reference, that the hash resolves through ``tensor_locations`` to a
        live container frame holding the same hash. ``spot_check`` payload
        records per container (None = all) are additionally decoded and
        sha256-verified against their self_hash. Index entries must point at
        live generations.

        ``repair=True``: dangling tensor hashes are re-pinned to a surviving
        copy when any live container still holds that payload; corrupt
        containers are quarantined (moved to ``<root>/quarantine``, index
        entries flagged, graph node kept so dependants stay repairable).

        Takes the admin lock (mutual exclusion with ingest/delete/gc).
        """
        with self._admin_lock:
            report = self._fsck_locked(repair, spot_check)
            # repaired/quarantined only — NOT bare orphan sightings: fsck on
            # a store whose index was never loaded refuses the orphan wipe,
            # and persisting that empty in-memory index would BE the wipe
            if repair and (report.repaired or report.quarantined):
                # Persist what repair changed. Quarantine in particular
                # moves the container file and scrubs its tensor pins IN
                # MEMORY — without this, a restarted (or routed) store
                # reloads the pre-repair index whose pins still reference
                # the quarantined generation at its vanished path, and the
                # stale state only heals at the next gc's persist.
                self.save_index()
            return report

    def _fsck_locked(self, repair: bool, spot_check: Optional[int]) -> FsckReport:
        report = FsckReport()
        alt: Optional[Dict[str, Tuple[str, int, int]]] = None

        def check_ref(owner: str, thash: str, role: str) -> None:
            nonlocal alt
            report.checked_refs += 1
            if self._hash_resolves(thash):
                return
            if repair:
                if alt is None:
                    alt = self._payload_locations()
                loc = alt.get(thash)
                if loc is not None:
                    self.tensor_locations[thash] = loc
                    # the re-pinned target must survive the next gc(): record
                    # the dependency edge the original ingest would have
                    self.lifecycle.add_edge(owner, make_vid(loc[0], loc[1]))
                    report.repaired.append(
                        (owner, f"{role} {thash[:12]} re-pinned to "
                                f"{make_vid(loc[0], loc[1])}:{loc[2]}"))
                    return
            report.dangling.append(
                (owner, f"{role} {thash[:12]} does not resolve to a live "
                        f"container frame"))

        # pass 1: container integrity (quarantines under repair). Runs to
        # completion BEFORE any reference checks so a dependant's refs are
        # judged against the post-quarantine state — a single fsck pass both
        # quarantines a corrupt target and repairs/reports its dependants.
        for vid in sorted(self.lifecycle.versions):
            info = self.lifecycle.versions[vid]
            if info.quarantined:
                report.quarantined.append(vid)
                continue
            report.checked_versions += 1
            err = self._fsck_version_content(info, report, spot_check)
            if err is not None:
                report.corrupt.append((vid, err))
                if repair:
                    self._quarantine_version(info, report)

        # pass 2: reference resolution over the surviving versions
        for vid in sorted(self.lifecycle.versions):
            info = self.lifecycle.versions[vid]
            if not info.quarantined:
                self._fsck_version_refs(info, check_ref)

        for key in sorted(self.file_index):
            rec = self.file_index[key]
            report.checked_files += 1
            if rec.get("quarantined"):
                continue
            if rec["kind"] == "container":
                if not self.lifecycle.exists(key, rec.get("gen", 0)):
                    report.dangling.append(
                        (key, f"index points at missing version "
                              f"{make_vid(key, rec.get('gen', 0))}"))
            else:
                report.checked_refs += 1
                if not self.lifecycle.exists(rec["ref"], rec["ref_gen"]):
                    report.dangling.append(
                        (key, f"{rec['kind']} ref "
                              f"{make_vid(rec['ref'], rec['ref_gen'])} is not live"))
                elif rec["kind"] == "near_dup" and rec.get("n_tensors") is not None:
                    try:
                        with self._reader_ctx(self._ref_path(rec)) as reader:
                            n_records = len(reader.records)
                    except Exception as e:  # target corrupt: flagged above on
                        # its own version; this entry is dangling meanwhile
                        report.dangling.append(
                            (key, f"near_dup target unreadable: {e}"))
                    else:
                        if n_records != rec["n_tensors"]:
                            report.dangling.append(
                                (key, "near_dup target record count changed"))

        # pass 4 (ROADMAP rung b): orphan scan — container files on disk that
        # no live or quarantined version references. Crash debris from an
        # interrupted ingest; flagged always, deleted under repair=True.
        # ``.bitx.part`` temp files (a container write killed between the
        # temp write and the atomic rename — e.g. a crashed compact()) are
        # crash debris BY CONSTRUCTION, never corruption: the version graph
        # cannot reference a temp path, so they are deletable even when the
        # graph-empty safety below refuses everything else.
        # SAFETY: an empty version graph with containers on disk almost
        # certainly means the index was never loaded — deleting "orphans"
        # then would wipe the whole store, so repair refuses and reports.
        known = {os.path.abspath(v.path) for v in self.lifecycle.versions.values()}
        croot = os.path.join(self.root, "containers")
        for dirpath, _, files in os.walk(croot):
            for fn in sorted(files):
                p = os.path.abspath(os.path.join(dirpath, fn))
                is_temp = fn.endswith(".bitx" + TMP_SUFFIX)
                if not (fn.endswith(".bitx") or is_temp) or p in known:
                    continue
                report.orphans.append(p)
                if repair and not known and not is_temp:
                    report.dangling.append(
                        (p, "orphan delete refused: version graph is empty "
                            "(index not loaded?)"))
                elif repair:
                    try:
                        os.remove(p)
                    except OSError as e:
                        report.dangling.append((p, f"orphan delete failed: {e}"))
                    else:
                        report.repaired.append((p, "orphan container deleted"))

        # decoded-spill debris: the serving layer's two-tier response cache
        # spills decoded objects under ``.decoded/`` with the same
        # temp+rename discipline as containers, so a ``.part`` file there is
        # crash debris BY CONSTRUCTION (a spill killed mid-write — nothing
        # references it). Finished spill files are live cache state owned by
        # a possibly-running server (wiped on engine construction), so the
        # scan leaves them alone.
        droot = os.path.join(self.root, ".decoded")
        if os.path.isdir(droot):
            for fn in sorted(os.listdir(droot)):
                if not fn.endswith(TMP_SUFFIX):
                    continue
                p = os.path.abspath(os.path.join(droot, fn))
                report.orphans.append(p)
                if repair:
                    try:
                        os.remove(p)
                    except OSError as e:
                        report.dangling.append(
                            (p, f"orphan delete failed: {e}"))
                    else:
                        report.repaired.append(
                            (p, "decoded-spill temp deleted"))

        # spool transfer debris: peer replication stages shipped container
        # bytes as ``.spool/*.part`` (resumable adopt/fetch uploads). A
        # surviving ``.part`` there is a transfer killed mid-body — nothing
        # references it, and the shipping protocol restarts from offset 0
        # after a 409 re-sync, so deleting it only costs the resume.
        # Finished spool files (fan-out copies, pending ingests) are owned
        # by their enqueue jobs and stay untouched.
        sroot = self.spool_dir()
        if os.path.isdir(sroot):
            for fn in sorted(os.listdir(sroot)):
                if not fn.endswith(TMP_SUFFIX):
                    continue
                p = os.path.abspath(os.path.join(sroot, fn))
                report.orphans.append(p)
                if repair:
                    try:
                        os.remove(p)
                    except OSError as e:
                        report.dangling.append(
                            (p, f"orphan delete failed: {e}"))
                    else:
                        report.repaired.append(
                            (p, "spool transfer temp deleted"))
        return report

    def _hash_resolves(self, thash: str) -> bool:
        loc = self.tensor_locations.get(thash)
        if loc is None:
            return False
        key, gen, idx = loc
        if not self.lifecycle.exists(key, gen):
            return False
        try:
            with self._reader_ctx(self.lifecycle.version_path(key, gen)) as reader:
                return (idx < len(reader.records)
                        and reader.records[idx].self_hash == thash)
        except (KeyError, RuntimeError, OSError, ValueError, AssertionError):
            return False

    def _payload_locations(self) -> Dict[str, Tuple[str, int, int]]:
        """hash -> (key, gen, idx) over every live version's payload-bearing
        records — the re-pin candidates for fsck repair."""
        out: Dict[str, Tuple[str, int, int]] = {}
        for info in self.lifecycle.versions.values():
            if info.quarantined:
                continue
            try:
                with self._reader_ctx(info.path) as reader:
                    for i, r in enumerate(reader.records):
                        if r.codec != "dedup":
                            out.setdefault(r.self_hash, (info.key, info.gen, i))
            except (OSError, ValueError, AssertionError):
                continue
        return out

    def _fsck_version_refs(self, info, check_ref) -> None:
        """Reference pass: every dedup target and BitX base hash of this
        version must resolve to a live container frame."""
        try:
            with self._reader_ctx(info.path) as reader:
                records = list(reader.records)
        except Exception:
            return  # already reported corrupt by the content pass
        vid = info.vid
        for r in records:
            if r.codec == "dedup":
                check_ref(vid, r.self_hash, "dedup target")
            elif r.codec in ("bitx", "bitxq"):
                check_ref(vid, r.base_hash, f"{r.codec} base")

    def _fsck_version_content(self, info, report: FsckReport,
                              spot_check: Optional[int]) -> Optional[str]:
        """Structural + sampled-sha256 checks for one version. Returns an
        error string when the container itself is corrupt."""
        if not os.path.exists(info.path):
            return "container file missing"
        try:
            with self._reader_ctx(info.path) as reader:
                return self._spot_check_reader(reader, report, spot_check)
        except Exception as e:  # bad magic, short header, backend mismatch...
            return f"unreadable container: {e}"

    def _spot_check_reader(self, reader: BitXReader, report: FsckReport,
                           spot_check: Optional[int]) -> Optional[str]:
        if reader.payload_size < reader.expected_payload_size:
            return (f"truncated payload: {reader.payload_size} < "
                    f"{reader.expected_payload_size} bytes")
        to_spot = [i for i, r in enumerate(reader.records) if r.codec != "dedup"]
        if spot_check is not None:
            to_spot = to_spot[:spot_check]
        for i in to_spot:
            r = reader.records[i]
            if r.codec in ("bitx", "bitxq"):
                # blame attribution: verify the DEPENDENCY first. A corrupt
                # or quarantined base must be flagged on its own version —
                # never cascade onto this (healthy) dependant.
                try:
                    base = self._resolve_tensor_hash(r.base_hash)
                    if sha256_bytes(np.ascontiguousarray(base).tobytes()) != r.base_hash:
                        continue  # base bit rot — its own version answers for it
                except Exception:
                    continue  # dangling/quarantined/corrupt base — ditto
            try:
                arr = reader.decode_tensor(i, self._resolve_tensor_hash,
                                           self._resolve_tensor_hash)
                data = np.ascontiguousarray(arr).tobytes()
            except (KeyError, RuntimeError):
                continue  # unresolvable dependency — already reported by check_ref
            except Exception as e:
                return f"record {i} ({r.name}): decode failed: {e}"
            report.spot_checked += 1
            if sha256_bytes(data) != r.self_hash:
                return f"record {i} ({r.name}): sha256 mismatch (bit rot?)"
        return None

    def _quarantine_version(self, info, report: FsckReport) -> None:
        qdir = os.path.join(self.root, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        qpath = os.path.join(qdir, info.vid.replace("/", "__"))
        with self._gate.write():  # no in-flight reader sees the file move
            with self._cache_lock:
                self._reader_cache.pop(info.path)
            if os.path.exists(info.path):
                os.replace(info.path, qpath)
            self.lifecycle.quarantine(info.key, info.gen, qpath)
            rec = self.file_index.get(info.key)
            if (rec is not None and rec.get("kind") == "container"
                    and rec.get("gen", 0) == info.gen):
                rec["quarantined"] = True
            # scrub pool hashes pinned to the quarantined payload: future
            # ingests must re-store those tensors fresh, never dedup against
            # a container that retrieval refuses to read. fsck's reference
            # pass re-pins surviving dependants to other live copies where
            # possible.
            self._scrub_tensor_pins(info.key, info.gen)
            report.quarantined.append(info.vid)
            self.stats.live_bytes = self.lifecycle.live_bytes()

    def _superseded_bytes(self) -> int:
        """Bytes held by pinned-but-superseded generations — live only
        because some dependant still resolves into them. Snapshot-safe for
        the same reason as :meth:`_anchor_vids` (the serving /stats route
        calls this while ingest runs)."""
        anchored = set(self._anchor_vids())
        return sum(v.nbytes for v in list(self.lifecycle.versions.values())
                   if not v.quarantined and v.vid not in anchored)

    def _compactable_superseded_bytes(self) -> int:
        """:meth:`_superseded_bytes` minus compact-pool containers: the
        pool is reachable only through pins (never index-anchored), so it
        always *counts* as superseded — but compact cannot shrink it
        further. The auto-compact watermark must measure what a compaction
        could actually reclaim, or it would re-fire on every sweep."""
        anchored = set(self._anchor_vids())
        return sum(v.nbytes for v in list(self.lifecycle.versions.values())
                   if not v.quarantined and v.vid not in anchored
                   and v.key != COMPACT_KEY)

    # ------------------------------------------------------------------
    # Index persistence: the store survives process restarts (ingest state,
    # tensor pool, family registry, base maps) — a new process can keep
    # ingesting or serve retrievals immediately.
    # ------------------------------------------------------------------
    def save_index(self) -> str:
        def sig_key(sig):
            return json.dumps([[d, list(sh)] for d, sh in sig])
        idx = {
            "format": INDEX_FORMAT,
            "stats": vars(self.stats),
            "gc_cursor": self._gc_cursor,  # v3: resumable incremental-GC sweep
            "lifecycle": self.lifecycle.to_json(),
            "file_index": self.file_index,
            "file_hash_to_key": self.file_hash_to_key,
            "tensor_locations": {k: list(v) for k, v in self.tensor_locations.items()},
            "base_paths": self.base_paths,
            "base_key_of": self.base_key_of,
            "metadata_base": self.metadata_base,
            "file_dedup_index": self.file_dedup.index,
            "file_dedup_stats": self._stats_to_json(self.file_dedup.stats),
            "tensor_dedup": {
                "index": self.tensor_dedup.index,
                "stats": self._stats_to_json(self.tensor_dedup.stats),
            },
            "base_maps": {
                bid: {"path": bm.path,
                      "entries": [[n, d, list(s), h] for n, d, s, h in bm.entries]}
                for bid, bm in self._base_maps.items()
            },
            "families": {sig_key(sig): v for sig, v in self.families.by_sig.items()},
            "n_file_dedup": self.stats.n_file_dedup,
        }
        path = os.path.join(self.root, "index.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(idx, f)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _stats_to_json(stats) -> Dict:
        return {"total_bytes": stats.total_bytes, "unique_bytes": stats.unique_bytes,
                "n_units": stats.n_units, "n_unique": stats.n_unique,
                "unit_sizes": list(stats.unit_sizes)}

    @staticmethod
    def _stats_from_json(stats, d: Dict) -> None:
        stats.total_bytes = int(d.get("total_bytes", 0))
        stats.unique_bytes = int(d.get("unique_bytes", 0))
        stats.n_units = int(d.get("n_units", 0))
        stats.n_unique = int(d.get("n_unique", 0))
        stats.unit_sizes = [int(x) for x in d.get("unit_sizes", [])]

    def load_index(self) -> bool:
        path = os.path.join(self.root, "index.json")
        if not os.path.exists(path):
            return False
        idx = json.load(open(path))
        fmt = int(idx.get("format", 1))
        for k, v in idx["stats"].items():
            setattr(self.stats, k, v)
        self.file_index = idx["file_index"]
        self.file_hash_to_key = idx["file_hash_to_key"]
        self._rebuild_file_hash_map()
        if fmt >= 2:
            self.tensor_locations = {k: tuple(v)
                                     for k, v in idx["tensor_locations"].items()}
            self.lifecycle = ContainerLifecycle.from_json(idx.get("lifecycle", {}))
        else:
            self._upgrade_v1_index(idx)
        # v3 additions (defaulted on v1/v2 loads): the incremental-GC cursor;
        # compaction counters ride along in the generic stats dict above
        self._gc_cursor = idx.get("gc_cursor", "")
        self.base_paths = idx["base_paths"]
        self.base_key_of = idx["base_key_of"]
        self.metadata_base = idx["metadata_base"]
        self.file_dedup.index = idx["file_dedup_index"]
        if "file_dedup_stats" in idx:
            self._stats_from_json(self.file_dedup.stats, idx["file_dedup_stats"])
        td = idx.get("tensor_dedup")
        if td:  # regression fix: dedup index + stats used to be dropped here
            self.tensor_dedup.index = td["index"]
            self._stats_from_json(self.tensor_dedup.stats, td["stats"])
        self._base_maps = {}
        for bid, spec in idx.get("base_maps", {}).items():
            entries = [(n, d, tuple(s), h) for n, d, s, h in spec["entries"]]
            self._base_maps[bid] = _BaseTensorMap(spec["path"], entries)
        def sig_unkey(k):
            return tuple((d, tuple(sh)) for d, sh in json.loads(k))
        self.families.by_sig = {sig_unkey(k): [tuple(x) for x in v]
                                for k, v in idx["families"].items()}
        return True

    def _upgrade_v1_index(self, idx: Dict) -> None:
        """Backward-compat load of a v1-era index: no generations, 2-tuple
        tensor locations, no lifecycle graph. Every container becomes gen 0
        at its legacy path; pins default to gen 0 and the dependency graph is
        rebuilt by scanning container headers (header parse only, no frame
        decode)."""
        self.tensor_locations = {k: (v[0], 0, v[1])
                                 for k, v in idx["tensor_locations"].items()}
        self.lifecycle = ContainerLifecycle()
        for key, rec in self.file_index.items():
            if rec["kind"] == "container":
                rec.setdefault("gen", 0)
                try:
                    nbytes = os.path.getsize(rec["path"])
                except OSError:
                    nbytes = 0  # missing file: fsck will report it
                self.lifecycle.register_version(key, rec["gen"], rec["path"], nbytes)
            elif rec["kind"] == "file_dedup":
                rec.setdefault("ref_gen", 0)
        for key, rec in self.file_index.items():
            if rec["kind"] != "container":
                continue
            src = make_vid(key, rec["gen"])
            try:
                with self._reader_ctx(rec["path"]) as reader:
                    records = list(reader.records)
            except (OSError, ValueError, AssertionError):
                continue  # unreadable container: fsck will report it
            for r in records:
                h = r.self_hash if r.codec == "dedup" else r.base_hash
                loc = self.tensor_locations.get(h) if h else None
                if loc is not None:
                    self.lifecycle.add_edge(src, make_vid(loc[0], loc[1]))
        self.stats.live_bytes = self.lifecycle.live_bytes()

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        return {
            "array_backend": self.backend.name,
            # kernel launches and host<->device bytes (a backend without
            # counters, such as the numpy host path, reports none)
            "backend_counters": (self.backend.counters()
                                 if hasattr(self.backend, "counters") else {}),
            "n_files": self.stats.n_files,
            "raw_bytes": self.stats.raw_bytes,
            "stored_bytes": self.stats.stored_bytes,
            "reduction_ratio": round(self.stats.reduction_ratio, 4),
            "file_dedup_hits": self.stats.n_file_dedup,
            "near_dup_hits": self.stats.n_near_dup,
            "lifecycle": {
                "versions": len(self.lifecycle.versions),
                "live_bytes": self.lifecycle.live_bytes(),
                "superseded_bytes": self._superseded_bytes(),
                "reclaimed_bytes": self.stats.reclaimed_bytes,
                "collected": self.lifecycle.n_collected,
                "gc_runs": self.lifecycle.n_gc_runs,
                "deleted_files": self.stats.n_deleted,
                "compact_runs": self.stats.compact_runs,
                "auto_compact_runs": self.stats.auto_compact_runs,
                "compaction_reclaimed_bytes": self.stats.compaction_reclaimed_bytes,
                "gc_max_pause_ms": round(self.stats.gc_max_pause_ms, 3),
                "tombstones": len(self.lifecycle.tombstones),
                "quarantined": sum(1 for v in self.lifecycle.versions.values()
                                   if v.quarantined),
            },
            "tensor_dedup": {
                "unique_hashes": self.tensor_dedup.stats.n_unique,
                "reduction_ratio": round(self.tensor_dedup.stats.reduction_ratio, 4),
            },
            "bitdistance_comparisons": self.families.comparisons,
            "base_map_cache": dict(self.base_map_stats),
            "retrieval_caches": self.retrieval_cache_stats,
            "workers": self.workers,
            "pipeline_depth": self.pipeline_depth,
            "entropy_procs": 0 if self._entropy_failed else self.entropy_procs,
            "read_gen": self.read_gen,
            "ingest_throughput_MBps": round(self.stats.ingest_throughput_mbps, 1),
        }
