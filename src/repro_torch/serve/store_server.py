# Port copy of src/repro/serve/store_server.py: host-only, logic unchanged (its stores
# take the port's default backend, on the card).
"""Async serving engine + HTTP/1.1 front for the zLLM store (stdlib-only).

ZipLLM's target deployment is hub-scale: tens of PB of model weights served
to millions of users. ``ZLLMStore`` provides the storage-side concurrency
substrate (mmap readers with pin counts, a read gate with read generations,
publish epochs, a spooled-ingest job queue — see ``repro_torch.core.pipeline``);
this module turns it into a servable hub node:

* :class:`RetrievalEngine` — asyncio facade over ONE store. Decodes run on
  a bounded thread pool (sha256/zstd/XOR release the GIL, so concurrent
  retrievals genuinely overlap); concurrent requests for the same object
  are *single-flighted* (one decode, N waiters —
  ``repro_torch.serve.singleflight``); finished responses land in a two-tier
  decoded cache (byte-budgeted RAM LRU over a disk spill directory under
  the store root — ``TieredResponseCache``), keyed by each object's
  strong entity tag. Flights are additionally keyed by the store's
  ``read_gen`` (snapshot isolation), and entries of re-registered /
  deleted keys are purged when a generation change is observed — the
  store's read gate guarantees the decode itself never races physical
  reclamation.

* :class:`StoreServer` — an HTTP/1.1 front over asyncio streams
  (deliberately dependency-free; the paper-repro analogue of the
  production gateway). One server fronts one store *or* a
  :class:`repro_torch.serve.router.StoreRouter` over N roots (consistent-hash
  repo placement, per-root stats, admin fan-out) — every deployment is
  wrapped in a router internally so both topologies share one code path.

  The protocol surface (the canonical registry is :data:`ROUTES`;
  ``docs/HTTP_API.md`` documents every route and a test diffs the two):

  - **keep-alive + pipelining**: connections stay open across requests
    (HTTP/1.1 semantics, ``Connection: close`` honored); requests are
    read and answered strictly in order, so classic HTTP pipelining works.
  - **range reads**: ``Range: bytes=`` on file and tensor GETs — a
    cold-start loader fetches a tensor *slice*, not the 10 GB shard. The
    object is decoded once (single-flight + response cache) and sliced
    from the cached buffer; multi-range requests fall back to a full 200;
    unsatisfiable ranges get 416.
  - **conditional GETs**: file and tensor GETs carry a strong ``ETag``
    (the store's ``key@gN`` entity tag — generations are immutable, so
    HTTP caching is free correctness) plus ``Cache-Control: no-cache``;
    ``If-None-Match`` revalidation answers a bodiless 304, evaluated
    before ``Range`` per RFC 9110. Failover reads order replicas
    strongest-validator-first and schedule read-repair on divergence.
  - **zero-copy sendfile**: tensors whose payload is a ``stored``-codec
    frame (raw bytes the entropy stage could not shrink) are served —
    full or ranged — straight from the container file with
    ``os.sendfile``; no decode, no userspace copy.
  - **remote writes**: ``PUT /repo/<id>/file/<name>`` streams the upload
    to the owning root's spool and enqueues it on the store's pipelined
    ingest engine; ``POST /ingest_repo`` enqueues a server-local repo
    directory. ``/admin/jobs`` exposes job status; ``?sync=1`` blocks the
    request until its job finishes.

* :class:`ServerThread` — runs the server on a private event loop in a
  daemon thread, for synchronous harnesses (tests, benches, the soak).

Run standalone (repeat ``--root`` for a sharded multi-store node)::

    PYTHONPATH=src python -m repro_torch.serve.store_server --root /srv/zllm-a \
        [--root /srv/zllm-b ...]

Each root opens with the store's default array backend, ``TorchBackend`` on
the card, so the BitX and byte-plane kernels run in this process; without a
visible CUDA device the command exits non-zero with that backend's error and
never serves from the CPU (harnesses that want the CPU build their stores
with ``TorchBackend(device="cpu")`` and hand them to :class:`ServerThread`).
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import re
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

from repro_torch.core.bitx import TMP_SUFFIX
from repro_torch.core.lifecycle import make_vid
from repro_torch.core.pipeline import ZLLMStore, _LRUCache
from repro_torch.serve.router import QuorumError, StoreRouter
from repro_torch.serve.singleflight import SingleFlight, TieredResponseCache

__all__ = ["RetrievalEngine", "StoreServer", "ServerThread", "ROUTES", "main"]

_REASONS = {200: "OK", 202: "Accepted", 206: "Partial Content",
            304: "Not Modified",
            400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
            409: "Conflict", 410: "Gone", 411: "Length Required",
            416: "Range Not Satisfiable", 500: "Internal Server Error",
            503: "Service Unavailable"}

# Canonical route registry: (methods, path template, one-line summary).
# docs/HTTP_API.md must list EXACTLY these rows — tests/test_docs.py diffs
# the documented table against this tuple, so neither can rot alone.
ROUTES: Tuple[Tuple[str, str, str], ...] = (
    ("GET", "/healthz",
     "liveness + read generation(s)"),
    ("GET", "/stats",
     "engine + store counters; per-root sections under a multi-root router"),
    ("GET", "/repo/{repo_id}/file/{filename}",
     "bit-exact safetensors file; Range: bytes= supported"),
    ("PUT", "/repo/{repo_id}/file/{filename}",
     "remote write: spool the body, enqueue pipelined ingest"),
    ("GET", "/repo/{repo_id}/tensor/{tensor_name}",
     "one tensor's raw little-endian bytes; Range + ?name= query form"),
    ("POST", "/ingest_repo",
     "enqueue a server-local repo directory for ingest"),
    ("GET", "/admin/jobs",
     "spooled-ingest job status (?job=<id> for one)"),
    ("GET|POST", "/admin/gc",
     "garbage collection; ?incremental=1&max_pause_ms=; per root or all"),
    ("GET|POST", "/admin/compact",
     "dedup-aware compaction of superseded generations; per root or all"),
    ("GET|POST", "/admin/fsck",
     "integrity check; ?repair=1&spot_check=; per root or all"),
    ("GET|POST", "/admin/anti_entropy",
     "replica repair sweep: tombstones, quarantine-restore, re-ship diffs"),
    ("GET", "/peer/index_digest",
     "replication snapshot: per-key records, tombstones, version graph"),
    ("GET", "/peer/container/{key@gN}",
     "one container version's verbatim bytes (?digest=1 for sha256 only)"),
    ("POST", "/peer/adopt",
     "adopt shipped bytes: resumable container/restore upload or index record"),
    ("POST", "/peer/tombstones",
     "union a batch of (key, gen, ts) tombstones into the local store"),
    ("DELETE", "/repo/{repo_id}/file/{filename}",
     "tombstoned delete of one file on every replica (idempotent)"),
    ("DELETE", "/repo/{repo_id}",
     "tombstoned delete of a whole repo on every replica (idempotent)"),
)

# STRICT ASCII grammars (RFC 9110 range-spec is 1*DIGIT). Python's int()
# is far laxer than the ABNF — it accepts "+5", "1_0", surrounding
# whitespace and unicode digits (and bare \d matches unicode digits too),
# so grammar-invalid specs like "bytes=-1_0" used to parse and answer 206.
_RANGE_RE = re.compile(r"^([0-9]+)-([0-9]*)$", re.ASCII)
_SUFFIX_RANGE_RE = re.compile(r"^-([0-9]+)$", re.ASCII)
_MAX_JSON_BODY = 1 << 20        # POST bodies are control-plane JSON only
_UPLOAD_CHUNK = 1 << 20         # PUT spool streaming granularity


def quote_etag(tag: str) -> str:
    """``key@gN`` -> the quoted strong validator on the wire."""
    return f'"{tag}"'


def if_none_match_hit(header: Optional[str], etag: str) -> bool:
    """RFC 9110 §13.1.2 ``If-None-Match`` evaluation against one current
    entity tag (already quoted). ``*`` matches any current representation;
    the list form compares member by member with *weak comparison* — a
    ``W/``-prefixed copy of a tag still matches it."""
    if not header:
        return False
    header = header.strip()
    if header == "*":
        return True
    for cand in header.split(","):
        cand = cand.strip()
        if cand.startswith("W/"):
            cand = cand[2:]
        if cand == etag:
            return True
    return False


def _span_sha256_ok(path: str, offset: int, size: int, expect: str) -> bool:
    """sha256 a container frame span against its record hash (the
    sendfile path's one-time verification; runs on the executor)."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            remaining = size
            while remaining > 0:
                chunk = f.read(min(_UPLOAD_CHUNK, remaining))
                if not chunk:
                    return False
                h.update(chunk)
                remaining -= len(chunk)
    except OSError:
        return False
    return h.hexdigest() == expect


def parse_byte_range(header: Optional[str], size: int):
    """RFC-7233 single-range parser for ``Range: bytes=...``.

    Returns ``None`` (serve the full body: no/malformed header, or a
    multi-range request — rejected with a 200-full fallback by design),
    ``"unsat"`` (416: first-pos past the end, or an empty suffix), or an
    inclusive ``(start, end)`` with ``end`` clamped to ``size - 1``.
    """
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):].strip()
    if "," in spec:
        return None  # multi-range: fall back to the full representation
    sm = _SUFFIX_RANGE_RE.match(spec)
    if sm is not None:  # suffix form: last N bytes
        n = int(sm.group(1))
        if n <= 0 or size == 0:
            return "unsat"
        return max(0, size - n), size - 1
    m = _RANGE_RE.match(spec)
    if m is None:
        return None
    start = int(m.group(1))
    end = int(m.group(2)) if m.group(2) else size - 1
    if start >= size:
        return "unsat"
    if end < start:
        return None
    return start, min(end, size - 1)


class _Request:
    """One parsed request on a keep-alive connection."""

    __slots__ = ("method", "target", "version", "headers", "reader", "keep")

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], reader: asyncio.StreamReader):
        self.method = method
        self.target = target
        self.version = version
        self.headers = headers
        self.reader = reader
        conn = headers.get("connection", "").lower()
        self.keep = (conn != "close" if version == "HTTP/1.1"
                     else conn == "keep-alive")


class RetrievalEngine:
    """Concurrent retrieval over one :class:`ZLLMStore`.

    Loop-confined: construct and call from a single event loop. The store
    may be mutated concurrently from *other* threads (ingest, delete, gc) —
    that is the supported serving topology; what is not supported is two
    engines fronting one store from two loops with one response cache.
    """

    def __init__(self, store: ZLLMStore, *, max_concurrency: int = 8,
                 cache_bytes: int = 128 << 20,
                 spill_bytes: Optional[int] = None, verify: bool = True):
        self.store = store
        self.verify = verify
        self._pool = ThreadPoolExecutor(max_workers=max(1, max_concurrency),
                                        thread_name_prefix="zllm-serve")
        self._flight = SingleFlight()
        # cache_bytes <= 0 disables response caching entirely (the serving
        # bench measures concurrent decodes, not cache hits). Otherwise the
        # two-tier cache: RAM LRU + decoded-spill files under the store
        # root, keyed by (object, entity tag) — see TieredResponseCache.
        # spill_bytes <= 0 keeps the RAM tier but disables the disk tier;
        # None sizes it at the TieredResponseCache default (4x RAM).
        if cache_bytes > 0:
            spill_dir = (None if (spill_bytes is not None and spill_bytes <= 0)
                         else store.decoded_dir())
            self._cache = TieredResponseCache(
                spill_dir, max_bytes=cache_bytes,
                spill_max_bytes=(spill_bytes if spill_bytes is not None
                                 and spill_bytes > 0 else None),
                max_items=1024)
        else:
            self._cache = None
        self._cache_gen = -1  # read_gen the cache was last validated at
        self.requests = 0
        self.errors = 0

    # -- retrieval ------------------------------------------------------
    async def get_file(self, repo_id: str, filename: str = "model.safetensors") -> bytes:
        """Bit-exact safetensors bytes for ``repo_id/filename``."""
        data, _ = await self.get_file_digest(repo_id, filename)
        return data

    async def get_file_digest(self, repo_id: str,
                              filename: str = "model.safetensors") -> Tuple[bytes, str]:
        """(bytes, sha256 hexdigest). The digest comes from the store's own
        gate-held decode (one hash per flight, on the executor, always
        consistent with the returned bytes) and is cached with the
        response — never recomputed per request on the event loop."""
        return await self._fetch(
            ("file", repo_id, filename),
            lambda: self.store.retrieve_file_digest(repo_id, filename,
                                                    verify=self.verify))

    async def get_tensor(self, repo_id: str, tensor_name: str,
                         filename: str = "model.safetensors") -> Tuple[bytes, Dict]:
        """One tensor's raw bytes + metadata for ``repo_id/filename``.
        Ranged HTTP reads slice the bytes returned here — the decode runs
        (and is cached, and single-flighted) ONCE per object per read
        generation no matter how many slices are requested."""
        return await self._fetch(
            ("tensor", repo_id, filename, tensor_name),
            lambda: self.store.retrieve_tensor(repo_id, filename, tensor_name,
                                               verify=self.verify))

    async def _fetch(self, key: Tuple, call):
        """Cache → single-flight → executor.

        Cache entries are keyed by the object's strong validator (the
        entity tag conditional GETs revalidate against), so an unrelated
        mutation no longer wipes every hot object — only entries whose
        OWN key was re-registered / deleted go stale, and those are
        purged the first time a ``read_gen`` change is observed. Flights
        still include the read_gen (snapshot isolation: a request issued
        after a mutation never coalesces onto a stale in-flight decode),
        and a decode that outlives a re-registration of its key is
        re-validated before insertion — a slow flight completing after a
        gen bump must not park dead bytes on the budget (the
        stale-generation leak regression)."""
        self.requests += 1
        gen = self.store.read_gen
        tag = self.store.entity_tag(key[1], key[2])
        if self._cache is not None:
            if gen != self._cache_gen:
                self._cache.purge(self._entry_current)
                self._cache_gen = gen
            if tag is not None:
                hit = self._cache.get(key, tag)
                if hit is not None:
                    return hit
        loop = asyncio.get_running_loop()

        async def thunk():
            return await loop.run_in_executor(self._pool, call)

        try:
            result = await self._flight.run((gen, tag) + key, thunk)
        except Exception:
            self.errors += 1
            raise
        if (self._cache is not None and tag is not None
                and self.store.entity_tag(key[1], key[2]) == tag):
            nbytes = len(result[0]) if isinstance(result, tuple) else len(result)
            self._cache.put(key, tag, result, nbytes)
        return result

    def _entry_current(self, objkey: Tuple, validator: str) -> bool:
        """Is a cache entry's validator still the one its key serves?
        ``objkey[1:3]`` is ``(repo_id, filename)`` for both object kinds."""
        return self.store.entity_tag(objkey[1], objkey[2]) == validator

    # -- admin ----------------------------------------------------------
    # These are the single-store *embedding* API (callers holding an
    # engine directly — see the serve README). The HTTP /admin/* routes
    # fan out through StoreRouter.fanout_* instead, so they cover every
    # root of a sharded node with one call.
    async def run_gc(self, incremental: bool = False,
                     max_pause_ms: float = 50.0) -> Dict[str, int]:
        """Run ``store.gc()`` off-loop. Safe during serving AND during an
        ingest batch on another thread: gc serializes behind the store's
        admin lock, its write gate drains in-flight decodes, and read_gen
        rolls the engine caches over. ``incremental=True`` sweeps in
        bounded steps (target ``max_pause_ms`` exclusive hold each) that
        interleave with the live traffic instead of stopping the world."""
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, lambda: self.store.gc(incremental=incremental,
                                              max_pause_ms=max_pause_ms))

    async def run_compact(self) -> Dict:
        """Run ``store.compact()`` off-loop: rewrite still-referenced
        records out of superseded generations and retire them. The byte
        copying runs concurrently with serving; only the final pointer
        swap holds the read gate (reported as ``exclusive_hold_ms``)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._pool, self.store.compact)

    def stats(self) -> Dict:
        return {
            "requests": self.requests,
            "errors": self.errors,
            "read_gen": self.store.read_gen,
            "singleflight": self._flight.stats(),
            "response_cache": (self._cache.stats()
                               if self._cache is not None else {"disabled": True}),
            "workers": self._pool._max_workers,
            "verify": self.verify,
        }

    async def aclose(self) -> None:
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._pool.shutdown(wait=True))


class StoreServer:
    """HTTP/1.1 front (keep-alive, ranges, remote writes, sendfile) over
    one :class:`RetrievalEngine` per routed store root."""

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0,
                 *, max_concurrency: int = 8, cache_bytes: int = 128 << 20,
                 spill_bytes: Optional[int] = None, verify: bool = True,
                 idle_timeout: float = 30.0):
        self.router = (store if isinstance(store, StoreRouter)
                       else StoreRouter(store))
        # engines decode from LOCAL stores only: a PeerStore root (remote
        # replica) holds no mmap-able containers here — its own server
        # decodes for its own clients
        self.engines: Dict[str, RetrievalEngine] = {
            name: RetrievalEngine(s, max_concurrency=max_concurrency,
                                  cache_bytes=cache_bytes,
                                  spill_bytes=spill_bytes, verify=verify)
            for name, s in self.router.items()
            if not getattr(s, "is_peer", False)}
        if not self.engines:
            raise ValueError("StoreServer needs at least one local "
                             "(non-peer) store root to serve from")
        # back-compat: the single-root engine (first root's under a router)
        self.engine = next(iter(self.engines.values()))
        self.idle_timeout = idle_timeout
        self._host_arg, self._port_arg = host, port
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        # HTTP-layer counters (the engine counts decodes; these count the
        # protocol surface: connections reused, ranges, zero-copy sends)
        self.http = {"connections": 0, "requests": 0, "range_requests": 0,
                     "sendfile_responses": 0, "put_uploads": 0,
                     "put_bytes": 0,
                     # conditional GETs: requests carrying If-None-Match,
                     # and how many revalidated to a bodiless 304
                     "conditional_requests": 0, "not_modified": 0}
        # live keep-alive connections: handler tasks park on readline
        # between requests, so shutdown must actively close their
        # transports or the loop teardown reports destroyed pending tasks
        self._conns: set = set()
        # sendfile spans sha256-checked once (verify=True): containers are
        # immutable, so (path, offset) never needs re-verification. LRU,
        # not a set — retired generations must not accumulate forever
        self._verified_spans = _LRUCache(max_items=4096)
        # span-or-None verdict per (read_gen, root, object): the probe
        # takes the store read gate and opens a container reader, so hot
        # non-stored tensors must not pay it on every keep-alive request
        self._span_cache = _LRUCache(max_items=4096)

    def engine_for(self, repo_id: str,
                   filename: str = "model.safetensors") -> RetrievalEngine:
        return self.engines[self.router.locate(repo_id, filename)]

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, self._host_arg,
                                                  self._port_arg)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]
        return self.host, self.port

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for task in list(self._conns):  # wake idle keep-alive handlers
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        for engine in self.engines.values():
            await engine.aclose()

    # -- connection handling ----------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One connection, N requests: the keep-alive loop. Requests are
        parsed and answered strictly in order (pipelined clients get their
        responses in request order); the loop ends on ``Connection:
        close``, client EOF, idle timeout, or an error that leaves the
        request framing in an unknown state."""
        self.http["connections"] += 1
        self._conns.add(asyncio.current_task())
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                self.http["requests"] += 1
                try:
                    await self._route(writer, req)
                except (ConnectionError, asyncio.TimeoutError):
                    raise
                except Exception as e:  # handler bug: answer 500, drop conn
                    req.keep = False
                    await self._respond(writer, 500,
                                        {"error": f"{type(e).__name__}: {e}"},
                                        keep=False)
                if not req.keep:
                    break
        except (asyncio.TimeoutError, ConnectionError):
            pass
        except asyncio.CancelledError:
            pass  # server shutdown: drop the connection quietly
        except ValueError:
            # oversized request/header line (StreamReader limit overrun) —
            # answer 400 instead of leaking an unhandled task exception
            try:
                await self._respond(writer, 400,
                                    {"error": "request line or headers too large"},
                                    keep=False)
            except Exception:
                pass
        finally:
            self._conns.discard(asyncio.current_task())
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[_Request]:
        request = await asyncio.wait_for(reader.readline(),
                                         timeout=self.idle_timeout)
        if not request:
            return None  # clean EOF between requests
        parts = request.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, target = parts[0].upper(), parts[1]
        version = parts[2] if len(parts) > 2 else "HTTP/1.0"
        headers: Dict[str, str] = {}
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout=30)
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        return _Request(method, target, version, headers, reader)

    async def _drain_body(self, req: _Request) -> None:
        """Consume an unread request body so the next request on the
        connection parses cleanly; closes instead when the body is
        unbounded (chunked) or oversized."""
        te = req.headers.get("transfer-encoding", "").lower()
        if "chunked" in te:
            req.keep = False
            return
        try:
            length = int(req.headers.get("content-length", "0"))
        except ValueError:
            req.keep = False
            return
        if length > 64 << 20:  # refuse to slurp huge bodies just for framing
            req.keep = False
            return
        while length > 0:
            chunk = await asyncio.wait_for(
                req.reader.read(min(_UPLOAD_CHUNK, length)), timeout=60)
            if not chunk:
                req.keep = False
                return
            length -= len(chunk)

    # -- routing ------------------------------------------------------------
    async def _route(self, writer, req: _Request) -> None:
        url = urlsplit(req.target)
        segs = [unquote(s) for s in url.path.split("/") if s]
        qs = parse_qs(url.query)
        is_file_route = len(segs) >= 4 and segs[0] == "repo" and segs[-2] == "file"
        try:
            if req.method == "PUT":
                if is_file_route:
                    await self._put_file(writer, req, segs, qs)
                else:
                    await self._drain_body(req)
                    await self._respond(writer, 405,
                                        {"error": "PUT only on "
                                         "/repo/<repo_id>/file/<filename>"},
                                        keep=req.keep)
                return
            if req.method == "DELETE":
                await self._drain_body(req)
                if is_file_route:
                    out = self.router.delete("/".join(segs[1:-2]), segs[-1])
                elif len(segs) >= 2 and segs[0] == "repo":
                    out = self.router.delete("/".join(segs[1:]))
                else:
                    await self._respond(writer, 405,
                                        {"error": "DELETE only on /repo/"
                                         "<repo_id>[/file/<filename>]"},
                                        keep=req.keep)
                    return
                await self._respond(writer, 200, out, keep=req.keep)
                return
            if req.method == "POST":
                if url.path == "/ingest_repo":
                    await self._ingest_repo(writer, req)
                elif url.path == "/peer/adopt":
                    # streams its own body (resumable ship): NOT pre-drained
                    await self._peer_adopt(writer, req, qs)
                elif url.path == "/peer/tombstones":
                    await self._peer_tombstones(writer, req)
                elif url.path.startswith("/admin/"):
                    await self._drain_body(req)
                    await self._admin(writer, req, url.path, qs)
                else:
                    await self._drain_body(req)
                    await self._respond(writer, 405,
                                        {"error": "POST only on /ingest_repo, "
                                         "/peer/*, and /admin/*"},
                                        keep=req.keep)
                return
            if req.method != "GET":
                await self._drain_body(req)
                await self._respond(writer, 405,
                                    {"error": f"method {req.method} not "
                                     f"supported"}, keep=req.keep)
                return
            await self._drain_body(req)  # tolerate (and skip) GET bodies
            if url.path == "/healthz":
                single = self.router.single
                gen = (single.read_gen if single is not None else
                       {n: s.read_gen for n, s in self.router.items()})
                health = self.router.health()
                await self._respond(writer, 200,
                                    {"ok": all(h["state"] != "down"
                                               for h in health.values()),
                                     "read_gen": gen,
                                     "roots": self.router.names(),
                                     "health": health,
                                     "replicas": self.router.replicas,
                                     "write_quorum": self.router.write_quorum},
                                    keep=req.keep)
            elif url.path == "/stats":
                await self._stats(writer, req)
            elif url.path == "/peer/index_digest":
                await self._peer_index_digest(writer, req)
            elif len(segs) >= 3 and segs[0] == "peer" and segs[1] == "container":
                await self._peer_container(writer, req, "/".join(segs[2:]), qs)
            elif url.path.startswith("/admin/"):
                await self._admin(writer, req, url.path, qs)
            elif is_file_route:
                repo_id, filename = "/".join(segs[1:-2]), segs[-1]
                inm = req.headers.get("if-none-match")
                if inm:
                    self.http["conditional_requests"] += 1

                async def file_attempt(engine):
                    # conditional evaluation FIRST (RFC 9110 §13.2.2:
                    # If-None-Match precedes Range): a validator match
                    # answers 304 with no decode at all — also on ranged
                    # requests
                    tag = engine.store.entity_tag(repo_id, filename)
                    if tag is not None and if_none_match_hit(
                            inm, quote_etag(tag)):
                        return None, None, tag
                    data, sha = await engine.get_file_digest(repo_id,
                                                             filename)
                    return data, sha, (engine.store.entity_tag(
                        repo_id, filename) or tag)

                (data, sha, tag), served_by = await self._with_failover(
                    repo_id, filename, file_attempt)
                engine = self.engines[served_by]
                cond = self._etag_headers(tag)
                if data is None:  # revalidated: bodiless 304
                    self.http["not_modified"] += 1
                    await self._write(
                        writer, 304, b"", "application/octet-stream",
                        cond + [("x-read-gen", str(engine.store.read_gen)),
                                ("x-served-by", served_by)], req.keep)
                else:
                    await self._respond_ranged(
                        writer, req, data,
                        [("x-content-sha256", sha),
                         ("x-read-gen", str(engine.store.read_gen)),
                         ("x-served-by", served_by)] + cond)
            elif (len(segs) >= 3 and segs[0] == "repo" and segs[-1] == "tensor"
                  and "name" in qs):
                # unambiguous form: /repo/<repo_id>/tensor?name=<tensor> —
                # for names where the path grammar below would mis-split
                repo_id = "/".join(segs[1:-1])
                await self._tensor_get(writer, req, repo_id, qs["name"][0],
                                       qs.get("file", ["model.safetensors"])[0])
            elif len(segs) >= 4 and segs[0] == "repo" and "tensor" in segs[2:-1]:
                # path form: rightmost "tensor" marker splits repo id from
                # tensor name (both may contain slashes; a tensor name with
                # a literal "tensor" segment needs the ?name= form above)
                i = len(segs) - 1 - segs[::-1].index("tensor")
                repo_id = "/".join(segs[1:i])
                tensor_name = "/".join(segs[i + 1:])
                filename = qs.get("file", ["model.safetensors"])[0]
                await self._tensor_get(writer, req, repo_id, tensor_name,
                                       filename)
            else:
                await self._respond(writer, 404,
                                    {"error": f"no route for {url.path}"},
                                    keep=req.keep)
        except KeyError as e:
            self._fail_framing(req)
            await self._respond(writer, 404, {"error": str(e)}, keep=req.keep)
        except QuorumError as e:
            # before ConnectionError: QuorumError subclasses it, but it is
            # an HTTP-visible replication failure, not a dead client socket
            self._fail_framing(req)
            await self._respond(writer, 503, {"error": str(e)}, keep=req.keep)
        except RuntimeError as e:
            self._fail_framing(req)
            status = 410 if "quarantined" in str(e) else 500
            await self._respond(writer, status, {"error": str(e)}, keep=req.keep)
        except (ConnectionError, asyncio.TimeoutError):
            raise
        except Exception as e:  # backend mismatch, decode failure, ...
            self._fail_framing(req)
            await self._respond(writer, 500,
                                {"error": f"{type(e).__name__}: {e}"},
                                keep=req.keep)

    @staticmethod
    def _fail_framing(req: _Request) -> None:
        """An upload handler failed somewhere its body may not have been
        fully read (e.g. before the PUT spool loop): the connection's
        request framing is unknown, so it must close after the error
        response. GET bodies were drained up front and stay keep-alive."""
        if req.method != "GET":
            req.keep = False

    # -- read path ----------------------------------------------------------
    async def _with_failover(self, repo_id: str, filename: str, attempt):
        """Run ``attempt(engine)`` against each read candidate in replica
        order until one serves; returns ``(result, root_name)``. A down or
        erroring root is skipped (and its failure noted, feeding the
        router's suspect backoff); a quarantined container is skipped
        WITHOUT a health mark — the root is fine, that one object is not.
        Exhaustion re-raises the most specific failure: 410 when a healthy
        copy exists nowhere but a quarantined one does, 404 when no replica
        knows the key, otherwise the last hard error.

        Candidates come from the router's :meth:`read_plan`, which orders
        the ready tier strongest-record-first, so a failover read never
        serves a weaker validator while a stronger replica is ready. A
        read that had to skip a replica — or whose group the plan saw
        divergent — schedules an asynchronous per-repo read-repair on the
        store's job worker instead of waiting for a full sweep."""
        names, divergent = self.router.read_plan(repo_id, filename)
        if not names:
            raise QuorumError(f"no replica of {repo_id} is up")
        key_errors = 0
        quarantined: Optional[Exception] = None
        hard: Optional[Exception] = None
        skipped_peers = 0
        for name in names:
            engine = self.engines.get(name)
            if engine is None:  # remote peer replica: no local bytes to
                skipped_peers += 1  # decode — its own server serves reads
                continue
            try:
                out = await attempt(engine)
            except KeyError as e:
                key_errors += 1
                last_key = e
                continue
            except RuntimeError as e:
                if "quarantined" in str(e):
                    quarantined = e
                else:
                    self.router.note_failure(name)
                    hard = e
                continue
            except (ConnectionError, asyncio.TimeoutError):
                raise
            except Exception as e:
                self.router.note_failure(name)
                hard = e
                continue
            self.router.note_success(name)
            if divergent or key_errors or quarantined is not None \
                    or hard is not None:
                self.router.schedule_read_repair(
                    repo_id,
                    note=f"read-repair: {repo_id} served by {name}"
                         f"{' (divergent group)' if divergent else ''}")
            return out, name
        if quarantined is not None and hard is None:
            raise quarantined
        if hard is not None:
            raise hard
        if key_errors == 0:
            raise QuorumError(
                f"no local replica of {repo_id} can serve reads "
                f"({skipped_peers} remote peer(s) skipped)")
        raise last_key  # every replica answered KeyError -> 404

    async def _tensor_get(self, writer, req: _Request, repo_id: str,
                          tensor_name: str, filename: str) -> None:
        async def attempt(engine):
            await self._tensor_serve(writer, req, engine, repo_id,
                                     tensor_name, filename)
            return True
        await self._with_failover(repo_id, filename, attempt)

    async def _tensor_serve(self, writer, req: _Request,
                            engine: RetrievalEngine, repo_id: str,
                            tensor_name: str, filename: str) -> None:
        # conditional evaluation FIRST (RFC 9110: If-None-Match precedes
        # Range): tensors share the file's (key, gen) validator — a match
        # revalidates without touching the span probe or the decode path.
        inm = req.headers.get("if-none-match")
        tag = engine.store.entity_tag(repo_id, filename)
        if inm:
            self.http["conditional_requests"] += 1
            if tag is not None and if_none_match_hit(inm, quote_etag(tag)):
                self.http["not_modified"] += 1
                await self._write(
                    writer, 304, b"", "application/octet-stream",
                    self._etag_headers(tag)
                    + [("x-read-gen", str(engine.store.read_gen))],
                    req.keep)
                return
        # zero-copy short-circuit: a `stored`-codec payload is a verbatim
        # on-disk span — full and ranged responses go through os.sendfile,
        # no decode, no userspace copy. Any irregularity (codec, race with
        # a concurrent compact/gc unlink) falls back to the decode path.
        # The span-or-None verdict is memoized per read generation: the
        # probe holds the read gate and opens a reader, which hot
        # non-stored tensors must not pay per keep-alive request.
        sk = (engine.store.read_gen, id(engine), repo_id, filename,
              tensor_name)
        span = self._span_cache.get(sk)
        if span is None:
            span = await asyncio.get_running_loop().run_in_executor(
                engine._pool, engine.store.tensor_sendfile_span,
                repo_id, filename, tensor_name)
            self._span_cache.put(sk, span if span is not None else "none")
        elif span == "none":
            span = None
        if span is not None:
            if await self._respond_sendfile(writer, req, engine, span, tag):
                return
        data, meta = await engine.get_tensor(repo_id, tensor_name, filename)
        await self._respond_ranged(writer, req, data,
                                   self._tensor_headers(engine, meta, tag))

    @staticmethod
    def _etag_headers(tag: Optional[str]) -> List[Tuple[str, str]]:
        """ETag + revalidation policy. ``no-cache`` means "store, but
        revalidate before reuse" — the right policy for immutable
        generations behind a mutable key: revalidation is a free 304
        until the key is re-registered, then the new bytes flow."""
        if not tag:
            return []
        return [("etag", quote_etag(tag)), ("cache-control", "no-cache")]

    @classmethod
    def _tensor_headers(cls, engine: RetrievalEngine, meta: Dict,
                        tag: Optional[str] = None) -> List[Tuple[str, str]]:
        return [("x-tensor-dtype", meta["dtype"]),
                ("x-tensor-shape", json.dumps(meta["shape"])),
                ("x-tensor-codec", meta["codec"]),
                ("x-read-gen", str(engine.store.read_gen))] \
            + cls._etag_headers(tag)

    async def _respond_sendfile(self, writer, req: _Request,
                                engine: RetrievalEngine, span,
                                tag: Optional[str] = None) -> bool:
        """Serve a stored-codec frame span with ``os.sendfile``; returns
        False (caller falls back to the decode path) when the container
        vanished between span resolution and open — the one benign race.
        Once the fd is open the transfer is safe regardless of concurrent
        gc/compact: container files are immutable and the fd keeps the
        bytes alive across an unlink."""
        cpath, offset, size, meta = span
        if engine.verify and self._verified_spans.get((cpath, offset)) is None:
            # first touch of this span under verify=True: one sha256 pass
            # against the record's ingest-time hash (on the executor).
            # Immutable containers make the memo sound; a mismatch (bit
            # rot) falls back to the decode path, which raises the proper
            # verification error -> 500, same as every other codec.
            ok = await asyncio.get_running_loop().run_in_executor(
                engine._pool, _span_sha256_ok, cpath, offset, size,
                meta["sha256"])
            if not ok:
                return False
            self._verified_spans.put((cpath, offset), True)
        rng = parse_byte_range(req.headers.get("range"), size)
        if rng == "unsat":
            await self._respond(writer, 416,
                                {"error": f"range out of bounds for "
                                 f"{size}-byte tensor"},
                                keep=req.keep,
                                extra=[("content-range", f"bytes */{size}")])
            return True
        try:
            f = open(cpath, "rb")
        except OSError:
            return False
        try:
            start, end = rng if rng is not None else (0, size - 1)
            count = end - start + 1
            status = 206 if rng is not None else 200
            if rng is not None:
                self.http["range_requests"] += 1
            extra = self._tensor_headers(engine, meta, tag)
            extra.append(("x-zllm-sendfile", "1"))
            if status == 206:
                extra.append(("content-range", f"bytes {start}-{end}/{size}"))
            head = self._head(status, count, "application/octet-stream",
                              extra, req.keep)
            writer.write(head)
            await writer.drain()
            loop = asyncio.get_running_loop()
            try:
                await loop.sendfile(writer.transport, f, offset + start,
                                    count, fallback=True)
            except (ConnectionError, asyncio.TimeoutError):
                raise
            except Exception as e:
                # head (and possibly part of the body) is on the wire: no
                # JSON may follow under this content-length — drop the
                # connection instead of desyncing the client
                raise ConnectionError(f"sendfile failed mid-body: {e}") from e
            self.http["sendfile_responses"] += 1
            return True
        finally:
            f.close()

    async def _respond_ranged(self, writer, req: _Request, data: bytes,
                              extra: List[Tuple[str, str]]) -> None:
        """Full (200) or single-range (206) byte response; 416 with
        ``content-range: bytes */N`` when unsatisfiable. The full object
        was decoded once into the engine's response cache — every slice is
        a view of that buffer."""
        size = len(data)
        rng = parse_byte_range(req.headers.get("range"), size)
        if rng == "unsat":
            await self._respond(writer, 416,
                                {"error": f"range out of bounds for "
                                 f"{size}-byte body"},
                                keep=req.keep,
                                extra=[("content-range", f"bytes */{size}")])
            return
        if rng is None:
            await self._write(writer, 200, data, "application/octet-stream",
                              extra, req.keep)
            return
        start, end = rng
        self.http["range_requests"] += 1
        body = memoryview(data)[start:end + 1]
        await self._write(writer, 206, body, "application/octet-stream",
                          extra + [("content-range",
                                    f"bytes {start}-{end}/{size}")],
                          req.keep)

    # -- write path ----------------------------------------------------------
    async def _put_file(self, writer, req: _Request, segs: List[str],
                        qs: Dict[str, List[str]]) -> None:
        """Remote write: stream the body to the owning root's spool, then
        enqueue it on the store's pipelined ingest engine. 202 + job id by
        default; ``?sync=1`` waits for the job and returns its result.
        ``?base=<base_id>`` forwards a declared BitX base."""
        repo_id, filename = "/".join(segs[1:-2]), segs[-1]
        if "chunked" in req.headers.get("transfer-encoding", "").lower() \
                or "content-length" not in req.headers:
            req.keep = False
            await self._respond(writer, 411,
                                {"error": "content-length required "
                                 "(chunked uploads not supported)"},
                                keep=False)
            return
        try:
            length = int(req.headers["content-length"])
        except ValueError:
            req.keep = False
            await self._respond(writer, 400, {"error": "bad content-length"},
                                keep=False)
            return
        if length <= 0:
            await self._respond(writer, 400,
                                {"error": "empty upload"}, keep=req.keep)
            return
        base = qs.get("base", [None])[0]
        # family-aware placement: a new repo declaring a BitX base lands on
        # the root group serving that base (per-root delta domains — a
        # scattered family would store every fine-tune standalone). The
        # body spools into the first write target; replicated_enqueue
        # stages per-replica copies from there.
        targets = self.router.write_roots(repo_id, filename, base=base)
        root = targets[0]
        store = self.router.store(root)
        fd, spath = tempfile.mkstemp(
            prefix="put-", suffix="-" + filename.replace("/", "_"),
            dir=store.spool_dir())
        received = 0
        loop = asyncio.get_running_loop()
        try:
            with os.fdopen(fd, "wb") as f:
                while received < length:
                    chunk = await asyncio.wait_for(
                        req.reader.read(min(_UPLOAD_CHUNK, length - received)),
                        timeout=120)
                    if not chunk:
                        raise ConnectionError("client closed mid-upload")
                    # disk writes go through the default executor: a
                    # multi-GB upload must not stall every other
                    # connection on each 1 MB write burst
                    await loop.run_in_executor(None, f.write, chunk)
                    received += len(chunk)
        except BaseException:
            try:
                os.remove(spath)
            except OSError:
                pass
            raise
        self.http["put_uploads"] += 1
        self.http["put_bytes"] += received
        # quorum fan-out (QuorumError -> 503 in the dispatcher); a
        # single-root router degenerates to the old one-job path exactly
        loop2 = asyncio.get_running_loop()
        rep = await loop2.run_in_executor(
            self.engine._pool,
            lambda: self.router.replicated_enqueue(spath, repo_id, filename,
                                                   base=base))
        first = next(iter(rep["jobs"]))
        if qs.get("sync", ["0"])[0] in ("0", "", "false"):
            out = {"job_id": rep["jobs"][first], "root": first,
                   "repo_id": repo_id, "filename": filename,
                   "bytes": received,
                   "status": f"/admin/jobs?job={rep['jobs'][first]}"}
            if len(rep["targets"]) > 1:
                out["replicas"] = {"jobs": rep["jobs"],
                                   "failed": rep["failed"],
                                   "quorum": rep["quorum"]}
            await self._respond(writer, 202, out, keep=req.keep)
            return
        ok, states = await loop2.run_in_executor(
            self.engine._pool, lambda: self.router.await_quorum(rep["jobs"]))
        job = states.get(first)
        if job is not None:
            job = dict(job)
            job.setdefault("root", first)
        status = 200 if ok else 500
        out = {"root": first, "job": job}
        if len(rep["targets"]) > 1:
            out["replicas"] = {"quorum_met": ok,
                               "states": {n: (s or {}).get("state")
                                          for n, s in states.items()},
                               "failed": rep["failed"]}
        await self._respond(writer, status, out, keep=req.keep)

    async def _ingest_repo(self, writer, req: _Request) -> None:
        """Enqueue a *server-local* repo directory (bulk feeding / sidecar
        drops): body is ``{"dir": ..., "repo_id": ..., "sync": bool}``.
        Metadata (config.json / README base_model) is parsed exactly as in
        local ``ingest_repos``."""
        te = req.headers.get("transfer-encoding", "").lower()
        try:
            length = int(req.headers.get("content-length", "0"))
        except ValueError:
            length = -1
        if "chunked" in te or length <= 0 or length > _MAX_JSON_BODY:
            req.keep = False
            await self._respond(writer, 411,
                                {"error": "JSON body with content-length "
                                 f"<= {_MAX_JSON_BODY} required"}, keep=False)
            return
        body = await asyncio.wait_for(req.reader.readexactly(length),
                                      timeout=60)
        try:
            spec = json.loads(body)
            repo_dir = spec["dir"]
        except (ValueError, KeyError, TypeError):
            await self._respond(writer, 400,
                                {"error": 'body must be {"dir": ..., '
                                 '"repo_id": ..., "sync": bool}'},
                                keep=req.keep)
            return
        if not os.path.isdir(repo_dir):
            await self._respond(writer, 404,
                                {"error": f"no such directory: {repo_dir}"},
                                keep=req.keep)
            return
        repo_id = spec.get("repo_id") or os.path.basename(
            os.path.normpath(repo_dir))
        root = self.router.locate(repo_id)
        store = self.router.store(root)
        job_id = store.enqueue_ingest_repo(repo_dir, repo_id)
        if not spec.get("sync"):
            await self._respond(writer, 202,
                                {"job_id": job_id, "root": root,
                                 "repo_id": repo_id,
                                 "status": f"/admin/jobs?job={job_id}"},
                                keep=req.keep)
            return
        job = await self._await_job(store, job_id)
        status = 200 if job and job["state"] == "done" else 500
        await self._respond(writer, status, {"root": root, "job": job},
                            keep=req.keep)

    @staticmethod
    async def _await_job(store: ZLLMStore, job_id: str,
                         timeout: float = 600.0) -> Optional[Dict]:
        """Poll one job to a terminal state without blocking the loop."""
        deadline = time.monotonic() + timeout
        while True:
            job = store.ingest_job(job_id)
            if job is None or job["state"] in ("done", "failed"):
                return job
            if time.monotonic() >= deadline:
                job["state"] = "timeout"
                return job
            await asyncio.sleep(0.02)

    # -- stats + admin --------------------------------------------------------
    async def _stats(self, writer, req: _Request) -> None:
        # store summaries walk index/lifecycle dicts — run them on the
        # executor so a slow store never stalls the event loop
        store_stats = await asyncio.get_running_loop().run_in_executor(
            self.engine._pool, self.router.summary)
        if self.router.single is not None:
            server = dict(self.engine.stats())
        else:
            server = {
                "requests": sum(e.requests for e in self.engines.values()),
                "errors": sum(e.errors for e in self.engines.values()),
                "roots": {name: e.stats() for name, e in self.engines.items()},
            }
        server["http"] = dict(self.http)
        await self._respond(writer, 200, {"server": server,
                                          "store": store_stats},
                            keep=req.keep)

    async def _admin(self, writer, req: _Request, path: str,
                     qs: Dict[str, List[str]]) -> None:
        loop = asyncio.get_running_loop()
        root = qs.get("root", [None])[0]
        if path == "/admin/jobs":
            job_id = qs.get("job", [None])[0]
            if job_id is not None:
                job = self.router.ingest_job(job_id)
                if job is None:
                    await self._respond(writer, 404,
                                        {"error": f"unknown job {job_id}"},
                                        keep=req.keep)
                else:
                    await self._respond(writer, 200, job, keep=req.keep)
            else:
                jobs = self.router.ingest_jobs()
                await self._respond(writer, 200, {"jobs": jobs}, keep=req.keep)
        elif path == "/admin/compact":
            # dedup-aware compaction: rewrite still-referenced records out
            # of superseded generations, retire the old gens. Runs on the
            # executor; serving continues except for the commit's bounded
            # exclusive hold (returned as exclusive_hold_ms).
            out = await loop.run_in_executor(
                self.engine._pool, lambda: self.router.fanout_compact(root))
            await self._respond(writer, 200, out, keep=req.keep)
        elif path == "/admin/gc":
            inc = qs.get("incremental", ["0"])[0].lower() not in ("0", "false", "")
            pause = float(qs.get("max_pause_ms", ["50"])[0])
            out = await loop.run_in_executor(
                self.engine._pool,
                lambda: self.router.fanout_gc(root, incremental=inc,
                                              max_pause_ms=pause))
            await self._respond(writer, 200, out, keep=req.keep)
        elif path == "/admin/fsck":
            repair = qs.get("repair", ["0"])[0].lower() not in ("0", "false", "")
            spot_raw = qs.get("spot_check", ["4"])[0]
            spot = None if spot_raw in ("all", "none", "") else int(spot_raw)
            out = await loop.run_in_executor(
                self.engine._pool,
                lambda: self.router.fanout_fsck(root, repair=repair,
                                                spot_check=spot))
            await self._respond(writer, 200, out, keep=req.keep)
        elif path == "/admin/anti_entropy":
            repos = qs.get("repo") or None
            out = await loop.run_in_executor(
                self.engine._pool,
                lambda: self.router.anti_entropy(repos=repos))
            out["diff_after"] = await loop.run_in_executor(
                self.engine._pool,
                lambda: self.router.replica_index_diff(repos=repos))
            await self._respond(writer, 200, out, keep=req.keep)
        else:
            await self._respond(writer, 404,
                                {"error": f"no admin route for {path}"},
                                keep=req.keep)

    # -- peer replication protocol --------------------------------------------
    # The wire form of the in-process ship/adopt primitives: a remote
    # StoreRouter's PeerStore client (repro_torch.serve.peer) drives these four
    # routes to diff index state, pull/push verbatim container bytes
    # (sha256-authenticated, resumable via .part staging), adopt index
    # records dependencies-first, and union tombstones.

    def _local_stores(self) -> List[ZLLMStore]:
        return [s for _, s in self.router.items()
                if not getattr(s, "is_peer", False)]

    def _peer_store(self, key: str) -> ZLLMStore:
        """The local store that owns ``key`` (``repo_id/filename``) on this
        node — peer adopts always land on local storage."""
        single = self.router.single
        if single is not None and not getattr(single, "is_peer", False):
            return single
        repo_id, _, filename = key.rpartition("/")
        s = self.router.store(self.router.locate(repo_id, filename or key))
        if not getattr(s, "is_peer", False):
            return s
        return self._local_stores()[0]  # placement named a remote replica

    def _peer_snapshot_sync(self) -> Dict:
        """Build the full replication snapshot (runs on the executor):
        per-key index records sans local paths, the tombstone union, and
        the container version graph (nbytes / quarantined / dedup edges) —
        everything a remote anti-entropy pass needs to diff without
        touching container bytes. ``digest`` summarizes the whole snapshot
        so equal replicas can short-circuit on one string compare."""
        keys: Dict[str, Dict] = {}
        tombs: Dict[str, List] = {}
        versions: Dict[str, Dict] = {}
        bases: set = set()
        read_gen = 0
        for s in self._local_stores():
            for k, rec in s.file_index.items():
                keys[k] = {a: b for a, b in rec.items() if a != "path"}
            for k, (g, ts) in s.lifecycle.tombstones.items():
                cur = tombs.get(k)
                if cur is None or (g, ts) > (cur[0], cur[1]):
                    tombs[k] = [int(g), float(ts)]
            edges = s.lifecycle.edges
            for vid, v in s.lifecycle.versions.items():
                versions[vid] = {"nbytes": v.nbytes,
                                 "quarantined": bool(v.quarantined),
                                 "edges": sorted(edges.get(vid, ()))}
            bases.update(s.base_paths.keys())
            read_gen = max(read_gen, s.read_gen)
        payload = {"keys": keys, "tombstones": tombs, "versions": versions,
                   "base_paths": sorted(bases), "read_gen": read_gen}
        payload["digest"] = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()
        return payload

    async def _peer_index_digest(self, writer, req: _Request) -> None:
        snap = await asyncio.get_running_loop().run_in_executor(
            self.engine._pool, self._peer_snapshot_sync)
        await self._respond(writer, 200, snap, keep=req.keep)

    async def _peer_container(self, writer, req: _Request, vid: str,
                              qs: Dict[str, List[str]]) -> None:
        """Serve one container version's verbatim bytes (``?digest=1`` for
        its sha256 only). Range requests resume a killed download; the
        ``x-zllm-sha256`` header always carries the FULL file's digest so
        the fetcher verifies the assembled result, not the fragment."""
        key, sep, gen_s = vid.rpartition("@g")
        if not sep or not gen_s.isdigit():
            await self._respond(writer, 400,
                                {"error": f"bad container version id {vid!r} "
                                 "(want <key>@g<N>)"}, keep=req.keep)
            return
        gen = int(gen_s)
        store = self._peer_store(key)
        loop = asyncio.get_running_loop()
        allow_q = qs.get("allow_quarantined", ["0"])[0] not in ("0", "false", "")
        # KeyError -> 404 and RuntimeError("quarantined") -> 410 in _route
        digest = await loop.run_in_executor(
            self.engine._pool,
            lambda: store.container_digest(key, gen,
                                           allow_quarantined=allow_q))
        v = store.lifecycle.get(key, gen)
        if qs.get("digest", ["0"])[0] not in ("0", "false", ""):
            await self._respond(writer, 200,
                                {"sha256": digest, "nbytes": v.nbytes},
                                keep=req.keep)
            return
        with open(v.path, "rb") as f:  # immutable: safe to slurp + serve
            data = await loop.run_in_executor(None, f.read)
        await self._respond_ranged(writer, req, data,
                                   [("x-zllm-sha256", digest)])

    async def _read_json_body(self, writer, req: _Request) -> Optional[Dict]:
        """Read a bounded JSON control-plane body; answers the error
        response itself and returns None when the body is unusable."""
        te = req.headers.get("transfer-encoding", "").lower()
        try:
            length = int(req.headers.get("content-length", "0"))
        except ValueError:
            length = -1
        if "chunked" in te or length <= 0 or length > _MAX_JSON_BODY:
            req.keep = False
            await self._respond(writer, 411,
                                {"error": "JSON body with content-length "
                                 f"<= {_MAX_JSON_BODY} required"}, keep=False)
            return None
        body = await asyncio.wait_for(req.reader.readexactly(length),
                                      timeout=60)
        try:
            return json.loads(body)
        except ValueError:
            await self._respond(writer, 400, {"error": "malformed JSON body"},
                                keep=req.keep)
            return None

    async def _peer_adopt(self, writer, req: _Request,
                          qs: Dict[str, List[str]]) -> None:
        """Adopt shipped replica state. Three kinds:

        - ``kind=container`` (default): a resumable byte upload. The body
          appends to ``<spool>/adopt-<vid>.part`` at the offset declared in
          ``x-zllm-offset`` — a mismatch answers ``409 {"offset": N}`` so a
          killed transfer re-syncs instead of restarting; ``?stat=1`` asks
          for the current offset without sending bytes. Once the declared
          ``total`` is present the bytes are sha256-verified and adopted
          via the store's temp+rename ``adopt_container``; the ``.part``
          stage is then deleted (fsck sweeps any crash leftovers).
        - ``kind=restore``: same upload discipline, but the bytes heal a
          *quarantined* version via ``restore_version``.
        - ``kind=record``: JSON ``{"key":..., "rec":...}`` adopted via
          ``adopt_index_record``; a missing ref closure answers 409 (ship
          the dependency containers first).
        """
        kind = qs.get("kind", ["container"])[0]
        loop = asyncio.get_running_loop()
        if kind == "record":
            spec = await self._read_json_body(writer, req)
            if spec is None:
                return
            try:
                key, rec = spec["key"], dict(spec["rec"])
            except (KeyError, TypeError):
                await self._respond(writer, 400,
                                    {"error": 'body must be {"key": ..., '
                                     '"rec": {...}}'}, keep=req.keep)
                return
            store = self._peer_store(key)
            try:
                await loop.run_in_executor(
                    self.engine._pool,
                    lambda: store.adopt_index_record(key, rec))
            except KeyError as e:  # ref target not live here yet
                await self._respond(writer, 409, {"error": str(e)},
                                    keep=req.keep)
                return
            await loop.run_in_executor(self.engine._pool, store.save_index)
            await self._respond(writer, 200, {"adopted": True}, keep=req.keep)
            return
        if kind not in ("container", "restore"):
            await self._drain_body(req)
            await self._respond(writer, 400,
                                {"error": f"unknown adopt kind {kind!r}"},
                                keep=req.keep)
            return
        key = qs.get("key", [None])[0]
        sha = qs.get("sha256", [""])[0]
        try:
            gen = int(qs.get("gen", ["-1"])[0])
            total = int(qs.get("total", ["-1"])[0])
        except ValueError:
            gen = total = -1
        if not key or gen < 0 or total < 0 or not sha:
            req.keep = False
            await self._respond(writer, 400,
                                {"error": "adopt needs key, gen, sha256 and "
                                 "total query params"}, keep=False)
            return
        store = self._peer_store(key)
        vid = make_vid(key, gen)
        part = os.path.join(store.spool_dir(),
                            "adopt-" + vid.replace("/", "__") + TMP_SUFFIX)
        have = os.path.getsize(part) if os.path.exists(part) else 0
        already = store.lifecycle.exists(key, gen) and not store.lifecycle.get(
            key, gen).quarantined
        if qs.get("stat", ["0"])[0] not in ("0", "false", ""):
            await self._drain_body(req)
            await self._respond(writer, 200,
                                {"offset": have, "adopted": already},
                                keep=req.keep)
            return
        if already and kind == "container":
            # idempotent short-circuit: the version is live here already
            await self._drain_body(req)
            try:
                os.remove(part)
            except OSError:
                pass
            await self._respond(writer, 200, {"adopted": False}, keep=req.keep)
            return
        try:
            offset = int(req.headers.get("x-zllm-offset", "0"))
            length = int(req.headers["content-length"])
        except (KeyError, ValueError):
            req.keep = False
            await self._respond(writer, 411,
                                {"error": "content-length and x-zllm-offset "
                                 "required"}, keep=False)
            return
        if offset != have or offset + length != total:
            # stale offset (e.g. the .part outlived a crashed transfer):
            # tell the shipper where to resume; its body goes unread, so
            # this connection cannot be reused
            req.keep = False
            await self._respond(writer, 409, {"offset": have}, keep=False)
            return
        received = 0
        with open(part, "ab") as f:
            while received < length:
                chunk = await asyncio.wait_for(
                    req.reader.read(min(_UPLOAD_CHUNK, length - received)),
                    timeout=120)
                if not chunk:
                    # killed mid-ship: keep the .part for resume, drop conn
                    raise ConnectionError("peer client closed mid-ship")
                await loop.run_in_executor(None, f.write, chunk)
                received += len(chunk)
            f.flush()
            os.fsync(f.fileno())
        if kind == "restore":
            try:
                ok = await loop.run_in_executor(
                    self.engine._pool,
                    lambda: store.restore_version(key, gen, part,
                                                  expected_sha256=sha))
            except ValueError as e:  # sha mismatch: corrupt ship, restart
                try:
                    os.remove(part)
                except OSError:
                    pass
                await self._respond(writer, 400, {"error": str(e)},
                                    keep=req.keep)
                return
            if not ok:  # not quarantined: nothing to heal, stage is debris
                try:
                    os.remove(part)
                except OSError:
                    pass
            await self._respond(writer, 200, {"restored": bool(ok)},
                                keep=req.keep)
            return
        try:
            adopted = await loop.run_in_executor(
                self.engine._pool,
                lambda: store.adopt_container(key, gen, part,
                                              expected_sha256=sha))
        except ValueError as e:  # sha mismatch: corrupt ship, restart clean
            try:
                os.remove(part)
            except OSError:
                pass
            await self._respond(writer, 400, {"error": str(e)}, keep=req.keep)
            return
        # crash window under test: the version is live in memory + on disk
        # but the index is not yet persisted — recovery is reopen + fsck +
        # the next sweep's idempotent re-ship
        store._fault("peer.adopt_pre_persist")
        await loop.run_in_executor(self.engine._pool, store.save_index)
        try:
            os.remove(part)  # adopt copied the bytes: the stage is debris
        except OSError:
            pass
        await self._respond(writer, 200, {"adopted": bool(adopted)},
                            keep=req.keep)

    async def _peer_tombstones(self, writer, req: _Request) -> None:
        spec = await self._read_json_body(writer, req)
        if spec is None:
            return
        batch = spec.get("tombstones")
        if not isinstance(batch, list):
            await self._respond(writer, 400,
                                {"error": 'body must be {"tombstones": '
                                 '[[key, gen, ts], ...]}'}, keep=req.keep)
            return

        def apply() -> int:
            n = 0
            touched = []
            for key, gen, ts in batch:
                store = self._peer_store(key)
                if store.apply_tombstone(str(key), int(gen), float(ts)):
                    n += 1
                if store not in touched:
                    touched.append(store)
            for store in touched:
                store.save_index()
            return n

        applied = await asyncio.get_running_loop().run_in_executor(
            self.engine._pool, apply)
        await self._respond(writer, 200,
                            {"applied": applied, "batch": len(batch)},
                            keep=req.keep)

    # -- response plumbing ----------------------------------------------------
    async def _respond(self, writer, status: int, obj: Dict, *,
                       keep: bool = False,
                       extra: Optional[List[Tuple[str, str]]] = None) -> None:
        body = (json.dumps(obj) + "\n").encode()
        await self._write(writer, status, body, "application/json",
                          extra or [], keep)

    @classmethod
    def _head(cls, status: int, length: int, ctype: str, extra,
              keep: bool) -> bytes:
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                f"content-type: {ctype}",
                f"content-length: {length}",
                "accept-ranges: bytes",
                f"connection: {'keep-alive' if keep else 'close'}"]
        head += [f"{k}: {v}" for k, v in extra]
        return ("\r\n".join(head) + "\r\n\r\n").encode()

    @classmethod
    async def _write(cls, writer, status: int, body, ctype: str, extra,
                     keep: bool) -> None:
        writer.write(cls._head(status, len(body), ctype, extra, keep))
        writer.write(body)
        await writer.drain()


class ServerThread:
    """Run a :class:`StoreServer` on a private event loop in a daemon
    thread — the harness for synchronous callers (tests, benches, soak).
    ``store`` may be a single :class:`ZLLMStore` or a
    :class:`StoreRouter`. Usable as a context manager; ``host``/``port``
    are set after start."""

    def __init__(self, store, **server_kw):
        self._store = store
        self._kw = server_kw
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self.server: Optional[StoreServer] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    def start(self) -> "ServerThread":
        started = threading.Event()
        fail: list = []

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                self.server = StoreServer(self._store, **self._kw)
                host_port = loop.run_until_complete(self.server.start())
            except BaseException as e:  # surface startup failures (e.g.
                # EADDRINUSE) to the caller; self._loop stays None so a
                # defensive stop() returns immediately instead of waiting on
                # a loop that will never run
                fail.append(e)
                self.server = None
                loop.close()
                started.set()
                return
            self._loop = loop
            self.host, self.port = host_port
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="zllm-server")
        self._thread.start()
        started.wait(timeout=60)
        if fail:
            raise fail[0]
        assert self.port is not None, "server failed to start within 60s"
        return self

    def submit(self, coro):
        """Schedule a coroutine on the server loop; returns a concurrent
        Future (e.g. ``submit(engine.run_gc()).result()``)."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def stop(self) -> None:
        if self._loop is None:
            return
        if self.server is not None:
            asyncio.run_coroutine_threadsafe(self.server.aclose(),
                                             self._loop).result(timeout=60)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=60)
        self._loop = None

    def __enter__(self) -> "ServerThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve zLLM store root(s) over HTTP (asyncio, stdlib-only)")
    ap.add_argument("--root", required=True, action="append",
                    help="store root directory (repeat for a sharded "
                         "multi-root node; repos are consistent-hashed "
                         "across roots)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8421)
    ap.add_argument("--store-workers", type=int, default=2,
                    help="ZLLMStore decode pool size (per root)")
    ap.add_argument("--serve-workers", type=int, default=8,
                    help="concurrent retrieval executor size (per root)")
    ap.add_argument("--cache-mb", type=int, default=128)
    ap.add_argument("--spill-mb", type=int, default=None,
                    help="decoded-spill disk budget per root, MB "
                         "(default: 4x --cache-mb; 0 disables the disk "
                         "tier)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip sha256 verification of responses")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica group size per repo (clamped to the "
                         "number of roots); 1 = shard-only placement")
    ap.add_argument("--write-quorum", type=int, default=None,
                    help="write acks required before a PUT succeeds "
                         "(default: majority of --replicas)")
    ap.add_argument("--peer", action="append", default=[],
                    help="remote peer URL (host:port; repeatable) mounted "
                         "as a replica root behind the /peer/* protocol — "
                         "replica groups then span server processes")
    args = ap.parse_args(argv)

    router = StoreRouter.open_roots(args.root, workers=args.store_workers,
                                    replicas=args.replicas,
                                    write_quorum=args.write_quorum,
                                    peers=args.peer)
    for name, store in router.items():
        if not store.file_index:
            print(f"store_server: no index under {store.root} "
                  f"(root {name} starts empty)", flush=True)

    async def amain():
        server = StoreServer(router, args.host, args.port,
                             max_concurrency=args.serve_workers,
                             cache_bytes=args.cache_mb << 20,
                             spill_bytes=(None if args.spill_mb is None
                                          else args.spill_mb << 20),
                             verify=not args.no_verify)
        host, port = await server.start()
        roots = ", ".join(f"{n}={s.root}" for n, s in router.items())
        print(f"store_server: serving {roots} on http://{host}:{port}",
              flush=True)
        await server.serve_forever()

    try:
        asyncio.run(amain())
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
