# Port copy of src/repro/serve/peer.py: host-only, logic unchanged.
"""Remote peer client: a ``ZLLMStore``-shaped handle over the wire.

The replicated tier (``repro_torch.serve.router.StoreRouter``) converges replica
groups through a narrow set of store primitives — enqueue a spooled ingest,
diff per-key index state, ship container bytes verbatim, adopt them
sha256-verified, union tombstones, restore quarantined versions. The router
proved those primitives inside one process; this module promotes them to a
peer-to-peer HTTP protocol so a replica group can span real server
processes. :class:`PeerStore` implements the **RootHandle** subset of the
``ZLLMStore`` API the router actually calls (same method names, same
signatures, same exception contracts), so ``StoreRouter`` holds a mix of
local roots and remote peers behind one interface and the replication
logic stays polymorphic:

==========================  =============================================
local root (``ZLLMStore``)  remote peer (``PeerStore``)
==========================  =============================================
``file_index`` dict         cached snapshot of ``GET /peer/index_digest``
``lifecycle`` graph         :class:`_PeerLifecycle` view over the snapshot
``container_digest``        ``GET /peer/container/<key@gN>?digest=1``
``adopt_container``         resumable upload via ``POST /peer/adopt``
``adopt_index_record``      ``POST /peer/adopt?kind=record``
``apply_tombstone``         ``POST /peer/tombstones``
``restore_version``         upload via ``POST /peer/adopt?kind=restore``
``enqueue_ingest``          ``PUT /repo/<id>/file/<name>`` (spool upload)
``spool_dir()``             a *local* staging directory for ship buffers
==========================  =============================================

Transfers are **authenticated by digest**: every container body carries
its sha256 (query param on upload, ``x-zllm-sha256`` header on download)
and the receiving side refuses bytes that do not hash to it — the same
end-to-end identity check in-process adoption performs, now guarding the
wire too. Shipping is **resumable**: downloads stage into a ``.part``
file and continue with ``Range: bytes=`` after a killed transfer; uploads
carry an ``x-zllm-offset`` and re-sync against the server's partial
``.part`` (a ``409`` answers the current offset). ``.part`` staging files
are crash debris by construction — ``fsck(repair=True)`` sweeps them.

Failure policy: control-plane reads (``file_index``, ``lifecycle``) never
raise — an unreachable peer serves its last-known snapshot (empty when
none), so routing and diffing survive partitions; explicit refreshes and
every mutation raise :class:`PeerUnreachable`, which the router's health
tracker turns into suspect-backoff state exactly as for a local error.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import tempfile
import threading
import time
from http.client import HTTPConnection, HTTPException
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import quote, urlencode, urlsplit

from repro_torch.core.bitx import TMP_SUFFIX
from repro_torch.core.lifecycle import make_vid

__all__ = ["PeerStore", "PeerUnreachable"]

_CHUNK = 1 << 20


class PeerUnreachable(ConnectionError):
    """The peer did not answer (refused, timed out, died mid-transfer)."""


class _PeerVersion:
    """Snapshot view of one container version on the peer (no local
    ``path`` — bytes are fetched on demand)."""

    __slots__ = ("key", "gen", "nbytes", "quarantined")

    def __init__(self, key: str, gen: int, nbytes: int, quarantined: bool):
        self.key, self.gen = key, int(gen)
        self.nbytes, self.quarantined = int(nbytes), bool(quarantined)

    @property
    def vid(self) -> str:
        return make_vid(self.key, self.gen)


class _PeerLifecycle:
    """Read-only ``ContainerLifecycle`` facade over the peer snapshot —
    exactly the attributes the router's anti-entropy logic touches."""

    def __init__(self, peer: "PeerStore"):
        self._peer = peer

    @property
    def tombstones(self) -> Dict[str, Tuple[int, float]]:
        snap = self._peer._snapshot()
        return {k: (int(g), float(ts))
                for k, (g, ts) in snap.get("tombstones", {}).items()}

    def tombstone_for(self, key: str) -> Optional[Tuple[int, float]]:
        return self.tombstones.get(key)

    @property
    def versions(self) -> Dict[str, _PeerVersion]:
        snap = self._peer._snapshot()
        out = {}
        for vid, v in snap.get("versions", {}).items():
            key, _, gen = vid.rpartition("@g")
            out[vid] = _PeerVersion(key, int(gen), v.get("nbytes", 0),
                                    v.get("quarantined", False))
        return out

    @property
    def edges(self) -> Dict[str, List[str]]:
        snap = self._peer._snapshot()
        return {vid: list(v.get("edges", ()))
                for vid, v in snap.get("versions", {}).items()}

    def get(self, key: str, gen: int) -> Optional[_PeerVersion]:
        return self.versions.get(make_vid(key, gen))

    def exists(self, key: str, gen: int) -> bool:
        return self.get(key, gen) is not None


class _PeerFsck:
    """Shape-compatible stand-in for ``FsckReport`` built from the peer's
    ``/admin/fsck`` JSON."""

    def __init__(self, d: Dict):
        self._d = d
        self.ok = bool(d.get("ok", False))
        self.orphans = [None] * int(d.get("orphans", 0))
        self.quarantined = [None] * int(d.get("quarantined", 0))

    def summary(self) -> Dict:
        return self._d


class PeerStore:
    """HTTP client for one remote peer, presenting the RootHandle subset
    of the ``ZLLMStore`` API (see module docstring). Thread-safe: one
    connection per request, a lock only around the snapshot cache."""

    is_peer = True

    def __init__(self, url: str, *, timeout: float = 10.0,
                 snapshot_ttl: float = 0.25,
                 staging_dir: Optional[str] = None):
        u = urlsplit(url if "//" in url else "http://" + url)
        self.host, self.port = u.hostname, u.port or 80
        self.url = f"http://{self.host}:{self.port}"
        self.root = self.url  # display parity with ZLLMStore.root
        self.timeout = timeout
        self.snapshot_ttl = snapshot_ttl
        self._staging = staging_dir
        self._staging_owned = staging_dir is None
        self._snap: Optional[Dict] = None
        self._snap_at = -1e9
        self._snap_lock = threading.Lock()
        self.lifecycle = _PeerLifecycle(self)
        # wired by StoreRouter to its own _fault so wire-protocol fault
        # points (peer.ship_mid_body) fire from the coordinator's hook
        self.fault_hook = None

    # -- transport -------------------------------------------------------
    def _request(self, method: str, path: str, body=None,
                 headers: Optional[Dict[str, str]] = None,
                 ) -> Tuple[int, Dict[str, str], bytes]:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
        except (OSError, socket.timeout, HTTPException) as e:
            raise PeerUnreachable(f"{method} {self.url}{path}: "
                                  f"{type(e).__name__}: {e}") from e
        finally:
            conn.close()

    def _json(self, method: str, path: str, body=None,
              headers: Optional[Dict[str, str]] = None,
              ok: Tuple[int, ...] = (200,)) -> Dict:
        status, _, payload = self._request(method, path, body, headers)
        if status not in ok:
            raise RuntimeError(f"{method} {path} on {self.url} answered "
                               f"{status}: {payload[:200]!r}")
        return json.loads(payload or b"{}")

    def probe(self) -> bool:
        """Health probe: does the peer answer ``/healthz`` right now?"""
        try:
            return bool(self._json("GET", "/healthz").get("ok"))
        except (PeerUnreachable, RuntimeError, ValueError):
            return False

    # -- snapshot (the wire form of file_index + lifecycle) --------------
    def _snapshot(self) -> Dict:
        with self._snap_lock:
            fresh = (self._snap is not None
                     and time.monotonic() - self._snap_at < self.snapshot_ttl)
            if fresh:
                return self._snap
        try:
            return self.refresh_snapshot()
        except (PeerUnreachable, RuntimeError, ValueError):
            with self._snap_lock:  # stale beats crashed for routing reads
                return self._snap if self._snap is not None else {}

    def refresh_snapshot(self) -> Dict:
        """Fetch ``/peer/index_digest`` now; raises when unreachable —
        anti-entropy calls this to guarantee it diffs live state, while
        plain routing reads tolerate a stale snapshot."""
        snap = self._json("GET", "/peer/index_digest")
        with self._snap_lock:
            self._snap, self._snap_at = snap, time.monotonic()
        return snap

    def invalidate(self) -> None:
        with self._snap_lock:
            self._snap_at = -1e9

    @property
    def file_index(self) -> Dict[str, Dict]:
        return self._snapshot().get("keys", {})

    @property
    def base_paths(self) -> Dict[str, str]:
        return {b: "" for b in self._snapshot().get("base_paths", ())}

    @property
    def read_gen(self) -> int:
        return int(self._snapshot().get("read_gen", -1))

    # -- replication primitives over the wire ----------------------------
    def container_digest(self, key: str, gen: int,
                         allow_quarantined: bool = False) -> str:
        vid = quote(make_vid(key, gen), safe="")
        q = "?digest=1" + ("&allow_quarantined=1" if allow_quarantined else "")
        status, _, payload = self._request(
            "GET", f"/peer/container/{vid}{q}")
        if status == 404:
            raise KeyError(f"container version {make_vid(key, gen)} is "
                           f"unknown on {self.url}")
        if status == 410:
            raise RuntimeError(f"container version {make_vid(key, gen)} is "
                               f"quarantined on {self.url}")
        if status != 200:
            raise RuntimeError(f"digest of {make_vid(key, gen)} on "
                               f"{self.url}: {status} {payload[:200]!r}")
        return json.loads(payload)["sha256"]

    def fetch_container(self, key: str, gen: int, dst_dir: str) -> str:
        """Download one container's verbatim bytes into ``dst_dir``,
        resumably: bytes stage into a ``.part`` sibling, a retry continues
        with ``Range: bytes=<have>-`` from wherever the last attempt died,
        and the finished file is sha256-verified against the peer's
        ``x-zllm-sha256`` before the atomic rename."""
        vid = make_vid(key, gen)
        final = os.path.join(dst_dir, "fetch-" + vid.replace("/", "__"))
        part = final + TMP_SUFFIX
        have = os.path.getsize(part) if os.path.exists(part) else 0
        headers = {"range": f"bytes={have}-"} if have else {}
        qpath = "/peer/container/" + quote(vid, safe="")
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request("GET", qpath, headers=headers)
            r = conn.getresponse()
            hdrs = {k.lower(): v for k, v in r.getheaders()}
            if r.status == 404:
                r.read()
                raise KeyError(f"container version {vid} unknown on {self.url}")
            if r.status == 410:
                r.read()
                raise RuntimeError(f"container version {vid} quarantined on "
                                   f"{self.url}")
            if r.status == 416:  # .part already holds the full body
                r.read()
            elif r.status in (200, 206):
                mode = "ab" if r.status == 206 else "wb"
                with open(part, mode) as f:
                    while True:
                        chunk = r.read(_CHUNK)
                        if not chunk:
                            break
                        f.write(chunk)
                    f.flush()
                    os.fsync(f.fileno())
            else:
                body = r.read()
                raise RuntimeError(f"fetch {vid} from {self.url}: "
                                   f"{r.status} {body[:200]!r}")
        except (OSError, socket.timeout, HTTPException) as e:
            # partial bytes stay in .part — the next attempt resumes
            raise PeerUnreachable(f"fetch {vid} from {self.url} died "
                                  f"mid-transfer: {e}") from e
        finally:
            conn.close()
        expect = hdrs.get("x-zllm-sha256", "")
        h = hashlib.sha256()
        with open(part, "rb") as f:
            for chunk in iter(lambda: f.read(_CHUNK), b""):
                h.update(chunk)
        if expect and h.hexdigest() != expect:
            os.remove(part)  # corrupt partial state: restart from zero
            raise ValueError(f"fetched container {vid} failed sha256 "
                             f"verification against {self.url}")
        os.replace(part, final)
        return final

    def adopt_container(self, key: str, gen: int, src_path: str,
                        expected_sha256: Optional[str] = None) -> bool:
        """Ship ``src_path``'s bytes to the peer and have it adopt them as
        ``key@gN`` (idempotent, sha256-verified server-side). Resumable:
        a killed upload re-syncs against the peer's ``.part`` offset."""
        if expected_sha256 is None:
            h = hashlib.sha256()
            with open(src_path, "rb") as f:
                for chunk in iter(lambda: f.read(_CHUNK), b""):
                    h.update(chunk)
            expected_sha256 = h.hexdigest()
        total = os.path.getsize(src_path)
        q = urlencode({"key": key, "gen": gen, "sha256": expected_sha256,
                       "total": total})
        offset, last = 0, None
        for _ in range(4):
            body = _UploadReader(src_path, offset, self.fault_hook)
            try:
                status, _, payload = self._request(
                    "POST", f"/peer/adopt?{q}", body=body,
                    headers={"content-length": str(total - offset),
                             "x-zllm-offset": str(offset)})
            except PeerUnreachable as e:
                last = e
                offset = self._adopt_offset(q)
                if offset is None:  # peer adopted before the answer died
                    self.invalidate()
                    return True
                continue
            finally:
                body.close()
            if status == 409:  # offset mismatch: re-sync and resend
                offset = int(json.loads(payload).get("offset", 0))
                continue
            if status != 200:
                raise RuntimeError(f"adopt {make_vid(key, gen)} on "
                                   f"{self.url}: {status} {payload[:200]!r}")
            self.invalidate()
            return bool(json.loads(payload).get("adopted"))
        raise last or PeerUnreachable(
            f"adopt {make_vid(key, gen)} on {self.url}: retries exhausted")

    def _adopt_offset(self, q: str) -> Optional[int]:
        """Re-sync a killed upload: ask the peer how much of the ``.part``
        it holds (``None`` == it already adopted the full container)."""
        info = self._json("POST", f"/peer/adopt?{q}&stat=1",
                          headers={"content-length": "0"})
        return None if info.get("adopted") else int(info.get("offset", 0))

    def adopt_index_record(self, key: str, rec: Dict) -> None:
        rec = {k: v for k, v in rec.items() if k != "path"}
        status, _, payload = self._request(
            "POST", "/peer/adopt?kind=record",
            body=json.dumps({"key": key, "rec": rec}).encode(),
            headers={"content-type": "application/json"})
        if status == 409:  # ref closure not live yet — mirror the local
            raise KeyError(json.loads(payload).get("error", "ref not live"))
        if status != 200:
            raise RuntimeError(f"adopt record {key} on {self.url}: "
                               f"{status} {payload[:200]!r}")
        self.invalidate()

    def apply_tombstone(self, key: str, gen: int, ts: float) -> bool:
        out = self._json("POST", "/peer/tombstones",
                         body=json.dumps(
                             {"tombstones": [[key, int(gen), float(ts)]]}
                         ).encode(),
                         headers={"content-type": "application/json"})
        self.invalidate()
        return bool(out.get("applied", 0))

    def restore_version(self, key: str, gen: int, staged_path: str,
                        expected_sha256: Optional[str] = None) -> bool:
        """Quarantine-restore on the peer: upload the healthy donor bytes
        (already staged locally) and have the peer swap them back in."""
        if expected_sha256 is None:
            h = hashlib.sha256()
            with open(staged_path, "rb") as f:
                for chunk in iter(lambda: f.read(_CHUNK), b""):
                    h.update(chunk)
            expected_sha256 = h.hexdigest()
        total = os.path.getsize(staged_path)
        q = urlencode({"key": key, "gen": gen, "sha256": expected_sha256,
                       "total": total, "kind": "restore"})
        with open(staged_path, "rb") as body:
            out = self._json("POST", f"/peer/adopt?{q}", body=body,
                             headers={"content-length": str(total),
                                      "x-zllm-offset": "0"})
        try:
            os.remove(staged_path)  # uploaded: the local stage is debris
        except OSError:
            pass
        self.invalidate()
        return bool(out.get("restored"))

    # -- write/read plumbing the router fans out through ------------------
    def spool_dir(self) -> str:
        """LOCAL staging directory for bytes headed to this peer (fan-out
        copies, ship buffers). The peer's own spool is its server's."""
        if self._staging is None:
            self._staging = tempfile.mkdtemp(prefix="zllm-peer-")
        os.makedirs(self._staging, exist_ok=True)
        return self._staging

    def enqueue_ingest(self, uploads: Sequence, *, cleanup: bool = False) -> str:
        """Upload the spooled file(s) to the peer's PUT route (its server
        spools + enqueues exactly as a local ``enqueue_ingest`` would) and
        return the LAST job id — the router fans out one file at a time."""
        jid = None
        for u in uploads:
            path, repo_id, filename, base = (tuple(u) + (None, None))[:4]
            filename = filename or os.path.basename(path)
            target = (f"/repo/{quote(repo_id, safe='/')}/file/"
                      f"{quote(filename, safe='')}")
            if base:
                target += "?" + urlencode({"base": base})
            total = os.path.getsize(path)
            with open(path, "rb") as body:
                out = self._json("PUT", target, body=body,
                                 headers={"content-length": str(total)},
                                 ok=(200, 202))
            jid = out.get("job_id") or (out.get("job") or {}).get("job_id")
            if cleanup:
                try:
                    os.remove(path)
                except OSError:
                    pass
        self.invalidate()
        return jid

    def ingest_job(self, job_id: str) -> Optional[Dict]:
        try:
            status, _, payload = self._request(
                "GET", f"/admin/jobs?{urlencode({'job': job_id})}")
        except PeerUnreachable:
            return None  # await_quorum counts an unreachable job as dead
        if status != 200:
            return None
        return json.loads(payload)

    def ingest_jobs(self, limit: int = 64) -> List[Dict]:
        try:
            return self._json("GET", "/admin/jobs").get("jobs", [])[:limit]
        except (PeerUnreachable, RuntimeError, ValueError):
            return []

    def delete_file(self, repo_id: str, filename: str) -> bool:
        out = self._json("DELETE",
                         f"/repo/{quote(repo_id, safe='/')}/file/"
                         f"{quote(filename, safe='')}")
        self.invalidate()
        return bool(out.get("deleted", 0))

    def delete_repo(self, repo_id: str) -> int:
        out = self._json("DELETE", f"/repo/{quote(repo_id, safe='/')}")
        self.invalidate()
        return int(out.get("deleted", 0))

    def retrieve_file(self, repo_id: str,
                      filename: str = "model.safetensors") -> bytes:
        status, _, payload = self._request(
            "GET", f"/repo/{quote(repo_id, safe='/')}/file/"
                   f"{quote(filename, safe='')}")
        if status == 404:
            raise KeyError(f"{repo_id}/{filename} unknown on {self.url}")
        if status != 200:
            raise RuntimeError(f"retrieve {repo_id}/{filename} from "
                               f"{self.url}: {status}")
        return payload

    # -- admin parity -----------------------------------------------------
    def save_index(self) -> None:
        """No-op: the peer's server persists its own index after every
        adopt / tombstone / delete it serves."""

    def fsck(self, repair: bool = False,
             spot_check: Optional[int] = 4) -> _PeerFsck:
        q = urlencode({"repair": int(repair),
                       "spot_check": ("none" if spot_check is None
                                      else spot_check)})
        return _PeerFsck(self._json("POST", f"/admin/fsck?{q}",
                                    headers={"content-length": "0"}))

    def summary(self) -> Dict:
        try:
            out = self._json("GET", "/stats")["store"]
            out.setdefault("unreachable", False)
            return out
        except (PeerUnreachable, RuntimeError, ValueError, KeyError):
            zeros = {k: 0 for k in ("n_files", "raw_bytes", "stored_bytes",
                                    "file_dedup_hits", "near_dup_hits")}
            zeros["lifecycle"] = {k: 0 for k in (
                "versions", "live_bytes", "superseded_bytes",
                "reclaimed_bytes", "collected", "gc_runs", "deleted_files",
                "compact_runs", "compaction_reclaimed_bytes",
                "gc_max_pause_ms")}
            zeros.update(read_gen=-1, reduction_ratio=0.0, unreachable=True,
                         peer=self.url)
            return zeros

    def close(self) -> None:
        if self._staging_owned and self._staging is not None:
            shutil.rmtree(self._staging, ignore_errors=True)
            self._staging = None


class _UploadReader:
    """File-like upload body starting at ``offset``. ``http.client``
    drains it in blocks, so a ``fault_hook`` (the router's crash harness)
    fires **mid-body** — on the second read, after the first block hit the
    wire — simulating a coordinator killed inside a container ship."""

    def __init__(self, path: str, offset: int, fault_hook=None):
        self._f = open(path, "rb")
        self._f.seek(offset)
        self._fault_hook = fault_hook
        self._reads = 0

    def read(self, n: int = -1) -> bytes:
        self._reads += 1
        if self._reads == 2 and self._fault_hook is not None:
            self._fault_hook("peer.ship_mid_body")
        return self._f.read(n)

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
