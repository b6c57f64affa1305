# Port copy of src/repro/core/lifecycle.py: host-only, logic unchanged.
"""Container lifecycle: immutable versions, refcounted GC, fsck reporting.

ZipLLM's storage win comes from cross-model sharing — tensor-dedup records
and BitX delta frames inside one repo's container point into containers
owned by *other* repos — so container lifetime is a correctness problem,
not a cleanup nicety. This module makes containers immutable *versions*:

* Every container write is a generation ``key@gN`` (gen 0 keeps the legacy
  ``<key>.bitx`` path, so v1 stores load unchanged; later generations live
  at ``<key>@gN.bitx``). Re-registering a key writes a new generation
  copy-on-write; dependants keep resolving against the generation they were
  pinned to at ingest time.
* ``ContainerLifecycle`` tracks the version graph: vertices are container
  versions, edges are "version A's records resolve into version B" (one
  edge per dependant/target pair, recorded at ingest). Anchors — the
  versions the store's live ``file_index`` entries point at — are supplied
  by the store at GC time.
* ``collect(anchors)`` is the refcounted sweep: a version survives iff it
  is reachable from an anchor through the edge graph (reachability ==
  cascading refcount decrement: reclaiming a version releases its outgoing
  references, which may free its targets in the same pass).
* ``quarantine`` parks a corrupted version out of the retrieval path while
  keeping its graph node (and therefore its dependencies) alive, so a
  repair can re-pin or restore without collateral GC; ``unquarantine`` is
  the inverse, applied after a healthy replica's bytes are swapped back in.
* ``tombstones`` are deletion markers (``key -> (gen, ts)``): a delete
  records the highest generation it covered, so replica anti-entropy can
  distinguish "this key was deleted" from "this replica never saw this
  key" — and, because generations are monotonic per key, a later re-upload
  (``gen > tombstone gen``) legitimately clears the marker instead of
  being mistaken for a resurrection.

The store (``repro_torch.core.pipeline.ZLLMStore``) owns the policy: which
versions are anchored, how ``tensor_locations`` entries are scrubbed after
a sweep, and what ``fsck`` checks. This module owns the mechanism.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["ContainerLifecycle", "VersionInfo", "FsckReport", "make_vid"]


def make_vid(key: str, gen: int) -> str:
    """Canonical version id for container ``key`` at generation ``gen``."""
    return f"{key}@g{gen}"


@dataclass
class VersionInfo:
    """One immutable container version on disk."""

    key: str
    gen: int
    path: str
    nbytes: int
    quarantined: bool = False

    @property
    def vid(self) -> str:
        return make_vid(self.key, self.gen)


@dataclass
class FsckReport:
    """Outcome of a store fsck walk.

    ``dangling`` — references (tensor hash or file ref) that no longer
    resolve to a live container frame. ``corrupt`` — containers that fail
    structural or sha256 spot checks. ``orphans`` — container files on disk
    that no live or quarantined version references (crash debris from an
    interrupted ingest; ``repair=True`` deletes them).
    ``repaired``/``quarantined`` record what a ``repair=True`` pass actually
    did; a repaired reference is not also listed as dangling.
    """

    checked_versions: int = 0
    checked_files: int = 0
    checked_refs: int = 0
    spot_checked: int = 0
    dangling: List[Tuple[str, str]] = field(default_factory=list)
    corrupt: List[Tuple[str, str]] = field(default_factory=list)
    orphans: List[str] = field(default_factory=list)
    repaired: List[Tuple[str, str]] = field(default_factory=list)
    quarantined: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.dangling and not self.corrupt

    def summary(self) -> Dict:
        return {
            "ok": self.ok,
            "checked_versions": self.checked_versions,
            "checked_files": self.checked_files,
            "checked_refs": self.checked_refs,
            "spot_checked": self.spot_checked,
            "n_dangling": len(self.dangling),
            "n_corrupt": len(self.corrupt),
            "n_orphans": len(self.orphans),
            "n_repaired": len(self.repaired),
            "n_quarantined": len(self.quarantined),
        }


class ContainerLifecycle:
    """Version graph + refcounted GC for a store's containers."""

    def __init__(self):
        self.versions: Dict[str, VersionInfo] = {}      # vid -> live version
        self.max_gen: Dict[str, int] = {}               # key -> highest gen ever
        self.edges: Dict[str, Set[str]] = {}            # dependant vid -> target vids
        self.tombstones: Dict[str, Tuple[int, float]] = {}  # key -> (gen, ts)
        self.reclaimed_bytes = 0
        self.n_collected = 0
        self.n_gc_runs = 0
        self._live_bytes = 0  # running sum: O(1) live_bytes() on the ingest path

    # -- registration ----------------------------------------------------
    def next_generation(self, key: str) -> int:
        """Generation the next container write for ``key`` should use.
        Monotonic per key — generations of reclaimed versions are never
        reused, so stale paths can't be resurrected."""
        return self.max_gen[key] + 1 if key in self.max_gen else 0

    def register_version(self, key: str, gen: int, path: str, nbytes: int) -> VersionInfo:
        info = VersionInfo(key, gen, path, nbytes)
        self.versions[info.vid] = info
        self.max_gen[key] = max(gen, self.max_gen.get(key, -1))
        self._live_bytes += nbytes
        return info

    def add_edge(self, src_vid: str, dst_vid: str) -> None:
        """Record that container ``src_vid`` resolves into ``dst_vid``
        (a dedup record or a BitX base reference). Self-edges are dropped —
        a container trivially keeps itself alive while anchored."""
        if src_vid != dst_vid:
            self.edges.setdefault(src_vid, set()).add(dst_vid)

    def set_nbytes(self, key: str, gen: int, nbytes: int) -> None:
        """Fix up a version's on-disk size after a deferred container write
        (the pipelined ingest engine registers the version at decision time,
        before the bytes hit disk)."""
        v = self.versions.get(make_vid(key, gen))
        if v is None:
            return
        if not v.quarantined:
            self._live_bytes += nbytes - v.nbytes
        v.nbytes = nbytes

    def discard(self, key: str, gen: int) -> None:
        """Drop a version whose container write failed — the inverse of
        ``register_version`` for a version that never made it to disk.
        ``max_gen`` is left alone so the generation number is never reused."""
        v = self.versions.pop(make_vid(key, gen), None)
        if v is None:
            return
        if not v.quarantined:
            self._live_bytes -= v.nbytes
        self.edges.pop(v.vid, None)

    # -- queries ---------------------------------------------------------
    def get(self, key: str, gen: int) -> Optional[VersionInfo]:
        return self.versions.get(make_vid(key, gen))

    def exists(self, key: str, gen: int) -> bool:
        v = self.versions.get(make_vid(key, gen))
        return v is not None and not v.quarantined

    def version_path(self, key: str, gen: int) -> str:
        v = self.versions.get(make_vid(key, gen))
        if v is None:
            raise KeyError(f"container version {make_vid(key, gen)} is unknown "
                           f"or was garbage-collected")
        if v.quarantined:
            raise RuntimeError(f"container version {v.vid} is quarantined "
                               f"(fsck found it corrupt): {v.path}")
        return v.path

    def live_bytes(self) -> int:
        return self._live_bytes

    def refcounts(self) -> Dict[str, int]:
        """Incoming-edge count per live version (anchors not included)."""
        counts = {vid: 0 for vid in self.versions}
        for src, dsts in self.edges.items():
            if src in self.versions:            # edges of reclaimed versions are gone
                for dst in dsts:
                    if dst in counts:
                        counts[dst] += 1
        return counts

    # -- GC ----------------------------------------------------------------
    def reachable(self, roots: Iterable[str]) -> Set[str]:
        """Live version ids transitively reachable from ``roots`` over the
        edge graph — the mark phase shared by stop-the-world ``collect``,
        the store's incremental GC steps, and ``compact()``."""
        live: Set[str] = set()
        stack = [r for r in roots if r in self.versions]
        while stack:
            vid = stack.pop()
            if vid in live:
                continue
            live.add(vid)
            for dst in self.edges.get(vid, ()):
                if dst not in live and dst in self.versions:
                    stack.append(dst)
        return live

    def gc_roots(self, anchors: Iterable[str]) -> List[str]:
        """``anchors`` plus every quarantined version: quarantined versions
        are roots too — their dependency targets must stay alive so a later
        restore/repair still resolves (the documented quarantine
        guarantee)."""
        roots = [a for a in anchors]
        roots += [vid for vid, v in self.versions.items() if v.quarantined]
        return roots

    def retire(self, key: str, gen: int) -> Optional[VersionInfo]:
        """Reclaim one version (GC / compaction accounting: counts toward
        ``reclaimed_bytes``/``n_collected``, unlike :meth:`discard` which is
        for versions that never made it to disk). The caller is responsible
        for having proven the version dead and for deleting the file."""
        v = self.versions.pop(make_vid(key, gen), None)
        if v is None:
            return None
        self.edges.pop(v.vid, None)
        if not v.quarantined:
            self._live_bytes -= v.nbytes
        self.reclaimed_bytes += v.nbytes
        self.n_collected += 1
        return v

    def collect(self, anchors: Iterable[str]) -> List[VersionInfo]:
        """Reclaim every version unreachable from ``anchors``.

        Reachability over the edge graph is the cascading refcount
        decrement: a superseded generation survives exactly as long as some
        anchored dependant (transitively) points into it. Quarantined
        versions are pinned — they are kept even when unreachable, so a
        later repair can still inspect them.

        Returns the reclaimed versions; the caller deletes the files and
        scrubs its hash indexes.
        """
        self.n_gc_runs += 1
        live = self.reachable(self.gc_roots(anchors))
        reclaimed = [v for vid, v in self.versions.items()
                     if vid not in live and not v.quarantined]
        for v in reclaimed:
            self.retire(v.key, v.gen)
        return reclaimed

    def quarantine(self, key: str, gen: int, new_path: str) -> None:
        """Mark a version corrupt and point it at its quarantine location.
        The graph node stays (keeping its dependency targets alive) so a
        repair can re-pin dependants before the version is dropped."""
        v = self.versions[make_vid(key, gen)]
        if not v.quarantined:
            self._live_bytes -= v.nbytes
        v.quarantined = True
        v.path = new_path

    def unquarantine(self, key: str, gen: int, new_path: str) -> None:
        """Return a quarantined version to the live set after its bytes were
        restored (verbatim, sha256-verified) from a healthy replica. The
        inverse of :meth:`quarantine`: the version becomes retrievable again
        at ``new_path`` and counts toward live bytes."""
        v = self.versions[make_vid(key, gen)]
        if v.quarantined:
            self._live_bytes += v.nbytes
        v.quarantined = False
        v.path = new_path

    # -- tombstones --------------------------------------------------------
    def record_tombstone(self, key: str, gen: int, ts: float) -> None:
        """Record that ``key`` was deleted at a moment when its highest
        known generation was ``gen``. Merging keeps the max generation (and
        the freshest timestamp), so tombstones are idempotent and
        commutative across replicas."""
        old = self.tombstones.get(key)
        if old is None:
            self.tombstones[key] = (gen, ts)
        else:
            self.tombstones[key] = (max(gen, old[0]), max(ts, old[1]))

    def tombstone_for(self, key: str) -> Optional[Tuple[int, float]]:
        return self.tombstones.get(key)

    def tombstone_covers(self, key: str, gen: int) -> bool:
        """True when a recorded delete supersedes generation ``gen`` of
        ``key`` — a replica holding such a generation must drop it rather
        than re-ship it (anti-resurrection rule)."""
        t = self.tombstones.get(key)
        return t is not None and gen <= t[0]

    def clear_tombstone(self, key: str) -> None:
        """A re-upload produced a generation above the tombstone's: the
        delete marker has been superseded and must stop deleting."""
        self.tombstones.pop(key, None)

    def prune_tombstones(self, now: float, ttl_s: float) -> int:
        """Drop tombstones older than ``ttl_s`` (anti-entropy has long since
        converged every replica). Returns how many were pruned."""
        stale = [k for k, (_, ts) in self.tombstones.items() if now - ts > ttl_s]
        for k in stale:
            del self.tombstones[k]
        return len(stale)

    # -- persistence -------------------------------------------------------
    def to_json(self) -> Dict:
        return {
            "versions": [[v.key, v.gen, v.path, v.nbytes, v.quarantined]
                         for v in self.versions.values()],
            "max_gen": self.max_gen,
            "edges": {src: sorted(dsts) for src, dsts in self.edges.items() if dsts},
            # v4: deletion markers ride the lifecycle blob (absent pre-v4 —
            # from_json defaults them empty, so older indexes load unchanged)
            "tombstones": {k: [g, ts] for k, (g, ts) in self.tombstones.items()},
            "reclaimed_bytes": self.reclaimed_bytes,
            "n_collected": self.n_collected,
            "n_gc_runs": self.n_gc_runs,
        }

    @staticmethod
    def from_json(d: Dict) -> "ContainerLifecycle":
        lc = ContainerLifecycle()
        for key, gen, path, nbytes, quarantined in d.get("versions", []):
            info = lc.register_version(key, int(gen), path, int(nbytes))
            if quarantined:
                info.quarantined = True
                lc._live_bytes -= info.nbytes
        for key, gen in d.get("max_gen", {}).items():
            lc.max_gen[key] = max(int(gen), lc.max_gen.get(key, -1))
        lc.edges = {src: set(dsts) for src, dsts in d.get("edges", {}).items()}
        lc.tombstones = {k: (int(g), float(ts))
                         for k, (g, ts) in d.get("tombstones", {}).items()}
        lc.reclaimed_bytes = int(d.get("reclaimed_bytes", 0))
        lc.n_collected = int(d.get("n_collected", 0))
        lc.n_gc_runs = int(d.get("n_gc_runs", 0))
        return lc
