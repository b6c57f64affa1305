# Port copy of src/repro/serve/router.py: host-only, logic unchanged.
"""Multi-store routing: one serving frontend over N ``ZLLMStore`` roots.

A hub node outgrows a single store root long before it outgrows a single
machine: separate NVMe volumes, per-tenant roots, or simply more index than
one process cares to keep hot. ``StoreRouter`` spreads *repos* across N
roots with **rendezvous (highest-random-weight) consistent hashing** —
every repo deterministically owns one root, adding a root only moves
~1/(N+1) of the keyspace, and no ring state needs persisting — while the
HTTP layer stays oblivious: it asks the router which store serves a repo
and proceeds exactly as in the single-root case.

Placement vs. location: ``place()`` is the pure hash (where a new repo
*goes*); ``locate()`` prefers a root that already *has* the key (so a
router can be put in front of pre-existing stores whose contents predate
the hash placement) and falls back to ``place()`` for keys nobody holds.
Writes route through ``locate()`` too — a re-registration must land on the
root that holds the repo's earlier generations, or the dedup/BitX chain
would be severed.

Stats keep the **flat single-root shape** when there is one root (the
``server_smoke`` back-compat contract) and nest per-root sections plus
cross-root aggregates under N roots. Admin operations (gc / compact /
fsck) fan out to every root, or to one root via its name.

**Replication** (``replicas=N``): the rendezvous hash's *ordered* candidate
list is the replica group — the top-N scoring roots hold copies of every
repo. Writes fan out to the whole group and acknowledge at a configurable
write quorum (W of N, retry + exponential backoff per root, asynchronous
repair of stragglers on the store's job worker); reads fail over down the
candidate list behind a health tracker (a failing root turns *suspect* and
is probed again after an exponentially growing backoff); an
**anti-entropy sweep** diffs the per-root ``(key, gen)`` indexes within
each group, applies delete tombstones, restores quarantined containers
from healthy same-generation copies (sha256-verified, swapped back in) and
re-ships missing generations with container bytes copied **verbatim** —
replica containers stay bit-identical. One caveat is inherent: per-root
``.compact/pool`` containers are local artifacts (roots compact
independently), so a quarantined pool version has no same-bytes donor;
anchored containers — everything a client can address — always do.

The router owns no asyncio state — it is shared safely between the event
loop and worker threads; per-root ``RetrievalEngine`` construction stays in
the server (engines are loop-confined).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.lifecycle import make_vid
from repro_torch.core.pipeline import ZLLMStore

__all__ = ["StoreRouter", "RootDownError", "QuorumError",
           "REPLICATION_FAULT_POINTS"]

# Fault points the replication crash harness (tests/test_replication.py,
# tests/test_peer_replication.py) may kill the router at, via
# ``router.fault_hook`` — same contract as the store's COMPACT/GC fault
# points: no cleanup runs when the hook raises. The ``peer.*`` points fire
# on the wire protocol (``peer.ship_mid_body`` from the shipping client
# after the first body chunk, ``peer.adopt_pre_persist`` on the receiving
# server between adopt and index persist); ``hint.pre_drain_persist``
# fires after a hinted re-ship lands but before the hint log drops it.
REPLICATION_FAULT_POINTS = ("put.mid_fanout", "put.post_quorum",
                            "anti_entropy.mid_copy", "restore.mid_copy",
                            "peer.ship_mid_body", "peer.adopt_pre_persist",
                            "hint.pre_drain_persist")


class RootDownError(ConnectionError):
    """A replica root is down (health tracker) — writes/reads must not be
    attempted against it."""


class QuorumError(ConnectionError):
    """Fewer than ``write_quorum`` replicas accepted a write."""


class _RootHealth:
    """Per-root health record (guarded by the router's health lock)."""

    __slots__ = ("down", "fails", "suspect_until")

    def __init__(self):
        self.down = False           # manual/chaos switch: hard-unreachable
        self.fails = 0              # consecutive organic failures
        self.suspect_until = 0.0    # monotonic deadline of the probe backoff

# store.summary() keys that aggregate by plain summation across roots
_SUM_KEYS = ("n_files", "raw_bytes", "stored_bytes", "file_dedup_hits",
             "near_dup_hits")
_SUM_LIFECYCLE_KEYS = ("versions", "live_bytes", "superseded_bytes",
                       "reclaimed_bytes", "collected", "gc_runs",
                       "deleted_files", "compact_runs",
                       "compaction_reclaimed_bytes")


class StoreRouter:
    """Consistent-hash placement of repos over named ``ZLLMStore`` roots.

    ``stores`` is a mapping ``name -> ZLLMStore`` (ordered; names appear in
    stats and in ``?root=`` admin selectors), or a plain sequence of stores
    (auto-named ``r0``, ``r1``, ...). A single-store router is the identity
    — the server wraps every deployment in one so the two topologies share
    a code path.

    ``replicas`` is the copy count per repo (clamped to the root count);
    ``write_quorum`` the acks required before a fan-out write succeeds
    (default: a majority of the replicas).
    """

    # write-path retry policy: a transient root failure gets RETRY_ATTEMPTS
    # tries with exponential backoff; once the health tracker marks the root
    # suspect, later writes fail fast (one try) until the probe deadline
    RETRY_ATTEMPTS = 3
    RETRY_BASE_S = 0.05
    # suspect backoff: BACKOFF_BASE_S * 2^(fails-1), capped
    BACKOFF_BASE_S = 0.5
    BACKOFF_MAX_S = 30.0
    # a repo's read-repair is not rescheduled within this window of the
    # previous one finishing (a persistently-down replica would otherwise
    # enqueue one repair job per failover read)
    READ_REPAIR_COOLDOWN_S = 5.0
    # repair-pending backlog bound: entries expire after the TTL (a sweep
    # covers everything anyway) and the newest-first cap stops a
    # permanently-down replica from growing the set without limit
    REPAIR_PENDING_TTL_S = 3600.0
    REPAIR_PENDING_MAX = 4096

    def __init__(self, stores: Union[Dict[str, ZLLMStore],
                                     Sequence[ZLLMStore], ZLLMStore],
                 *, replicas: int = 1, write_quorum: Optional[int] = None):
        if isinstance(stores, ZLLMStore):
            stores = [stores]
        if not isinstance(stores, dict):
            stores = OrderedDict((f"r{i}", s) for i, s in enumerate(stores))
        if not stores:
            raise ValueError("StoreRouter needs at least one store")
        self.roots: "OrderedDict[str, ZLLMStore]" = OrderedDict(stores)
        self.replicas = max(1, min(int(replicas), len(self.roots)))
        if write_quorum is None:
            write_quorum = self.replicas // 2 + 1  # majority
        if not 1 <= write_quorum <= self.replicas:
            raise ValueError(f"write_quorum={write_quorum} out of range "
                             f"1..{self.replicas}")
        self.write_quorum = int(write_quorum)
        # repo -> root decisions for writes whose ingest job has not
        # registered in file_index yet: a second PUT for the same new repo
        # arriving inside that window must land on the SAME root(s), or the
        # repo splits across roots (severing its dedup/BitX chain).
        # Bounded; stale entries are harmless — membership wins once the
        # ingest lands, and a pending entry names those same roots anyway.
        self._pending_places: "OrderedDict[str, Tuple[str, ...]]" = OrderedDict()
        # health tracker + repos owed a repair pass (straggler writes,
        # failed deletes); anti_entropy() drains the pending set
        self._health: Dict[str, _RootHealth] = {n: _RootHealth()
                                                for n in self.roots}
        self._health_lock = threading.Lock()
        self._ae_lock = threading.Lock()  # one anti-entropy sweep at a time
        # repos owed a repair pass, with the monotonic stamp they were
        # queued at: TTL-expired and size-capped (REPAIR_PENDING_*) so a
        # permanently-down replica cannot grow the backlog forever
        self._repair_pending: "OrderedDict[str, float]" = OrderedDict()
        # read-repair bookkeeping: one in-flight repair per repo, plus a
        # completion stamp for the reschedule cooldown
        self._read_repair_inflight: Set[str] = set()
        self._read_repair_done: Dict[str, float] = {}
        self.read_repairs = 0  # repairs actually scheduled (stats)
        # replication counters (stats + the hinted-handoff "no full sweep"
        # assertion): sweeps run, hints recorded / drained
        self.anti_entropy_sweeps = 0
        self.hints_recorded = 0
        self.hints_drained = 0
        self._hint_drain_inflight = False
        # crash-injection hook (REPLICATION_FAULT_POINTS), mirroring
        # store.fault_hook; never set in production
        self.fault_hook = None
        # remote peers route their wire-protocol fault points (e.g.
        # peer.ship_mid_body) through this router's hook
        for s in self.roots.values():
            if self._is_peer(s) and getattr(s, "fault_hook", None) is None:
                s.fault_hook = self._fault

    def _fault(self, point: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook(point)

    # -- topology kinds ---------------------------------------------------
    @staticmethod
    def _is_peer(store) -> bool:
        """Remote :class:`repro_torch.serve.peer.PeerStore` roots mark themselves
        with ``is_peer`` — they take ships/adopts over the wire but have no
        local bytes, job workers, or hint log of their own."""
        return bool(getattr(store, "is_peer", False))

    def local_items(self) -> List[Tuple[str, ZLLMStore]]:
        return [(n, s) for n, s in self.roots.items() if not self._is_peer(s)]

    def peer_names(self) -> List[str]:
        return [n for n, s in self.roots.items() if self._is_peer(s)]

    def _first_local_up(self, prefer: Iterable[str] = ()) -> Optional[str]:
        """First healthy local root, preferring ``prefer`` order — the
        host for background jobs and the hint log."""
        for name in list(prefer) + [n for n, _ in self.local_items()]:
            store = self.roots.get(name)
            if store is not None and not self._is_peer(store) \
                    and self.is_up(name):
                return name
        return None

    # -- repair-pending backlog (TTL + cap) --------------------------------
    def _note_repair_pending(self, repo_id: str) -> None:
        with self._health_lock:
            self._repair_pending.pop(repo_id, None)
            self._repair_pending[repo_id] = time.monotonic()
            while len(self._repair_pending) > self.REPAIR_PENDING_MAX:
                self._repair_pending.popitem(last=False)  # oldest out

    def _pending_repairs(self) -> Set[str]:
        """Live (non-expired) repair-pending repos; prunes expired entries
        in place. Expiry is safe — the periodic full sweep covers every
        repo regardless; the backlog only prioritizes."""
        cutoff = time.monotonic() - self.REPAIR_PENDING_TTL_S
        with self._health_lock:
            expired = [r for r, ts in self._repair_pending.items()
                       if ts < cutoff]
            for r in expired:
                del self._repair_pending[r]
            return set(self._repair_pending)

    # -- health tracking --------------------------------------------------
    def set_root_down(self, name: str, down: bool = True) -> None:
        """Chaos/admin switch: a down root is hard-unreachable — reads skip
        it, writes fail against it (after the retry dance) and anti-entropy
        neither ships to nor from it until it is brought back up."""
        with self._health_lock:
            h = self._health[name]
            h.down = down
            if not down:
                h.fails = 0
                h.suspect_until = 0.0

    def is_up(self, name: str) -> bool:
        with self._health_lock:
            return not self._health[name].down

    def note_failure(self, name: str) -> None:
        """Organic failure (exception serving from the root): mark it
        suspect with an exponentially growing probe backoff."""
        with self._health_lock:
            h = self._health[name]
            h.fails += 1
            backoff = min(self.BACKOFF_BASE_S * (2 ** (h.fails - 1)),
                          self.BACKOFF_MAX_S)
            h.suspect_until = time.monotonic() + backoff

    def note_success(self, name: str) -> None:
        with self._health_lock:
            h = self._health[name]
            recovered = h.fails > 0
            h.fails = 0
            h.suspect_until = 0.0
        # organic recovery (the health probe just cleared a suspect root):
        # if this root is owed hinted handoffs, schedule their drain now —
        # targeted re-ship instead of waiting for a full sweep. Manual
        # set_root_down(False) deliberately does NOT trigger this: chaos
        # tests heal topology without implying the hints should move.
        if recovered and self._has_hints_for(name):
            self.schedule_hint_drain(peer=name)

    def _probe_ok(self, name: str) -> bool:
        """True when the root may be tried: up, and either healthy or past
        its suspect backoff (the next request doubles as the probe — on
        success ``note_success`` clears the suspicion, on failure
        ``note_failure`` re-suspends it with a longer backoff).

        The probe is CLAIMED single-flight: the first caller to observe an
        expired backoff re-arms ``suspect_until`` for the current backoff
        window before returning True, so concurrent callers keep treating
        the root as suspect (it stays a last-resort candidate) instead of
        all hammering the just-recovered root at once. The claimant's
        request resolves the probe either way — ``note_success`` clears
        the re-armed deadline, ``note_failure`` extends it."""
        with self._health_lock:
            h = self._health[name]
            if h.down:
                return False
            if h.fails == 0:
                return True
            if time.monotonic() < h.suspect_until:
                return False
            backoff = min(self.BACKOFF_BASE_S * (2 ** (h.fails - 1)),
                          self.BACKOFF_MAX_S)
            h.suspect_until = time.monotonic() + backoff
            return True

    def health(self) -> Dict[str, Dict]:
        """Per-root health snapshot (the ``/healthz`` + ``/stats`` field)."""
        out = {}
        with self._health_lock:
            now = time.monotonic()
            for name, h in self._health.items():
                state = ("down" if h.down
                         else "suspect" if now < h.suspect_until else "up")
                out[name] = {"state": state, "consecutive_failures": h.fails}
        return out

    # -- topology ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.roots)

    def names(self) -> List[str]:
        return list(self.roots)

    def items(self) -> Iterable[Tuple[str, ZLLMStore]]:
        return self.roots.items()

    def store(self, name: str) -> ZLLMStore:
        return self.roots[name]

    @property
    def single(self) -> Optional[ZLLMStore]:
        """The lone store of a single-root router, else None."""
        return next(iter(self.roots.values())) if len(self.roots) == 1 else None

    # -- placement ----------------------------------------------------------
    def place(self, repo_id: str) -> str:
        """Root name owning ``repo_id`` under rendezvous hashing: the root
        whose ``sha256(name | repo_id)`` scores highest. Deterministic,
        state-free, and minimally disruptive when roots are added."""
        return max(self.roots,
                   key=lambda n: hashlib.sha256(
                       f"{n}|{repo_id}".encode()).digest())

    def _membership_root(self, repo_id: str, filename: str) -> Optional[str]:
        """Root already holding ``repo_id`` — by exact key, by another
        file of the same repo (repo-cohesion: one repo, one root), or by
        an in-flight write decision whose ingest job has not registered
        yet. ``list()`` snapshots the keys under the GIL — the background
        ingest worker inserts into ``file_index`` concurrently, and
        iterating the live dict view would race it ("dictionary changed
        size during iteration")."""
        key = f"{repo_id}/{filename}"
        for name, store in self.roots.items():
            if key in store.file_index:  # atomic membership probe
                return name
        prefix = repo_id + "/"
        for name, store in self.roots.items():
            if any(k.startswith(prefix) for k in list(store.file_index)):
                return name
        pend = self._pending_places.get(repo_id)
        return pend[0] if pend else None

    def locate(self, repo_id: str, filename: str = "model.safetensors") -> str:
        """Root name *serving* ``repo_id/filename``: a root that already
        holds the repo (or has a write for it in flight) wins — pre-seeded
        stores, pre-resize placements, not-yet-registered ingest jobs;
        otherwise the hash placement. Reads and writes both route here, so
        re-registrations land beside the generations they supersede."""
        return self._membership_root(repo_id, filename) or self.place(repo_id)

    def store_for(self, repo_id: str,
                  filename: str = "model.safetensors") -> ZLLMStore:
        return self.roots[self.locate(repo_id, filename)]

    def locate_for_write(self, repo_id: str,
                         filename: str = "model.safetensors",
                         base: Optional[str] = None) -> str:
        """Placement for an incoming write. Like :meth:`locate`, but a NEW
        repo that declares a BitX base co-locates with the root serving
        that base — dedup and delta domains are per-root, so scattering a
        family across roots would store every fine-tune standalone. The
        decision is memoized in ``_pending_places`` so a second write for
        the same repo arriving before the first ingest job registers
        still routes to the same root."""
        root = self._membership_root(repo_id, filename)
        if root is None and base:
            bkey = f"{base}/model.safetensors"
            for name, store in self.roots.items():
                if bkey in store.file_index or base in store.base_paths:
                    root = name
                    break
        if root is None:
            root = self.place(repo_id)
        self._remember_places(repo_id, (root,))
        return root

    def _remember_places(self, repo_id: str, roots: Tuple[str, ...]) -> None:
        self._pending_places[repo_id] = roots
        while len(self._pending_places) > 1024:
            self._pending_places.popitem(last=False)

    # -- replica placement ------------------------------------------------
    def candidates(self, repo_id: str) -> List[str]:
        """Every root ordered by rendezvous score, best first — the natural
        replica candidate list (``place()`` is its head)."""
        return sorted(self.roots,
                      key=lambda n: hashlib.sha256(
                          f"{n}|{repo_id}".encode()).digest(),
                      reverse=True)

    def _holds_repo(self, name: str, repo_id: str) -> bool:
        prefix = repo_id + "/"
        return any(k.startswith(prefix)
                   for k in list(self.roots[name].file_index))

    def replica_roots(self, repo_id: str) -> List[str]:
        """The repo's replica group, membership-aware: roots already
        holding the repo come first (in candidate order — pre-seeded stores
        and pre-resize placements keep serving), padded with the best hash
        candidates up to ``replicas``. Never truncates an actual holder."""
        cands = self.candidates(repo_id)
        members = [n for n in cands if self._holds_repo(n, repo_id)]
        group = members + [n for n in cands if n not in members]
        return group[:max(self.replicas, len(members))]

    def read_candidates(self, repo_id: str,
                        filename: str = "model.safetensors") -> List[str]:
        """Replica roots in failover order for a read: probe-eligible roots
        first (healthy, or suspect past their backoff), then still-backed-off
        suspects as a last resort; manually-down roots are excluded — an
        empty list means every replica is down (the server answers 503)."""
        group = self.replica_roots(repo_id)
        up = [n for n in group if self.is_up(n)]
        ready = [n for n in up if self._probe_ok(n)]
        return ready + [n for n in up if n not in ready]

    @staticmethod
    def _state_rank(state: Tuple) -> Tuple:
        """Comparable strength of a ``_key_state`` tuple — the anti-entropy
        winner rule (container generations beat pinned refs beat gone), as
        a fixed-shape tuple so heterogeneous states still compare."""
        if state[0] == "gone":
            return (0, ())
        if state[0] == "container":
            return (2, state[1:])
        return (1, state[1:])

    def read_plan(self, repo_id: str,
                  filename: str = "model.safetensors") -> Tuple[List[str], bool]:
        """``(candidates, divergent)`` for one read. Candidates are
        :meth:`read_candidates` order with one refinement: within the
        probe-ready tier, roots whose index record for the key ranks
        strongest (same winner rule anti-entropy ships by) come first —
        a failover read never serves a weaker validator while a stronger
        replica is ready. ``divergent`` reports whether the up members of
        the group disagree on the key's state; the GET path uses it to
        schedule read-repair instead of waiting for a full sweep."""
        group = self.replica_roots(repo_id)
        up = [n for n in group if self.is_up(n)]
        key = f"{repo_id}/{filename}"
        states = {n: self._key_state(n, key) for n in up}
        divergent = len(set(states.values())) > 1
        ready = [n for n in up if self._probe_ok(n)]
        if divergent:
            ready.sort(key=lambda n: self._state_rank(states[n]),
                       reverse=True)  # stable: group order breaks ties
        return ready + [n for n in up if n not in ready], divergent

    def schedule_read_repair(self, repo_id: str,
                             note: str = "") -> Optional[str]:
        """Enqueue a scoped anti-entropy pass for one repo on a healthy
        root's background job worker — the GET path's repair trigger when
        a failover read succeeded somewhere other than the first replica,
        or :meth:`read_plan` saw divergent per-key state. Per-key diffs
        re-ship over the ``adopt_container`` path exactly as in a sweep,
        just without waiting for one. Deduped to one in-flight repair per
        repo with a post-completion cooldown; returns the job id, or
        ``None`` when deduped or no root is up."""
        now = time.monotonic()
        with self._health_lock:
            if repo_id in self._read_repair_inflight:
                return None
            if now - self._read_repair_done.get(repo_id, -1e9) \
                    < self.READ_REPAIR_COOLDOWN_S:
                return None
            self._read_repair_inflight.add(repo_id)
        healthy = self._first_local_up(prefer=self.replica_roots(repo_id))
        if healthy is None:
            with self._health_lock:
                self._read_repair_inflight.discard(repo_id)
            return None

        def run(rid=repo_id):
            try:
                return self.anti_entropy(repos=[rid])
            finally:
                with self._health_lock:
                    self._read_repair_inflight.discard(rid)
                    self._read_repair_done[rid] = time.monotonic()
                    while len(self._read_repair_done) > 1024:
                        self._read_repair_done.pop(
                            next(iter(self._read_repair_done)))

        try:
            jid = self.roots[healthy].enqueue_repair(
                run, note=note or f"read-repair: {repo_id}")
        except Exception:
            with self._health_lock:
                self._read_repair_inflight.discard(repo_id)
            raise
        self.read_repairs += 1
        return jid

    def write_roots(self, repo_id: str,
                    filename: str = "model.safetensors",
                    base: Optional[str] = None) -> List[str]:
        """Fan-out targets for an incoming write: the replica group, with a
        NEW repo that declares a BitX base co-locating with the base's
        group (dedup/delta domains are per-root — a fine-tune replica on a
        root without the base's containers would store standalone and the
        replicas would diverge). Memoized like :meth:`locate_for_write`."""
        pend = self._pending_places.get(repo_id)
        if pend:
            return list(pend)
        cands = self.candidates(repo_id)
        members = [n for n in cands if self._holds_repo(n, repo_id)]
        if not members and base:
            bgroup = [n for n in self.replica_roots(base)
                      if self._holds_repo(n, base)
                      or base in self.roots[n].base_paths]
            if bgroup:
                cands = bgroup + [n for n in cands if n not in bgroup]
        order = members + [n for n in cands if n not in members]
        targets = tuple(order[:max(self.replicas, len(members))])
        self._remember_places(repo_id, targets)
        return list(targets)

    # -- replicated writes ------------------------------------------------
    def replicated_enqueue(self, spool_path: str, repo_id: str,
                           filename: str,
                           base: Optional[str] = None) -> Dict:
        """Fan a spooled upload out to the repo's replica group: the bytes
        are staged into every target root's spool *first* (each root's
        ingest job owns — and eventually deletes or adopts — its own copy),
        then enqueued per root with retry + exponential backoff. Succeeds
        once ``write_quorum`` roots accepted the job; stragglers that never
        accepted get an asynchronous repair (a scoped anti-entropy pass on
        the first healthy root's job worker) so they converge once back up.
        Raises :class:`QuorumError` below quorum."""
        targets = self.write_roots(repo_id, filename, base)
        staged: Dict[str, str] = {}
        for name in targets:
            sdir = self.roots[name].spool_dir()
            if os.path.dirname(os.path.abspath(spool_path)) == \
                    os.path.abspath(sdir):
                staged[name] = spool_path
                continue
            dst = os.path.join(sdir, f"fanout-{os.getpid()}-"
                                     f"{os.path.basename(spool_path)}")
            with open(spool_path, "rb") as fin, open(dst, "wb") as fout:
                while True:
                    chunk = fin.read(1 << 20)
                    if not chunk:
                        break
                    fout.write(chunk)
            staged[name] = dst
        jobs: "OrderedDict[str, str]" = OrderedDict()
        failed: List[str] = []
        quorum_fired = False
        for i, name in enumerate(targets):
            if i == 1:
                self._fault("put.mid_fanout")
            if len(jobs) >= self.write_quorum and not quorum_fired:
                quorum_fired = True
                self._fault("put.post_quorum")
            jid = self._enqueue_with_retry(name, staged[name], repo_id,
                                           filename, base)
            if jid is None:
                failed.append(name)
            else:
                jobs[name] = jid
        if failed and jobs:
            # hinted handoff: each missed replica gets a durable per-peer
            # hint (key + the staged spool copy) on a healthy local root;
            # the drainer re-ships exactly these keys when the replica's
            # health probe recovers — no full sweep needed for a blip.
            # Recording falls back to the repair-pending backlog (next
            # sweep) when no local root can host the hint log.
            for name in failed:
                if self._record_hint(name, repo_id, filename,
                                     staged.get(name), base) is None:
                    self._note_repair_pending(repo_id)
            healthy = self._first_local_up(prefer=list(jobs))
            if healthy is not None:
                self.roots[healthy].enqueue_repair(
                    lambda rid=repo_id: self.anti_entropy(repos=[rid]),
                    note=f"straggler repair: {repo_id} missed "
                         f"{','.join(failed)}")
        elif failed:
            for name in failed:  # no quorum: the staged copies have no owner
                try:
                    os.remove(staged[name])
                except OSError:
                    pass
        if len(jobs) < self.write_quorum:
            raise QuorumError(
                f"write quorum not met for {repo_id}/{filename}: "
                f"{len(jobs)}/{self.write_quorum} of {len(targets)} replicas "
                f"accepted (failed: {', '.join(failed) or 'none'})")
        return {"jobs": dict(jobs), "targets": targets, "failed": failed,
                "quorum": self.write_quorum}

    def _enqueue_with_retry(self, name: str, path: str, repo_id: str,
                            filename: str,
                            base: Optional[str]) -> Optional[str]:
        """Enqueue one replica's ingest job. A root the health tracker
        already distrusts gets a single fast-fail attempt; otherwise the
        full retry + exponential backoff dance (a transiently down root
        that recovers mid-retry still takes the write)."""
        attempts = self.RETRY_ATTEMPTS if self._probe_ok(name) else 1
        store = self.roots[name]
        for i in range(attempts):
            try:
                if not self.is_up(name):
                    raise RootDownError(f"root {name} is down")
                jid = store.enqueue_ingest(
                    [(path, repo_id, filename, base)], cleanup=True)
            except Exception:
                if i + 1 < attempts:
                    time.sleep(self.RETRY_BASE_S * (2 ** i))
                continue
            self.note_success(name)
            return jid
        self.note_failure(name)
        return None

    def await_quorum(self, jobs: Dict[str, str],
                     timeout: float = 600.0) -> Tuple[bool, Dict[str, Dict]]:
        """Block until ``write_quorum`` of the given per-root jobs reached
        ``done`` (True) or enough failed/timed out that the quorum is
        unreachable (False). Returns the final per-root job status dicts."""
        need = min(self.write_quorum, len(jobs))
        deadline = time.monotonic() + timeout
        while True:
            states = {n: self.roots[n].ingest_job(j) for n, j in jobs.items()}
            done = sum(1 for s in states.values()
                       if s is not None and s["state"] == "done")
            dead = sum(1 for s in states.values()
                       if s is None or s["state"] == "failed")
            if done >= need:
                return True, states
            if len(jobs) - dead < need or time.monotonic() > deadline:
                return False, states
            time.sleep(0.02)

    # -- replicated delete ------------------------------------------------
    def delete(self, repo_id: str, filename: Optional[str] = None) -> Dict:
        """Delete a file (or a whole repo) on every replica in the group,
        persisting each root's index so the tombstones survive a restart.
        Idempotent — deleting what isn't there reports 0. Down roots are
        skipped and the repo is queued for anti-entropy (the tombstones on
        the surviving replicas propagate once the root returns)."""
        group = self.replica_roots(repo_id)
        counts: Dict[str, int] = {}
        failed: List[str] = []
        for name in group:
            if not self.is_up(name):
                failed.append(name)
                continue
            store = self.roots[name]
            try:
                if filename is not None:
                    n = int(store.delete_file(repo_id, filename))
                else:
                    n = store.delete_repo(repo_id)
                store.save_index()  # tombstone durability
                counts[name] = n
                self.note_success(name)
            except Exception:
                self.note_failure(name)
                failed.append(name)
        if failed:
            self._note_repair_pending(repo_id)
        return {"deleted": max(counts.values(), default=0),
                "roots": counts, "failed": failed}

    # -- hinted handoff ----------------------------------------------------
    # A quorum write below full fan-out owes the missed replica its bytes.
    # Rather than waiting for a full anti-entropy sweep, the router records
    # a durable per-peer hint (key + staged spool bytes) on a healthy local
    # root (``ZLLMStore.record_hint`` — fsync'd JSONL beside the index) and
    # re-ships exactly the hinted keys once the peer's health probe
    # recovers (``note_success`` after a suspect streak).

    def _record_hint(self, peer: str, repo_id: str, filename: str,
                     staged: Optional[str],
                     base: Optional[str]) -> Optional[str]:
        """Durably record one handoff hint; the staged fan-out copy moves
        into the hint host's spool so it survives until the drain. Returns
        ``None`` (caller falls back to the repair-pending backlog) when no
        local root can host the log."""
        host_name = self._first_local_up()
        if host_name is None:
            if staged:
                try:
                    os.remove(staged)
                except OSError:
                    pass
            return None
        host = self.roots[host_name]
        ref: Optional[str] = None
        if staged and os.path.exists(staged):
            ref = os.path.join(host.spool_dir(),
                               f"hint-{os.getpid()}-"
                               f"{os.path.basename(staged)}")
            if os.path.abspath(ref) == os.path.abspath(staged):
                ref = staged
            else:
                try:
                    os.replace(staged, ref)
                except OSError:
                    try:  # cross-filesystem staging (a peer's tempdir)
                        with open(staged, "rb") as fin, \
                                open(ref, "wb") as fout:
                            while True:
                                chunk = fin.read(1 << 20)
                                if not chunk:
                                    break
                                fout.write(chunk)
                        os.remove(staged)
                    except OSError:
                        ref = None
        hid = host.record_hint(peer, repo_id, filename, ref, base=base)
        self.hints_recorded += 1
        return hid

    def _has_hints_for(self, peer: str) -> bool:
        for _, host in self.local_items():
            try:
                if host.pending_hints(peer):
                    return True
            except Exception:
                continue
        return False

    def pending_hint_count(self, peer: Optional[str] = None) -> int:
        return sum(len(host.pending_hints(peer))
                   for _, host in self.local_items())

    def _peer_alive(self, name: str) -> bool:
        """Is the replica actually reachable right now? Local roots are
        alive when up; a remote peer gets a real ``/healthz`` probe —
        draining hints into a half-recovered peer would just re-fail."""
        if not self.is_up(name):
            return False
        store = self.roots[name]
        if self._is_peer(store):
            return bool(store.probe())
        return True

    def schedule_hint_drain(self, peer: Optional[str] = None,
                            note: str = "") -> Optional[str]:
        """Run :meth:`drain_hints` on a healthy local root's background
        job worker (single-flight — recovery storms collapse into one
        drain). Returns the job id, or ``None`` when deduped or no local
        root is up."""
        with self._health_lock:
            if self._hint_drain_inflight:
                return None
            self._hint_drain_inflight = True
        host_name = self._first_local_up()
        if host_name is None:
            with self._health_lock:
                self._hint_drain_inflight = False
            return None

        def run(p=peer):
            try:
                return self.drain_hints(peer=p)
            finally:
                with self._health_lock:
                    self._hint_drain_inflight = False

        try:
            return self.roots[host_name].enqueue_repair(
                run, note=note or f"hint drain: {peer or 'all peers'}")
        except Exception:
            with self._health_lock:
                self._hint_drain_inflight = False
            raise

    def drain_hints(self, peer: Optional[str] = None) -> Dict:
        """Re-ship every recorded hint (optionally one peer's) whose
        target is reachable: exactly the hinted keys move — by closure
        ship from the strongest live source, falling back to re-ingesting
        the staged spool bytes — and drained hints leave the log
        atomically. Unreachable targets keep their hints for the next
        recovery. This is the targeted alternative to a full sweep: it
        never diffs, never touches unhinted keys, and does not bump
        ``anti_entropy_sweeps``."""
        report = {"drained": 0, "kept": 0, "requeued": 0,
                  "shipped_versions": 0, "shipped_bytes": 0,
                  "records_updated": 0, "errors": []}
        alive: Dict[str, bool] = {}
        for host_name, host in self.local_items():
            hints = host.pending_hints(peer)
            if not hints:
                continue
            done: List[str] = []
            for h in hints:
                tgt = h.get("peer")
                if tgt not in self.roots:
                    done.append(h["id"])  # replica left the topology
                    continue
                if tgt not in alive:
                    alive[tgt] = self._peer_alive(tgt)
                if not alive[tgt]:
                    report["kept"] += 1
                    continue
                try:
                    ok = self._drain_one_hint(h, report)
                except Exception as e:
                    report["errors"].append(
                        f"hint {h.get('id')} -> {tgt}: "
                        f"{type(e).__name__}: {e}")
                    report["kept"] += 1
                    alive[tgt] = self._peer_alive(tgt)  # it may have died
                    continue
                if ok:
                    done.append(h["id"])
                else:
                    report["kept"] += 1
            if done:
                # crash window under test: the re-ship landed but the log
                # has not dropped the hint — recovery re-drains; shipping
                # is idempotent, so the replay converges to the same state
                self._fault("hint.pre_drain_persist")
                dropped = host.drop_hints(done)
                self.hints_drained += dropped
                report["drained"] += dropped
        return report

    def _drain_one_hint(self, h: Dict, report: Dict) -> bool:
        """Converge one hinted key on its target. True == the debt is
        settled (shipped, already converged, deletion won, or re-queued
        into the target's own ingest) and the hint may drop."""
        tgt = h["peer"]
        repo_id, filename = h["repo_id"], h["filename"]
        key = f"{repo_id}/{filename}"
        t_store = self.roots[tgt]
        if self._is_peer(t_store):
            t_store.refresh_snapshot()
        tgt_state = self._key_state(tgt, key)
        sources = {}
        for n, s in self.local_items():
            if n != tgt and self.is_up(n):
                st = self._key_state(n, key)
                if st[0] != "gone":
                    sources[n] = st
        if sources:
            src = max(sources, key=lambda n: self._state_rank(sources[n]))
            if sources[src] == tgt_state:
                return True  # a sweep or earlier drain got there first
            src_rec = self.roots[src].file_index.get(key)
            if src_rec is None:
                return False
            if tgt_state[0] == "gone" and self._tombstone_wins(
                    t_store, key, src_rec):
                return True  # the write was deleted meanwhile: debt void
            self._ship_key(src, tgt, key, src_rec, report)
            return True
        # no live local source. A local tombstone means the hinted write
        # was deleted meanwhile — re-ingesting the staged bytes would
        # mint a generation ABOVE the marker's and resurrect the key on
        # the next sweep, so the debt is void instead.
        for n, s in self.local_items():
            if self.is_up(n) and key in s.lifecycle.tombstones:
                return True
        # otherwise the local job is likely still in flight: if the
        # staged bytes survive, hand them to the target's own ingest
        # pipeline; failing that keep the hint for the next pass
        ref = h.get("spool_ref")
        if ref and os.path.exists(ref):
            dst = os.path.join(t_store.spool_dir(),
                               f"hintship-{os.path.basename(ref)}")
            with open(ref, "rb") as fin, open(dst, "wb") as fout:
                while True:
                    chunk = fin.read(1 << 20)
                    if not chunk:
                        break
                    fout.write(chunk)
            t_store.enqueue_ingest(
                [(dst, repo_id, filename, h.get("base"))], cleanup=True)
            report["requeued"] += 1
            return True
        return False

    # -- anti-entropy -----------------------------------------------------
    def _all_repos(self) -> Set[str]:
        repos: Set[str] = set()
        for store in self.roots.values():
            for k in list(store.file_index):
                repos.add(k.rsplit("/", 1)[0])
            for k in list(store.lifecycle.tombstones):
                repos.add(k.rsplit("/", 1)[0])
        return repos

    def anti_entropy(self, repos: Optional[Sequence[str]] = None,
                     ) -> Dict:
        """One repair sweep over every replica group (or just ``repos``):

        1. **Tombstones** — delete markers are unioned across the group and
           applied everywhere, so no replica resurrects a deleted repo (a
           record whose generation exceeds the marker's survives: that is a
           legitimate re-upload, generations being monotonic per key).
        2. **Quarantine-restore** — a quarantined container with a healthy
           same-``(key, gen)`` copy on another replica is re-fetched,
           sha256-verified and swapped back in.
        3. **Re-ship** — per key, the best record (highest container
           generation) wins; replicas missing it receive the pinned
           generation's full dependency closure as verbatim container
           bytes, then the index record itself.

        Touched roots persist their index and take a light structural
        ``fsck`` at the end. Sweeps serialize on a router-level lock."""
        with self._ae_lock:
            self.anti_entropy_sweeps += 1
            report = {"repos": 0, "tombstones_applied": 0, "restored": 0,
                      "shipped_versions": 0, "shipped_bytes": 0,
                      "records_updated": 0, "skipped_roots": [],
                      "errors": []}
            pending = self._pending_repairs()
            todo = sorted(set(repos) if repos is not None
                          else self._all_repos() | pending)
            for repo in todo:
                try:
                    self._anti_entropy_repo(repo, report)
                except Exception as e:  # keep sweeping other groups
                    report["errors"].append(f"{repo}: {type(e).__name__}: {e}")
                report["repos"] += 1
            with self._health_lock:
                for repo in todo:
                    self._repair_pending.pop(repo, None)
            touched = report.pop("_touched", set())
            for name in touched:
                store = self.roots[name]
                try:  # a peer may die between its adopt and this persist
                    store.save_index()
                    rep = store.fsck(repair=True, spot_check=0)
                except Exception as e:
                    self.note_failure(name)
                    report["errors"].append(
                        f"post-repair persist on {name}: "
                        f"{type(e).__name__}: {e}")
                    continue
                if not rep.ok:
                    report["errors"].append(
                        f"post-repair fsck on {name}: "
                        f"{rep.summary()}")
            report["touched_roots"] = sorted(touched)
            return report

    def _anti_entropy_repo(self, repo_id: str, report: Dict) -> None:
        group = self.replica_roots(repo_id)
        up = [n for n in group if self.is_up(n)]
        # remote peers must be diffed against LIVE state, not a cached
        # snapshot: refresh over the wire, and treat an unreachable peer
        # exactly like a down root (skip; it converges once back)
        live = []
        for n in up:
            store = self.roots[n]
            if self._is_peer(store):
                try:
                    store.refresh_snapshot()
                except Exception:
                    self.note_failure(n)
                    continue
            live.append(n)
        up = live
        skipped = [n for n in group if n not in up]
        for n in skipped:
            if n not in report["skipped_roots"]:
                report["skipped_roots"].append(n)
        if not up:
            return
        touched: Set[str] = report.setdefault("_touched", set())
        prefix = repo_id + "/"

        # 1. union + apply tombstones
        tombs: Dict[str, Tuple[int, float]] = {}
        for n in up:
            for k, (g, ts) in list(
                    self.roots[n].lifecycle.tombstones.items()):
                if not k.startswith(prefix):
                    continue
                old = tombs.get(k)
                if old is None or g > old[0]:
                    tombs[k] = (g, ts)
        for k, (g, ts) in tombs.items():
            for n in up:
                if self.roots[n].apply_tombstone(k, g, ts):
                    report["tombstones_applied"] += 1
                    touched.add(n)

        # 2. quarantine-restore from healthy same-generation copies
        for n in up:
            store = self.roots[n]
            for v in [v for v in list(store.lifecycle.versions.values())
                      if v.quarantined and v.key.startswith(prefix)]:
                for donor in up:
                    if donor == n:
                        continue
                    dstore = self.roots[donor]
                    if not dstore.lifecycle.exists(v.key, v.gen):
                        continue
                    digest = dstore.container_digest(v.key, v.gen)
                    staged = self._stage_version(
                        dstore, v.key, v.gen, store.spool_dir(),
                        f"restore-{v.vid.replace('/', '__')}")
                    self._fault("restore.mid_copy")
                    if store.restore_version(v.key, v.gen, staged,
                                             expected_sha256=digest):
                        report["restored"] += 1
                        touched.add(n)
                    break

        # 3. diff per-key states, ship the winner's closure verbatim
        keys: Set[str] = set()
        for n in up:
            keys.update(k for k in list(self.roots[n].file_index)
                        if k.startswith(prefix))
        for key in sorted(keys):
            states = {n: self._key_state(n, key) for n in up}
            live = {n: s for n, s in states.items() if s[0] != "gone"}
            if not live or len(set(live.values())) == 1 and len(live) == len(up):
                continue
            src = max(live, key=lambda n: (live[n][0] == "container",
                                           live[n][1:]))
            src_rec = self.roots[src].file_index.get(key)
            if src_rec is None:
                continue
            for tgt in up:
                if tgt == src or states.get(tgt) == states[src]:
                    continue
                if states[tgt][0] == "gone" and self._tombstone_wins(
                        self.roots[tgt], key, src_rec):
                    continue  # deletion wins over the source's record
                try:
                    self._ship_key(src, tgt, key, src_rec, report)
                    touched.add(tgt)
                except Exception as e:
                    report["errors"].append(
                        f"ship {key} {src}->{tgt}: {type(e).__name__}: {e}")

    @staticmethod
    def _tombstone_wins(store: ZLLMStore, key: str, src_rec: Dict) -> bool:
        """Does ``store``'s delete marker for ``key`` cover the source
        replica's record? Containers compare monotonic generations; ref
        records (no generation of their own) resolve last-writer-wins on
        the record's write stamp — mirrors ``apply_tombstone``."""
        tomb = store.lifecycle.tombstone_for(key)
        if tomb is None:
            return False
        gen, ts = tomb
        if src_rec.get("kind") == "container":
            return int(src_rec.get("gen", 0)) <= gen
        return float(src_rec.get("mtime", 0.0)) <= ts

    def _key_state(self, name: str, key: str) -> Tuple:
        """Comparable per-root state of one index key: what generation (or
        pinned ref) the root serves, or ``gone`` (deleted / never seen —
        indistinguishable on purpose: neither serves bytes)."""
        rec = self.roots[name].file_index.get(key)
        if rec is None:
            return ("gone",)
        if rec.get("kind") == "container":
            return ("container", int(rec.get("gen", 0)))
        return (rec["kind"], rec.get("ref", ""), int(rec.get("ref_gen", 0)),
                rec.get("file_hash", ""))

    def _stage_version(self, src_store, key: str, gen: int, dst_dir: str,
                       name: str) -> str:
        """Materialize one container version's verbatim bytes as a local
        file in ``dst_dir``: a local source is copied, a remote peer's is
        fetched over the wire (resumable, sha256-verified)."""
        if self._is_peer(src_store):
            return src_store.fetch_container(key, gen, dst_dir)
        src_path = src_store.lifecycle.version_path(key, gen)
        staged = os.path.join(dst_dir, name)
        with open(src_path, "rb") as fin, open(staged, "wb") as fout:
            while True:
                chunk = fin.read(1 << 20)
                if not chunk:
                    break
                fout.write(chunk)
        return staged

    def _ship_key(self, src: str, tgt: str, key: str, rec: Dict,
                  report: Dict) -> None:
        """Re-ship one key from ``src`` to ``tgt``: the pinned generation's
        dependency closure as verbatim container bytes (dependencies first,
        adoption is idempotent), then the index record. Either side may be
        a remote peer — a local source ships its container file directly, a
        peer source is first staged locally; ``adopt_container`` is the
        polymorphic seam (in-process temp+rename vs. resumable upload)."""
        s_store, t_store = self.roots[src], self.roots[tgt]
        if rec.get("kind") == "container":
            anchor = make_vid(key, int(rec.get("gen", 0)))
        else:
            anchor = make_vid(rec["ref"], int(rec.get("ref_gen", 0)))
        for vid in self._closure_postorder(s_store, anchor):
            v = s_store.lifecycle.versions.get(vid)
            if v is None or v.quarantined:
                continue  # another replica may donate it later
            vkey, _, vgen = vid.rpartition("@g")
            vgen = int(vgen)
            if t_store.lifecycle.get(vkey, vgen) is not None:
                continue
            digest = s_store.container_digest(vkey, vgen)
            if self._is_peer(s_store):
                src_path = self._stage_version(
                    s_store, vkey, vgen, t_store.spool_dir(),
                    f"ship-{vid.replace('/', '__')}")
                cleanup = True
            else:
                src_path, cleanup = v.path, False
            self._fault("anti_entropy.mid_copy")
            try:
                if t_store.adopt_container(vkey, vgen, src_path,
                                           expected_sha256=digest):
                    report["shipped_versions"] += 1
                    report["shipped_bytes"] += v.nbytes
            finally:
                if cleanup:
                    try:
                        os.remove(src_path)
                    except OSError:
                        pass
        t_store.adopt_index_record(key, rec)
        report["records_updated"] += 1

    @staticmethod
    def _closure_postorder(store: ZLLMStore, anchor: str) -> List[str]:
        """Dependency-first (postorder) walk of the version graph from
        ``anchor``: a shipped container's edges must resolve on the target,
        so its targets land before it does."""
        out: List[str] = []
        seen: Set[str] = set()
        stack: List[Tuple[str, bool]] = [(anchor, False)]
        while stack:
            vid, expanded = stack.pop()
            if expanded:
                out.append(vid)
                continue
            if vid in seen or vid not in store.lifecycle.versions:
                continue
            seen.add(vid)
            stack.append((vid, True))
            for dst in store.lifecycle.edges.get(vid, ()):
                if dst not in seen:
                    stack.append((dst, False))
        return out

    def replica_index_diff(self, repos: Optional[Sequence[str]] = None,
                           ) -> Dict[str, Dict[str, Dict[str, List]]]:
        """Per-replica-group index disagreements among up roots: empty dict
        == every group converged (the smoke/soak convergence assertion).
        Keys map to per-root states (``["container", gen]`` / ref tuples /
        ``["gone"]``); only keys with >1 distinct state appear."""
        out: Dict[str, Dict[str, Dict[str, List]]] = {}
        todo = sorted(set(repos) if repos is not None else self._all_repos())
        for repo in todo:
            up = [n for n in self.replica_roots(repo) if self.is_up(n)]
            prefix = repo + "/"
            keys: Set[str] = set()
            for n in up:
                keys.update(k for k in list(self.roots[n].file_index)
                            if k.startswith(prefix))
                keys.update(k for k in list(
                    self.roots[n].lifecycle.tombstones) if k.startswith(prefix))
            rdiff: Dict[str, Dict[str, List]] = {}
            for key in sorted(keys):
                states = {n: self._key_state(n, key) for n in up}
                if len(set(states.values())) > 1:
                    rdiff[key] = {n: list(s) for n, s in states.items()}
            if rdiff:
                out[repo] = rdiff
        return out

    # -- aggregate stats ------------------------------------------------------
    def summary(self) -> Dict:
        """Aggregated ``store.summary()``. Single root: the flat summary,
        unchanged (back-compat for ``server_smoke`` and /stats consumers).
        N roots: summable counters aggregated at the top plus the full
        per-root summaries under ``roots``."""
        single = self.single
        if single is not None:
            return single.summary()
        per_root = {name: store.summary() for name, store in self.roots.items()}
        agg: Dict = {k: sum(s[k] for s in per_root.values()) for k in _SUM_KEYS}
        agg["reduction_ratio"] = round(
            1.0 - agg["stored_bytes"] / agg["raw_bytes"], 4
        ) if agg["raw_bytes"] else 0.0
        agg["lifecycle"] = {k: sum(s["lifecycle"][k] for s in per_root.values())
                            for k in _SUM_LIFECYCLE_KEYS}
        agg["lifecycle"]["gc_max_pause_ms"] = max(
            s["lifecycle"]["gc_max_pause_ms"] for s in per_root.values())
        agg["read_gen"] = {name: s["read_gen"] for name, s in per_root.items()}
        agg["n_roots"] = len(per_root)
        agg["roots"] = per_root
        with self._health_lock:
            pending = len(self._repair_pending)
        agg["replication"] = {"replicas": self.replicas,
                              "write_quorum": self.write_quorum,
                              "health": self.health(),
                              "repair_pending": pending,
                              "read_repairs": self.read_repairs,
                              "anti_entropy_sweeps": self.anti_entropy_sweeps,
                              "hints_recorded": self.hints_recorded,
                              "hints_drained": self.hints_drained,
                              "hints_pending": self.pending_hint_count(),
                              "peers": self.peer_names()}
        return agg

    def ingest_jobs(self, limit: int = 64) -> List[Dict]:
        """Recent spooled-ingest jobs across every root (each row carries
        its ``root``), newest first."""
        rows: List[Dict] = []
        for name, store in self.roots.items():
            for j in store.ingest_jobs(limit):
                j["root"] = name
                rows.append(j)
        rows.sort(key=lambda j: j["enqueued_at"], reverse=True)
        return rows[:limit]

    def ingest_job(self, job_id: str) -> Optional[Dict]:
        """Look a job id up across roots (ids are store-local)."""
        for name, store in self.roots.items():
            j = store.ingest_job(job_id)
            if j is not None:
                j["root"] = name
                return j
        return None

    # -- admin fan-out ------------------------------------------------------
    def _selected(self, root: Optional[str]) -> List[Tuple[str, ZLLMStore]]:
        if root is None:
            return list(self.roots.items())
        if root not in self.roots:
            raise KeyError(f"unknown root {root!r} "
                           f"(have: {', '.join(self.roots)})")
        return [(root, self.roots[root])]

    def fanout_gc(self, root: Optional[str] = None, *, incremental: bool = False,
                  max_pause_ms: float = 50.0) -> Dict:
        reports = {name: store.gc(incremental=incremental,
                                  max_pause_ms=max_pause_ms)
                   for name, store in self._selected(root)}
        return self._flat_or_nested(reports, ("collected", "reclaimed_bytes"))

    def fanout_compact(self, root: Optional[str] = None) -> Dict:
        reports = {name: store.compact()
                   for name, store in self._selected(root)}
        return self._flat_or_nested(
            reports, ("retired_versions", "moved_records",
                      "net_reclaimed_bytes"))

    def fanout_fsck(self, root: Optional[str] = None, *, repair: bool = False,
                    spot_check: Optional[int] = 4) -> Dict:
        reports = {}
        for name, store in self._selected(root):
            rep = store.fsck(repair=repair, spot_check=spot_check)
            reports[name] = {"ok": rep.ok, "summary": rep.summary(),
                             "orphans": len(rep.orphans),
                             "quarantined": len(rep.quarantined)}
        if len(reports) == 1 and len(self.roots) == 1:
            return next(iter(reports.values()))
        out = {"roots": reports, "ok": all(r["ok"] for r in reports.values())}
        return out

    def _flat_or_nested(self, reports: Dict[str, Dict],
                        sum_keys: Tuple[str, ...]) -> Dict:
        """One root selected on a single-root router → the flat report
        (back-compat); otherwise per-root reports plus summed headline
        numbers."""
        if len(reports) == 1 and len(self.roots) == 1:
            return next(iter(reports.values()))
        out: Dict = {k: sum(r.get(k, 0) for r in reports.values())
                     for k in sum_keys}
        out["roots"] = reports
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Close every store exactly once (dict values may repeat when the
        same store is mounted under two names)."""
        for store in {id(s): s for s in self.roots.values()}.values():
            store.close()

    @staticmethod
    def open_roots(paths: Sequence[str], *, workers: int = 2,
                   replicas: int = 1,
                   write_quorum: Optional[int] = None,
                   peers: Sequence[str] = ()) -> "StoreRouter":
        """CLI helper: open one store per path (index loaded when present),
        named ``r0..rN`` with the path recorded for display. ``peers`` are
        remote replica URLs, mounted as ``p0..pN``
        :class:`repro_torch.serve.peer.PeerStore` roots behind the same
        interface — replica groups may then span server processes."""
        stores: "OrderedDict[str, ZLLMStore]" = OrderedDict()
        for i, path in enumerate(paths):
            store = ZLLMStore(path, workers=workers)
            store.load_index()
            stores[f"r{i}"] = store
        if peers:
            from repro_torch.serve.peer import PeerStore
            for i, url in enumerate(peers):
                stores[f"p{i}"] = PeerStore(url)
        router = StoreRouter(stores, replicas=replicas,
                             write_quorum=write_quorum)
        # wire-protocol fault points fire through the router's hook
        for s in stores.values():
            if getattr(s, "is_peer", False):
                s.fault_hook = router._fault
        return router
