"""The port's counterpart of tests/test_replication.py: the same cases against
``repro_torch``, every store on ``TorchBackend(device="cpu")`` (the plain
versions of the kernels).

Fault-injection + convergence suite for the replicated tier.

Mirrors ``test_crash_recovery.py``: the replication story is *ordering +
idempotence*, not handlers. Spool copies are staged before any enqueue,
containers ship temp-suffix + atomic-rename and are sha256-verified
against the donor, tombstones merge commutatively, and every repair
primitive (adopt / restore / apply_tombstone) is idempotent — so killing
the router at ANY declared fault point leaves a cluster that one
``anti_entropy()`` sweep returns to full convergence with zero
live-tensor loss. This suite kills at each point in
``REPLICATION_FAULT_POINTS``, reopens every root from disk like a
restarted node, and proves exactly that.
"""

import http.client
import os
import struct
import threading
import time
from collections import OrderedDict

import numpy as np
import pytest

from repro_torch.core.lifecycle import make_vid
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import AutoCompactPolicy, ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.serve.router import (REPLICATION_FAULT_POINTS, QuorumError,
                                StoreRouter)
from repro_torch.serve.store_server import ServerThread

N_ROOTS = 3
FNAME = "model.safetensors"


def _write_model(path, seed, n_tensors=3, n=1024):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tensors = {f"t{i}": (rng.randn(n) * 0.02).astype(np.float32)
               for i in range(n_tensors)}
    st.save_file(tensors, path)
    with open(path, "rb") as f:
        return f.read()


def _corrupt_payload(cpath):
    """Flip bytes in the middle of the frame payload (header left intact)."""
    with open(cpath, "rb") as f:
        blob = bytearray(f.read())
    (hlen,) = struct.unpack("<Q", bytes(blob[8:16]))
    mid = 16 + hlen + (len(blob) - 16 - hlen) // 2
    for i in range(mid, min(mid + 8, len(blob))):
        blob[i] ^= 0xFF
    with open(cpath, "wb") as f:
        f.write(bytes(blob))


def _cluster(root, *, replicas=N_ROOTS, write_quorum=2, load=False):
    stores = OrderedDict()
    for i in range(N_ROOTS):
        s = ZLLMStore(os.path.join(root, f"r{i}"), workers=1, backend=TorchBackend(device="cpu"))
        if load:
            s.load_index()
        stores[f"r{i}"] = s
    return StoreRouter(stores, replicas=replicas, write_quorum=write_quorum)


def _wait_jobs(router, jobs, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        states = {n: router.roots[n].ingest_job(j) for n, j in jobs.items()}
        if all(s is not None and s["state"] in ("done", "failed")
               for s in states.values()):
            return states
        time.sleep(0.02)
    raise TimeoutError(f"jobs never settled: {states}")


def _drain_workers(router, timeout=60.0):
    """Let every queued job (including async repair jobs) finish."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pending = [j for s in router.roots.values()
                   for j in s.ingest_jobs(256)
                   if j["state"] in ("queued", "running")]
        if not pending:
            return
        time.sleep(0.02)
    raise TimeoutError("job workers never drained")


def _put(router, tmp, repo_id, seed):
    src = os.path.join(tmp, "up", repo_id.replace("/", "_"), FNAME)
    blob = _write_model(src, seed)
    rep = router.replicated_enqueue(src, repo_id, FNAME)
    _wait_jobs(router, rep["jobs"])
    return blob, rep


def _assert_converged(router, oracle):
    """Convergence = empty replica diffs, clean fsck on every root, and
    every live file byte-identical to the oracle on every up replica."""
    assert router.replica_index_diff() == {}
    for name, store in router.roots.items():
        if not router.is_up(name):
            continue
        rep = store.fsck(repair=False, spot_check=None)
        assert rep.ok, (name, rep.dangling, rep.corrupt)
    for repo_id, blob in oracle.items():
        for name in router.replica_roots(repo_id):
            if not router.is_up(name):
                continue
            assert router.roots[name].retrieve_file(repo_id, FNAME) == blob, \
                f"live tensor data lost for {repo_id} on {name}"


class _Kill(BaseException):
    """BaseException so no except-Exception handler on the way out can
    soften the simulated crash."""


# ---------------------------------------------------------------------------
# happy path: quorum writes fan out bit-identically
# ---------------------------------------------------------------------------

def test_replicated_write_is_byte_identical_everywhere(tmp_path):
    router = _cluster(str(tmp_path))
    try:
        blob, rep = _put(router, str(tmp_path), "org/a", seed=1)
        assert sorted(rep["jobs"]) == ["r0", "r1", "r2"]
        for name in router.roots:
            assert router.roots[name].retrieve_file("org/a", FNAME) == blob
        # container-level identity, not just decoded-bytes identity
        key = f"org/a/{FNAME}"
        gen = router.roots["r0"].file_index[key]["gen"]
        digests = {s.container_digest(key, gen)
                   for s in router.roots.values()}
        assert len(digests) == 1
        _assert_converged(router, {"org/a": blob})
    finally:
        router.close()


def test_write_quorum_respected_and_503_below_it(tmp_path):
    router = _cluster(str(tmp_path))
    try:
        victim = router.replica_roots("org/q")[0]
        router.set_root_down(victim)
        blob, rep = _put(router, str(tmp_path), "org/q", seed=2)
        assert victim in rep["failed"] and len(rep["jobs"]) == 2
        ok, _ = router.await_quorum(rep["jobs"])
        assert ok
        # two roots down -> W=2 unreachable -> QuorumError
        survivors = [n for n in router.roots if n != victim]
        router.set_root_down(survivors[0])
        src = os.path.join(str(tmp_path), "up2", FNAME)
        _write_model(src, 3)
        with pytest.raises(QuorumError):
            router.replicated_enqueue(src, "org/q2", FNAME)
    finally:
        router.close()


def test_restarted_root_converges_via_anti_entropy(tmp_path):
    """Acceptance demo: write at W=2 with one root down, 'restart' the
    root (reopen all stores from disk), one sweep converges it."""
    tmp = str(tmp_path)
    router = _cluster(tmp)
    victim = router.replica_roots("org/m")[0]
    router.set_root_down(victim)
    blob, _ = _put(router, tmp, "org/m", seed=4)
    _drain_workers(router)
    router.close()

    router = _cluster(tmp, load=True)  # every node restarts
    try:
        assert f"org/m/{FNAME}" not in router.roots[victim].file_index
        rep = router.anti_entropy()
        assert rep["shipped_versions"] >= 1 and not rep["errors"]
        _assert_converged(router, {"org/m": blob})
        assert router.roots[victim].retrieve_file("org/m", FNAME) == blob
    finally:
        router.close()


# ---------------------------------------------------------------------------
# read failover
# ---------------------------------------------------------------------------

def test_read_candidates_exclude_down_roots_and_recover(tmp_path):
    router = _cluster(str(tmp_path))
    try:
        blob, _ = _put(router, str(tmp_path), "org/r", seed=5)
        cands = router.read_candidates("org/r", FNAME)
        assert len(cands) == N_ROOTS
        router.set_root_down(cands[0])
        after = router.read_candidates("org/r", FNAME)
        assert cands[0] not in after and len(after) == N_ROOTS - 1
        assert router.roots[after[0]].retrieve_file("org/r", FNAME) == blob
        # suspect backoff: repeated failures push a root to the back
        for _ in range(3):
            router.note_failure(after[0])
        assert router.health()[after[0]]["state"] == "suspect"
        assert router.read_candidates("org/r", FNAME)[-1] == after[0]
        router.note_success(after[0])
        assert router.health()[after[0]]["state"] == "up"
        router.set_root_down(cands[0], down=False)
        assert router.health()[cands[0]]["state"] == "up"
    finally:
        router.close()


# ---------------------------------------------------------------------------
# kill at every declared fault point; reopen; one sweep heals
# ---------------------------------------------------------------------------

def _arm(router, point, fired):
    def hook(p):
        if p == point:
            fired.append(p)
            raise _Kill(p)
    router.fault_hook = hook


def _reopen_and_heal(tmp, oracle):
    router = _cluster(tmp, load=True)
    try:
        router.anti_entropy()
        _assert_converged(router, oracle)
    finally:
        router.close()


@pytest.mark.parametrize("point", [p for p in REPLICATION_FAULT_POINTS
                                   if p.startswith("put.")])
def test_put_killed_at_fault_point_then_heals(point, tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    blob0, _ = _put(router, tmp, "org/base", seed=10)  # pre-existing state
    src = os.path.join(tmp, "up", FNAME)
    blob = _write_model(src, 11)
    fired = []
    _arm(router, point, fired)
    with pytest.raises(_Kill):
        router.replicated_enqueue(src, "org/x", FNAME)
    assert fired == [point]
    router.fault_hook = None
    _drain_workers(router)  # jobs already accepted before the kill finish
    router.close()

    # reopen every node; the sweep must either complete the write on every
    # replica (some root accepted it) or leave a still-converged cluster
    router = _cluster(tmp, load=True)
    try:
        router.anti_entropy()
        holders = [n for n in router.roots
                   if f"org/x/{FNAME}" in router.roots[n].file_index]
        assert holders in ([], sorted(router.roots)), \
            f"partial replication survived the sweep: {holders}"
        oracle = {"org/base": blob0}
        if holders:
            oracle["org/x"] = blob
        _assert_converged(router, oracle)
    finally:
        router.close()


def test_anti_entropy_killed_mid_copy_then_heals(tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    victim = router.replica_roots("org/ae")[0]
    router.set_root_down(victim)
    blob, _ = _put(router, tmp, "org/ae", seed=12)
    _drain_workers(router)
    router.set_root_down(victim, down=False)
    fired = []
    _arm(router, "anti_entropy.mid_copy", fired)
    with pytest.raises(_Kill):
        router.anti_entropy()
    assert fired == ["anti_entropy.mid_copy"]
    router.close()
    _reopen_and_heal(tmp, {"org/ae": blob})


def test_restore_killed_mid_copy_then_heals(tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    blob, _ = _put(router, tmp, "org/qr", seed=13)
    key = f"org/qr/{FNAME}"
    victim = router.replica_roots("org/qr")[0]
    store = router.roots[victim]
    gen = store.file_index[key]["gen"]
    _corrupt_payload(store.lifecycle.version_path(key, gen))
    assert store.fsck(repair=True, spot_check=None).quarantined
    fired = []
    _arm(router, "restore.mid_copy", fired)
    with pytest.raises(_Kill):
        router.anti_entropy()
    assert fired == ["restore.mid_copy"]
    router.close()
    _reopen_and_heal(tmp, {"org/qr": blob})


# ---------------------------------------------------------------------------
# end-to-end heal: corrupt -> failover -> quarantine -> restore -> clean
# ---------------------------------------------------------------------------

def test_corruption_heals_end_to_end_with_bit_identity(tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    try:
        blob, _ = _put(router, tmp, "org/heal", seed=20)
        key = f"org/heal/{FNAME}"
        victim = router.read_candidates("org/heal", FNAME)[0]
        store = router.roots[victim]
        gen = store.file_index[key]["gen"]
        healthy_digest = router.roots[
            [n for n in router.roots if n != victim][0]
        ].container_digest(key, gen)
        _corrupt_payload(store.lifecycle.version_path(key, gen))

        # fsck quarantines the corrupt replica copy
        rep = store.fsck(repair=True, spot_check=None)
        assert make_vid(key, gen) in rep.quarantined
        with pytest.raises(RuntimeError, match="quarantined"):
            store.retrieve_file("org/heal", FNAME)

        # routed reads keep serving byte-identical data from the others
        for name in router.read_candidates("org/heal", FNAME):
            if name == victim:
                continue
            assert router.roots[name].retrieve_file("org/heal", FNAME) == blob

        # anti-entropy re-ships the healthy copy and swaps it back in
        ae = router.anti_entropy()
        assert ae["restored"] == 1 and not ae["errors"]
        assert store.retrieve_file("org/heal", FNAME) == blob
        assert store.container_digest(key, gen) == healthy_digest
        _assert_converged(router, {"org/heal": blob})
    finally:
        router.close()


# ---------------------------------------------------------------------------
# tombstones: deletes propagate, nothing resurrects, re-uploads supersede
# ---------------------------------------------------------------------------

def test_delete_tombstones_survive_restart_and_block_resurrection(tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    blob, _ = _put(router, tmp, "org/del", seed=30)
    victim = router.replica_roots("org/del")[0]
    router.set_root_down(victim)  # this replica misses the delete
    out = router.delete("org/del", FNAME)
    assert out["deleted"] == 1 and victim in out["failed"]
    router.close()

    router = _cluster(tmp, load=True)
    try:
        # the down replica still holds the record — without tombstones the
        # sweep would re-ship it to everyone (resurrection)
        assert f"org/del/{FNAME}" in router.roots[victim].file_index
        rep = router.anti_entropy()
        assert rep["tombstones_applied"] >= 1
        for name, store in router.roots.items():
            assert f"org/del/{FNAME}" not in store.file_index, \
                f"deleted file resurrected on {name}"
        assert router.replica_index_diff() == {}
    finally:
        router.close()


def test_reupload_after_delete_supersedes_stale_tombstone(tmp_path):
    tmp = str(tmp_path)
    router = _cluster(tmp)
    try:
        _put(router, tmp, "org/re", seed=31)
        victim = router.replica_roots("org/re")[0]
        router.set_root_down(victim)  # marker will linger here
        router.delete("org/re", FNAME)
        blob2, _ = _put(router, tmp, "org/re", seed=32)  # legit re-upload
        router.set_root_down(victim, down=False)
        router.anti_entropy()
        for name, store in router.roots.items():
            assert store.retrieve_file("org/re", FNAME) == blob2, \
                f"stale tombstone wiped the re-upload on {name}"
        assert router.replica_index_diff() == {}
    finally:
        router.close()


# ---------------------------------------------------------------------------
# regression: fsck quarantine must persist its index mutations
# ---------------------------------------------------------------------------

def test_fsck_quarantine_persists_index_and_scrubbed_pins(tmp_path):
    """fsck(repair=True) scrubs tensor pins and re-paths the quarantined
    record in memory — but a restarted process reloads the on-disk index.
    The repair must persist, or the reopened store still pins the
    quarantined generation at its vanished path."""
    root = str(tmp_path / "s")
    store = ZLLMStore(root, workers=0, backend=TorchBackend(device="cpu"))
    src = os.path.join(str(tmp_path), "hub", FNAME)
    _write_model(src, 40)
    store.ingest_file(src, "org/p")
    store.save_index()
    key = f"org/p/{FNAME}"
    gen = store.file_index[key]["gen"]
    _corrupt_payload(store.lifecycle.version_path(key, gen))
    assert store.fsck(repair=True, spot_check=None).quarantined
    store.close()

    with ZLLMStore(root, workers=0, backend=TorchBackend(device="cpu")) as s2:
        assert s2.load_index()
        qvid = make_vid(key, gen)
        v = s2.lifecycle.versions[qvid]
        assert v.quarantined, "quarantine flag was not persisted"
        assert not any(make_vid(k, g) == qvid
                       for (k, g, _i) in s2.tensor_locations.values()), \
            "reopened index still pins the quarantined generation"
        rep = s2.fsck(repair=False, spot_check=None)
        assert not rep.corrupt and not rep.orphans


# ---------------------------------------------------------------------------
# automatic compaction trigger
# ---------------------------------------------------------------------------

def test_auto_compact_watermark_math():
    pol = AutoCompactPolicy(min_superseded_bytes=100, superseded_ratio=0.25)
    assert not pol.should_compact(99, 0, 1)          # below absolute floor
    assert pol.should_compact(100, 0, 1)             # floor met, live=0
    assert not pol.should_compact(100, 1000, 1)      # 10% < 25% of live
    assert pol.should_compact(250, 1000, 1)          # exactly at the ratio
    assert pol.should_compact(251, 1000, 1)
    # sweep-counter backstop fires regardless of byte watermarks
    pol = AutoCompactPolicy(min_superseded_bytes=1 << 60, every_n_gc=3)
    assert not pol.should_compact(0, 0, 2)
    assert pol.should_compact(0, 0, 3)
    # disabled backstop never fires on the counter alone
    pol = AutoCompactPolicy(min_superseded_bytes=1 << 60, every_n_gc=None)
    assert not pol.should_compact(0, 0, 10 ** 6)


def test_gc_fires_auto_compact_at_watermark(tmp_path):
    store = ZLLMStore(str(tmp_path / "s"), workers=0,
                      auto_compact=AutoCompactPolicy(min_superseded_bytes=1,
                                                     superseded_ratio=0.01),
                      backend=TorchBackend(device="cpu"))
    rng = np.random.RandomState(50)
    cur = {f"t{i}": rng.randn(1024).astype(np.float32) for i in range(4)}
    # one path per generation: a source file registered as a BitX base
    # must not be mutated in place (its tensor map is primed at ingest)
    p = os.path.join(str(tmp_path), "hub", "g0", FNAME)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    st.save_file(cur, p)
    store.ingest_file(p, "org/c")
    for r in range(3):  # superseded-but-pinned generations for compact
        cur[f"t{r}"] = rng.randn(1024).astype(np.float32)
        p = os.path.join(str(tmp_path), "hub", f"g{r + 1}", FNAME)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        st.save_file(dict(cur), p)
        assert store.ingest_file(p, "org/c").n_dedup > 0
    before = store._compactable_superseded_bytes()
    assert before > 0
    store.gc()
    assert store.stats.auto_compact_runs == 1
    assert store._compactable_superseded_bytes() < before  # compact ran
    with open(p, "rb") as f:
        blob = f.read()
    assert store.retrieve_file("org/c", FNAME) == blob
    # hysteresis: a converged compact leaves a residual floor (bitx bases,
    # cost-gated moves); without new churn further sweeps must not re-fire
    store.gc()
    store.gc()
    assert store.stats.auto_compact_runs == 1
    store.close()


# ---------------------------------------------------------------------------
# Bugfix regression: the repair-pending backlog is capped and TTL-pruned
# ---------------------------------------------------------------------------

def test_repair_pending_backlog_caps_and_expires(tmp_path):
    """Regression (failing-first): the backlog of repos awaiting a sweep
    used to be a bare set — a flapping replica could grow it without
    bound, and an entry whose sweep never came lived forever. It is now
    an insertion-ordered, re-stampable map with a hard cap (oldest
    evicted first) and a TTL prune on read."""
    router = _cluster(str(tmp_path))
    try:
        router.REPAIR_PENDING_MAX = 4
        for i in range(10):
            router._note_repair_pending(f"org/bl{i}")
        assert len(router._repair_pending) == 4
        assert router._pending_repairs() == {f"org/bl{i}" for i in range(6, 10)}
        # re-stamping refreshes an entry instead of duplicating it; the
        # next insert evicts the oldest UN-refreshed repo
        router._note_repair_pending("org/bl6")
        router._note_repair_pending("org/new")
        pending = router._pending_repairs()
        assert "org/bl6" in pending and "org/new" in pending
        assert "org/bl7" not in pending and len(router._repair_pending) == 4
        # TTL prune: an expired backlog drains to empty on read
        router.REPAIR_PENDING_TTL_S = 0.05
        time.sleep(0.06)
        assert router._pending_repairs() == set()
        assert not router._repair_pending
        # a sweep consumes what it swept, even for a vanished repo
        router.REPAIR_PENDING_TTL_S = 3600.0
        router._note_repair_pending("org/gone")
        router.anti_entropy()
        assert "org/gone" not in router._repair_pending
    finally:
        router.close()


# ---------------------------------------------------------------------------
# Bugfix regression: probe thundering herd after the backoff expires
# ---------------------------------------------------------------------------

def test_probe_after_backoff_is_claimed_single_flight(tmp_path):
    """Regression (failing-first): once a suspect root's backoff deadline
    passed, `_probe_ok` used to return True for EVERY concurrent caller,
    so all waiting reads led with the just-recovered root at once. The
    probe is now claimed: exactly one concurrent read targets it, the
    rest keep it as a last resort until the claimant's request resolves."""
    router = _cluster(str(tmp_path))
    try:
        repo = "org/herd"
        group = router.replica_roots(repo)
        victim = group[0]
        router.note_failure(victim)  # suspect, 0.5 s backoff
        assert router.read_candidates(repo, FNAME)[-1] == victim
        time.sleep(0.6)              # the probe deadline passes

        n = 8
        barrier = threading.Barrier(n)
        leads, lock = [], threading.Lock()

        def read():
            barrier.wait()
            cands = router.read_candidates(repo, FNAME)
            with lock:
                leads.append(cands[0])

        threads = [threading.Thread(target=read) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert leads.count(victim) == 1, \
            f"{leads.count(victim)}/{n} concurrent reads probed the " \
            f"recovering root (thundering herd)"
        # the claimant's outcome resolves the probe either way
        router.note_success(victim)
        assert router.read_candidates(repo, FNAME)[0] == victim
        router.note_failure(victim)  # failed probe: suspect again, longer
        assert router.read_candidates(repo, FNAME)[-1] == victim
    finally:
        router.close()


# ---------------------------------------------------------------------------
# read-repair: a failover read off a divergent replica converges the group
# ---------------------------------------------------------------------------

class _Client:
    """Minimal HTTP client for the read-repair tests."""

    def __init__(self, srv):
        self.conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)

    def get(self, path, headers=None):
        self.conn.request("GET", path, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def close(self):
        self.conn.close()


def _diverge(router, tmp, repo_id, seed):
    """Down the repo's first replica, advance the others one generation,
    bring it back: the group now disagrees on (key, gen)."""
    victim = router.replica_roots(repo_id)[0]
    router.set_root_down(victim)
    blob, _ = _put(router, tmp, repo_id, seed)
    _drain_workers(router)  # incl. the automatic straggler repair, which
    # cannot reach the down root and leaves the divergence in place
    router.set_root_down(victim, down=False)
    return victim, blob


def test_failover_read_schedules_scoped_read_repair(tmp_path):
    """A read off a divergent group serves the
    strongest validator, schedules an asynchronous per-repo repair that
    converges the group — and does NOT run a full sweep (an unrelated
    divergent repo stays divergent until its own repair)."""
    tmp = str(tmp_path)
    router = _cluster(tmp)
    router.READ_REPAIR_COOLDOWN_S = 0.0
    try:
        blob1, _ = _put(router, tmp, "org/rr", seed=60)
        _put(router, tmp, "org/other", seed=61)
        _drain_workers(router)
        victim, blob2 = _diverge(router, tmp, "org/rr", seed=62)
        _, blob_o2 = _diverge(router, tmp, "org/other", seed=63)
        assert router.replica_index_diff(repos=["org/rr"]) != {}
        key = f"org/rr/{FNAME}"

        with ServerThread(router, max_concurrency=2) as srv:
            c = _Client(srv)
            try:
                newest = max(r.file_index[key]["gen"]
                             for r in router.roots.values())
                status, h, body = c.get(f"/repo/org/rr/file/{FNAME}")
                # the plan orders strongest-record-first: the stale
                # replica never wins, a failover read never serves a
                # weaker validator
                assert status == 200 and body == blob2
                assert h["etag"] == f'"{key}@g{newest}"'
                # the stale generation's validator misses; the current
                # one revalidates — even across failover ordering
                s2, _, b2 = c.get(f"/repo/org/rr/file/{FNAME}",
                                  {"If-None-Match": f'"{key}@g{newest - 1}"'})
                assert s2 == 200 and b2 == blob2
                assert c.get(f"/repo/org/rr/file/{FNAME}",
                             {"If-None-Match":
                              f'"{key}@g{newest}"'})[0] == 304
                deadline = time.monotonic() + 30
                while router.replica_index_diff(repos=["org/rr"]) \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
            finally:
                c.close()

        assert router.read_repairs >= 1
        assert router.replica_index_diff(repos=["org/rr"]) == {}, \
            "read-repair never converged the group"
        assert router.roots[victim].retrieve_file("org/rr", FNAME) == blob2
        # scoped, not a sweep: the other divergent repo was left alone
        assert router.replica_index_diff(repos=["org/other"]) != {}
        # end state: one explicit sweep, full convergence, byte oracle
        router.anti_entropy()
        _drain_workers(router)
        _assert_converged(router, {"org/rr": blob2, "org/other": blob_o2})
    finally:
        router.close()


def test_read_repair_killed_mid_copy_retriggers_and_heals(tmp_path):
    """Fault-injection harness over the read-repair path: the first
    repair job dies at `anti_entropy.mid_copy` (error recorded, no
    convergence); the next failover read schedules a fresh repair that
    heals the group. Idempotent adoption makes the retry safe."""
    tmp = str(tmp_path)
    router = _cluster(tmp)
    router.READ_REPAIR_COOLDOWN_S = 0.0
    try:
        _put(router, tmp, "org/rk", seed=70)
        _drain_workers(router)
        victim, blob2 = _diverge(router, tmp, "org/rk", seed=71)
        fired = []

        def hook(point):
            if point == "anti_entropy.mid_copy" and not fired:
                fired.append(point)
                raise RuntimeError(f"injected fault: {point}")

        router.fault_hook = hook
        with ServerThread(router, max_concurrency=2) as srv:
            c = _Client(srv)
            try:
                status, _, body = c.get(f"/repo/org/rk/file/{FNAME}")
                assert status == 200 and body == blob2
                _drain_workers(router)
                assert fired == ["anti_entropy.mid_copy"]
                # poisoned repair: the group is still divergent
                assert router.replica_index_diff(repos=["org/rk"]) != {}
                # the next read re-triggers; this repair completes
                status, _, body = c.get(f"/repo/org/rk/file/{FNAME}")
                assert status == 200 and body == blob2
                deadline = time.monotonic() + 30
                while router.replica_index_diff(repos=["org/rk"]) \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
            finally:
                c.close()
        router.fault_hook = None
        assert router.read_repairs >= 2
        assert router.replica_index_diff(repos=["org/rk"]) == {}
        _drain_workers(router)
        _assert_converged(router, {"org/rk": blob2})
    finally:
        router.close()


def test_read_repair_is_deduped_and_cooled_down(tmp_path):
    """One in-flight repair per repo, plus a completion cooldown: a
    persistently divergent group must not enqueue one job per read."""
    tmp = str(tmp_path)
    router = _cluster(tmp)
    try:
        _put(router, tmp, "org/cd", seed=80)
        _drain_workers(router)
        victim = router.replica_roots("org/cd")[0]
        router.set_root_down(victim)  # keep one root down: repair cannot
        # converge the group, so every read sees the same divergence
        blob2, _ = _put(router, tmp, "org/cd", seed=81)
        _drain_workers(router)
        before = router.read_repairs
        first = router.schedule_read_repair("org/cd")
        assert first is not None
        # in-flight dedupe: an immediate reschedule is dropped
        assert router.schedule_read_repair("org/cd") is None
        _drain_workers(router)
        # cooldown (default 5 s): a repair that JUST finished is not
        # rescheduled on the next read either
        assert router.schedule_read_repair("org/cd") is None
        assert router.read_repairs == before + 1
        # zero cooldown (test override): reschedules immediately
        router.READ_REPAIR_COOLDOWN_S = 0.0
        assert router.schedule_read_repair("org/cd") is not None
        _drain_workers(router)
    finally:
        router.close()
