"""The port's counterpart of tests/test_peer_replication.py: the same cases against
``repro_torch``, every store on ``TorchBackend(device="cpu")`` (the plain
versions of the kernels).

Cross-process replication chaos suite: three REAL peers over the wire.

Where ``test_replication.py`` proves ordering + idempotence against
in-process roots, this suite runs the same convergence story over the
peer HTTP protocol: a coordinator whose replica group mixes one local
root (``rA``) with two :class:`~repro_torch.serve.peer.PeerStore` mounts
(``pB``/``pC``), each backed by a real :class:`ServerThread` process
boundary and fronted by a :class:`~benchmarks.chaos.ChaosProxy` TCP
forwarder. The proxy fails the NETWORK — drop, blackhole, delay,
truncate-mid-body — without touching either process, so the suite can
partition peers, kill transfers mid-body, and heal, then prove one
sweep (or one targeted hint drain) returns every replica to
byte-identical convergence with zero live-tensor loss and zero
``.part`` debris.
"""

import os
import shutil
import tempfile
import time
from collections import OrderedDict

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as stt

from benchmarks.chaos import ChaosProxy
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.serve.peer import PeerStore
from repro_torch.serve.router import StoreRouter
from repro_torch.serve.store_server import ServerThread

FNAME = "model.safetensors"


def _write_model(path, seed, n_tensors=3, n=512):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tensors = {f"t{i}": (rng.randn(n) * 0.02).astype(np.float32)
               for i in range(n_tensors)}
    st.save_file(tensors, path)
    with open(path, "rb") as f:
        return f.read()


class _PeerCluster:
    """One local root + two chaos-proxied remote peers, all on disk under
    ``tmp``: the coordinator router sees ``rA`` (in-process) and
    ``pB``/``pC`` (PeerStore -> ChaosProxy -> ServerThread -> ZLLMStore).
    ``backing`` holds every replica's REAL store for direct byte-level
    assertions the wire cannot launder."""

    def __init__(self, tmp, *, replicas=3, write_quorum=2, timeout=5.0):
        self.tmp = tmp
        self.storeA = ZLLMStore(os.path.join(tmp, "A"), workers=1, backend=TorchBackend(device="cpu"))
        self.backing = OrderedDict([("rA", self.storeA)])
        self.servers, self.proxies, self.peers = {}, {}, {}
        roots = OrderedDict([("rA", self.storeA)])
        for name, sub in (("pB", "B"), ("pC", "C")):
            store = ZLLMStore(os.path.join(tmp, sub), workers=1, backend=TorchBackend(device="cpu"))
            srv = ServerThread(store).start()
            proxy = ChaosProxy(srv.host, srv.port).start()
            self.backing[name] = store
            self.servers[name] = srv
            self.proxies[name] = proxy
            self.peers[name] = PeerStore(proxy.url, timeout=timeout)
            roots[name] = self.peers[name]
        self.router = StoreRouter(roots, replicas=replicas,
                                  write_quorum=write_quorum)

    def invalidate(self):
        for p in self.peers.values():
            p.invalidate()

    def close(self):
        try:
            self.router.close()  # closes rA and the PeerStore mounts
        finally:
            for srv in self.servers.values():
                try:
                    srv.stop()
                except Exception:
                    pass
            for name, store in self.backing.items():
                if name == "rA":
                    continue
                try:
                    store.close()
                except Exception:
                    pass
            for proxy in self.proxies.values():
                proxy.stop()


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
    """Let every queued job — remote ingest, straggler repair, hint
    drain — finish on every replica."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pending = []
        for s in router.roots.values():
            try:
                pending += [j for j in s.ingest_jobs(256)
                            if j["state"] in ("queued", "running")]
            except Exception:
                continue  # an unreachable peer's jobs cannot block a drain
        if not pending:
            return
        time.sleep(0.02)
    raise TimeoutError("job workers never drained")


def _put(cl, repo_id, seed, n=512):
    src = os.path.join(cl.tmp, "up", repo_id.replace("/", "_"),
                       f"s{seed}-{FNAME}")
    blob = _write_model(src, seed, n=n)
    rep = cl.router.replicated_enqueue(src, repo_id, FNAME)
    _wait_jobs(cl.router, rep["jobs"])
    return blob, rep


def _assert_converged(cl, oracle):
    """Convergence over the wire: empty index diff, clean fsck on every
    BACKING store, and every live file byte-identical to the oracle on
    every replica — read directly, not through the proxy."""
    cl.invalidate()
    assert cl.router.replica_index_diff() == {}
    for name, store in cl.backing.items():
        rep = store.fsck(repair=False, spot_check=None)
        assert rep.ok, (name, rep.dangling, rep.corrupt)
    for repo_id, blob in oracle.items():
        key = f"{repo_id}/{FNAME}"
        for name, store in cl.backing.items():
            if blob is None:
                assert key not in store.file_index, \
                    f"deleted {key} resurrected on {name}"
            else:
                assert store.retrieve_file(repo_id, FNAME) == blob, \
                    f"live tensor data lost for {repo_id} on {name}"


class _Kill(BaseException):
    """BaseException so no except-Exception handler on the way out can
    soften the simulated crash."""


def _arm(router, point, fired):
    def hook(p):
        if p == point:
            fired.append(p)
            raise _Kill(p)
    router.fault_hook = hook


# ---------------------------------------------------------------------------
# partition -> quorum write -> heal -> one sweep converges all three
# ---------------------------------------------------------------------------

def test_partition_write_heal_sweep_converges_all_three(tmp_path):
    cl = _PeerCluster(str(tmp_path))
    try:
        blob1, rep = _put(cl, "org/base", 1)
        assert sorted(rep["jobs"]) == ["pB", "pC", "rA"]

        cl.proxies["pC"].mode = "drop"  # partition C off the wire
        assert not cl.peers["pC"].probe()
        blob2, rep = _put(cl, "org/part", 2)
        assert rep["failed"] == ["pC"] and len(rep["jobs"]) == 2
        ok, _ = cl.router.await_quorum(rep["jobs"])
        assert ok, "W=2 must be reachable with one peer partitioned"
        _drain_workers(cl.router)  # incl. the straggler repair, which
        # cannot reach the partitioned peer and leaves it divergent
        assert f"org/part/{FNAME}" not in cl.backing["pC"].file_index

        cl.proxies["pC"].mode = "pass"  # heal the wire
        rep2 = cl.router.anti_entropy()
        assert rep2["shipped_versions"] >= 1 and not rep2["errors"]
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/base": blob1, "org/part": blob2})
    finally:
        cl.close()


def test_replicated_delete_tombstones_cross_the_wire(tmp_path):
    cl = _PeerCluster(str(tmp_path))
    try:
        _put(cl, "org/del", 3)
        _drain_workers(cl.router)
        cl.proxies["pB"].mode = "drop"  # this replica misses the delete
        out = cl.router.delete("org/del", FNAME)
        assert out["deleted"] == 1 and out["failed"] == ["pB"]
        assert f"org/del/{FNAME}" in cl.backing["pB"].file_index
        cl.proxies["pB"].mode = "pass"
        rep = cl.router.anti_entropy()
        assert rep["tombstones_applied"] >= 1 and not rep["errors"]
        _assert_converged(cl, {"org/del": None})
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# truncate-mid-body kill: no .part debris after fsck, next sweep adopts
# ---------------------------------------------------------------------------

def test_mid_transfer_kill_leaves_no_part_debris_then_adopts(tmp_path):
    cl = _PeerCluster(str(tmp_path))
    try:
        _put(cl, "org/mid", 4, n=4096)
        _drain_workers(cl.router)
        cl.router.set_root_down("pB")  # pB misses the next generation
        blob2, _ = _put(cl, "org/mid", 5, n=4096)
        _drain_workers(cl.router)
        cl.router.set_root_down("pB", False)

        # every upload connection now dies after ~1.5 KB on the wire: the
        # resumable retry budget (4 attempts) cannot move a ~48 KB
        # container, so the ship fails mid-body and the target keeps a
        # partial ``.part``
        cl.proxies["pB"].mode = "truncate"
        cl.proxies["pB"].truncate_after = 1500
        rep = cl.router.anti_entropy()
        assert rep["errors"], "a truncated ship must surface as a sweep error"
        spool = cl.backing["pB"].spool_dir()
        assert [f for f in os.listdir(spool) if f.endswith(".part")], \
            "mid-body kill left no partial transfer on the target"

        # fsck flags the transfer temp as debris and repair removes it
        fr = cl.backing["pB"].fsck(repair=True, spot_check=None)
        assert fr.ok
        assert any(o.endswith(".part") for o in fr.orphans)
        assert not [f for f in os.listdir(spool) if f.endswith(".part")]

        cl.proxies["pB"].mode = "pass"  # heal: the next sweep completes
        rep2 = cl.router.anti_entropy()
        assert rep2["shipped_versions"] >= 1 and not rep2["errors"]
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/mid": blob2})
        assert cl.backing["pB"].retrieve_file("org/mid", FNAME) == blob2
    finally:
        cl.close()


def test_killed_upload_resumes_from_part_offset(tmp_path):
    """A .part that survives (no fsck in between) is a resume point, not
    garbage: the re-ship continues from the peer's offset instead of
    resending the whole container (asserted via the server-side offset
    re-sync — the second attempt's 409 handshake)."""
    cl = _PeerCluster(str(tmp_path))
    try:
        cl.router.set_root_down("pB")
        blob, _ = _put(cl, "org/res", 6, n=4096)
        _drain_workers(cl.router)
        cl.router.set_root_down("pB", False)
        cl.proxies["pB"].mode = "truncate"
        cl.proxies["pB"].truncate_after = 1500
        rep = cl.router.anti_entropy()
        assert rep["errors"]
        spool = cl.backing["pB"].spool_dir()
        parts = [f for f in os.listdir(spool) if f.endswith(".part")]
        assert parts
        have = os.path.getsize(os.path.join(spool, parts[0]))
        assert have > 0
        cl.proxies["pB"].mode = "pass"
        rep2 = cl.router.anti_entropy()
        assert rep2["shipped_versions"] >= 1 and not rep2["errors"]
        # the .part was consumed by the completed adopt, not re-created
        assert not [f for f in os.listdir(spool) if f.endswith(".part")]
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/res": blob})
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# hinted handoff: targeted re-ship on recovery, never a full sweep
# ---------------------------------------------------------------------------

def test_hinted_handoff_reships_exactly_hinted_keys(tmp_path):
    cl = _PeerCluster(str(tmp_path))
    try:
        blob1, _ = _put(cl, "org/h1", 7)
        _drain_workers(cl.router)

        # an UNRELATED divergence only a full sweep would repair: pB
        # misses org/h3 behind a manual down/up (the manual heal
        # deliberately does not drain its hint)
        cl.router.set_root_down("pB")
        blob3, _ = _put(cl, "org/h3", 8)
        _drain_workers(cl.router)
        cl.router.set_root_down("pB", False)
        assert cl.router.pending_hint_count("pB") == 1

        cl.proxies["pC"].mode = "drop"
        blob2, rep = _put(cl, "org/h2", 9)
        assert rep["failed"] == ["pC"]
        _drain_workers(cl.router)
        assert cl.router.pending_hint_count("pC") == 1
        assert cl.router.health()["pC"]["consecutive_failures"] > 0
        sweeps = cl.router.anti_entropy_sweeps

        # organic recovery: the first success after a failure streak
        # schedules the targeted drain for exactly this peer
        cl.proxies["pC"].mode = "pass"
        cl.router.note_success("pC")
        _drain_workers(cl.router)

        assert cl.router.pending_hint_count("pC") == 0
        assert cl.router.hints_drained >= 1
        assert cl.backing["pC"].retrieve_file("org/h2", FNAME) == blob2
        # targeted, not a sweep: the counter is flat and the unrelated
        # pB divergence (and its hint) are untouched
        assert cl.router.anti_entropy_sweeps == sweeps
        assert cl.router.pending_hint_count("pB") == 1
        assert f"org/h3/{FNAME}" not in cl.backing["pB"].file_index
        cl.invalidate()
        assert cl.router.replica_index_diff(repos=["org/h3"]) != {}

        # a full sweep settles the rest; the stale pB hint then drains
        # as already-converged debt
        rep2 = cl.router.anti_entropy()
        assert not rep2["errors"]
        out = cl.router.drain_hints()
        assert out["kept"] == 0 and not out["errors"]
        assert cl.router.pending_hint_count() == 0
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/h1": blob1, "org/h2": blob2,
                               "org/h3": blob3})
    finally:
        cl.close()


def test_hint_for_deleted_key_is_void_not_resurrected(tmp_path):
    """Regression: a hint whose write was deleted before the drain must
    be voided, NOT re-ingested from the staged spool bytes — the requeue
    would mint a fresh generation on the target and plant a divergent
    same-``(key, gen)`` container (or, above the marker's generation,
    resurrect the deleted key on the next sweep)."""
    cl = _PeerCluster(str(tmp_path))
    try:
        _put(cl, "org/void", 14)
        _drain_workers(cl.router)
        cl.proxies["pC"].mode = "drop"
        _put(cl, "org/void", 15)  # pC misses gen1: hint recorded
        _drain_workers(cl.router)
        assert cl.router.pending_hint_count("pC") == 1
        out = cl.router.delete("org/void", FNAME)  # pC misses this too
        assert out["failed"] == ["pC"]

        cl.proxies["pC"].mode = "pass"
        drained = cl.router.drain_hints()
        assert drained["drained"] == 1 and drained["requeued"] == 0, \
            "a deleted key's hint must void, not requeue its stale bytes"
        rep = cl.router.anti_entropy()
        assert not rep["errors"]
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/void": None})
    finally:
        cl.close()


def test_hints_for_unreachable_peer_are_kept(tmp_path):
    cl = _PeerCluster(str(tmp_path))
    try:
        cl.proxies["pC"].mode = "drop"
        _put(cl, "org/keep", 10)
        _drain_workers(cl.router)
        assert cl.router.pending_hint_count("pC") == 1
        out = cl.router.drain_hints()  # target still unreachable
        assert out["kept"] == 1 and out["drained"] == 0
        assert cl.router.pending_hint_count("pC") == 1
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# crash injection at the new wire fault points
# ---------------------------------------------------------------------------

def test_ship_killed_mid_body_then_resumes_and_heals(tmp_path):
    """``peer.ship_mid_body``: the coordinator dies mid-upload (after the
    first block hit the wire). The target holds at most a resumable
    ``.part``; the next sweep completes the adopt and converges."""
    cl = _PeerCluster(str(tmp_path))
    try:
        cl.router.set_root_down("pC")
        blob, _ = _put(cl, "org/k1", 11, n=4096)
        _drain_workers(cl.router)
        cl.router.set_root_down("pC", False)
        fired = []
        _arm(cl.router, "peer.ship_mid_body", fired)
        with pytest.raises(_Kill):
            cl.router.anti_entropy()
        assert fired == ["peer.ship_mid_body"]
        cl.router.fault_hook = None

        rep = cl.router.anti_entropy()
        assert rep["shipped_versions"] >= 1 and not rep["errors"]
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/k1": blob})
        spool = cl.backing["pC"].spool_dir()
        assert not [f for f in os.listdir(spool) if f.endswith(".part")]
    finally:
        cl.close()


def test_adopt_crash_before_index_persist_heals_on_restart(tmp_path):
    """``peer.adopt_pre_persist``: the RECEIVING peer dies between
    adopting the container bytes and persisting its index — a hard
    process crash. The restarted peer holds orphaned container bytes and
    no record; fsck treats the orphan as debris and the next sweep
    re-ships cleanly."""
    cl = _PeerCluster(str(tmp_path))
    storeC2 = srvC2 = None
    try:
        # prior converged state on C: fsck's empty-graph safety valve
        # (it refuses orphan deletes on an unloaded index) must not
        # conflate a crashed-but-real store with a missing one
        blob0, _ = _put(cl, "org/pre", 19)
        _drain_workers(cl.router)
        cl.router.set_root_down("pC")
        blob, _ = _put(cl, "org/k2", 12)
        _drain_workers(cl.router)
        cl.router.set_root_down("pC", False)

        fired = []

        def hook(point):
            if point == "peer.adopt_pre_persist":
                fired.append(point)
                raise RuntimeError(f"injected fault: {point}")

        cl.backing["pC"].fault_hook = hook
        rep = cl.router.anti_entropy()
        assert fired == ["peer.adopt_pre_persist"]
        assert rep["errors"], "the poisoned adopt must surface as an error"
        cl.backing["pC"].fault_hook = None

        # hard-crash peer C: abandon the live store WITHOUT close() (so
        # nothing flushes), restart it from disk on a fresh port, and
        # re-point the proxy at the restarted process
        cl.servers["pC"].stop()
        storeC2 = ZLLMStore(os.path.join(str(tmp_path), "C"), workers=1, backend=TorchBackend(device="cpu"))
        storeC2.load_index()
        assert f"org/k2/{FNAME}" not in storeC2.file_index, \
            "the record must not survive a crash before the index persist"
        srvC2 = ServerThread(storeC2).start()
        cl.proxies["pC"].upstream = (srvC2.host, srvC2.port)
        cl.peers["pC"].invalidate()
        assert storeC2.fsck(repair=True, spot_check=None).ok

        rep2 = cl.router.anti_entropy()
        assert not rep2["errors"]
        cl.backing["pC"] = storeC2
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/pre": blob0, "org/k2": blob})
    finally:
        cl.close()
        if srvC2 is not None:
            srvC2.stop()


def test_hint_drain_killed_before_log_persist_replays_idempotently(tmp_path):
    """``hint.pre_drain_persist``: the drain dies after the re-ship
    landed but before the hint log dropped the entries. The replay
    re-drains the same hints; idempotent shipping converges to the same
    state and the log finally empties."""
    cl = _PeerCluster(str(tmp_path))
    try:
        cl.proxies["pC"].mode = "drop"
        blob, rep = _put(cl, "org/k3", 13)
        assert rep["failed"] == ["pC"]
        _drain_workers(cl.router)
        assert cl.router.pending_hint_count("pC") == 1

        cl.proxies["pC"].mode = "pass"
        fired = []
        _arm(cl.router, "hint.pre_drain_persist", fired)
        with pytest.raises(_Kill):
            cl.router.drain_hints()
        assert fired == ["hint.pre_drain_persist"]
        cl.router.fault_hook = None

        # the ship landed; the debt did not clear
        assert cl.router.pending_hint_count("pC") == 1
        assert cl.backing["pC"].retrieve_file("org/k3", FNAME) == blob

        out = cl.router.drain_hints()  # the replay settles the same debt
        assert out["drained"] == 1 and not out["errors"]
        assert cl.router.pending_hint_count("pC") == 0
        _drain_workers(cl.router)
        _assert_converged(cl, {"org/k3": blob})
    finally:
        cl.close()


# ---------------------------------------------------------------------------
# property: random op/partition interleavings converge to the
# single-node oracle
# ---------------------------------------------------------------------------

@settings(max_examples=5, deadline=None)
@given(stt.lists(stt.integers(min_value=0, max_value=9999),
                 min_size=3, max_size=7))
def test_random_interleavings_converge_to_single_node_oracle(ops):
    """Any interleaving of put / delete / partition / heal across the
    three peers must, after heal + drain + one sweep, converge every
    replica to the state a single never-partitioned node reaches from
    the same accepted op sequence: identical per-key generations,
    tombstone-LWW deletions, byte-identical reads."""
    tmp = tempfile.mkdtemp(prefix="zllm-peer-prop-")
    cl = _PeerCluster(tmp, write_quorum=1, timeout=2.0)
    oracle = ZLLMStore(os.path.join(tmp, "oracle"), workers=0, backend=TorchBackend(device="cpu"))
    repos = ["org/p0", "org/p1"]
    try:
        for i, v in enumerate(ops):
            op = v % 5
            repo = repos[(v // 5) % len(repos)]
            peer = ("pB", "pC")[(v // 10) % 2]
            if op in (0, 1):  # put (seed unique per op: no cross-gen dedup)
                # one dir per op: the oracle's ingest_file derives the key
                # from the basename, which must stay model.safetensors
                src = os.path.join(tmp, "up", str(i), FNAME)
                _write_model(src, seed=v * 100 + i, n=64)
                rep = cl.router.replicated_enqueue(src, repo, FNAME)
                _wait_jobs(cl.router, rep["jobs"])
                oracle.ingest_file(src, repo)
            elif op == 2:  # delete (rA is never partitioned: always lands)
                cl.router.delete(repo, FNAME)
                oracle.delete_file(repo, FNAME)
            elif op == 3:  # partition one peer off the wire
                cl.proxies[peer].mode = "drop"
            else:  # heal every partition
                for p in cl.proxies.values():
                    p.mode = "pass"

        for p in cl.proxies.values():
            p.mode = "pass"
        _drain_workers(cl.router)
        cl.router.drain_hints()
        rep = cl.router.anti_entropy()
        assert not rep["errors"], rep["errors"]
        _drain_workers(cl.router)

        cl.invalidate()
        assert cl.router.replica_index_diff() == {}
        for repo in repos:
            key = f"{repo}/{FNAME}"
            orec = oracle.file_index.get(key)
            for name, store in cl.backing.items():
                rec = store.file_index.get(key)
                if orec is None:
                    assert rec is None, \
                        f"{key} on {name}: oracle deleted, replica kept it"
                else:
                    assert rec is not None, f"{key} lost on {name}"
                    assert rec["gen"] == orec["gen"], \
                        f"{key} on {name}: gen {rec['gen']} != " \
                        f"oracle {orec['gen']}"
                    assert store.retrieve_file(repo, FNAME) == \
                        oracle.retrieve_file(repo, FNAME), \
                        f"{key} on {name}: bytes diverge from the oracle"
    finally:
        try:
            cl.close()
        finally:
            oracle.close()
            shutil.rmtree(tmp, ignore_errors=True)
