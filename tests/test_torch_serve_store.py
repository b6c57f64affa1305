"""The port's counterpart of tests/test_serve_store.py: the same cases against
``repro_torch``, every store on ``TorchBackend(device="cpu")`` (the plain
versions of the kernels).

Async retrieval engine + HTTP store server (repro_torch.serve.store_server).

Covers the serving behaviour: >= 8 concurrent retrievals with
responses byte-identical to direct ZLLMStore reads — including while a
concurrent gc() runs (read-gate snapshot isolation) — single-flight
deduplication of concurrent decodes, and read_gen cache rollover on
re-registration during serving.
"""

import asyncio
import hashlib
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.serve.singleflight import SingleFlight
from repro_torch.serve.store_server import RetrievalEngine, ServerThread


def _write_model(path, rng, n_tensors=5, n=2048, scale=0.02):
    tensors = {f"model.t{i}.weight": (rng.randn(n) * scale).astype(np.float32)
               for i in range(n_tensors)}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    st.save_file(tensors, path)
    return tensors


def _write_finetune(path, base_tensors, rng, sigma=1e-3):
    ft = {k: (v + rng.randn(*v.shape).astype(np.float32) * sigma).astype(np.float32)
          for k, v in base_tensors.items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    st.save_file(ft, path)
    return ft


@pytest.fixture
def served_store(tmp_path):
    """Store with one family (base + 2 fine-tunes), an unrelated standalone
    model, and a deletable victim — plus the original bytes per repo."""
    rng = np.random.RandomState(42)
    repos = {}
    base_dir = str(tmp_path / "hub" / "org" / "base")
    base = _write_model(os.path.join(base_dir, "model.safetensors"), rng)
    repos["org/base"] = base_dir
    for k in range(2):
        d = str(tmp_path / "hub" / f"u{k}" / "ft")
        _write_finetune(os.path.join(d, "model.safetensors"), base, rng)
        repos[f"u{k}/ft"] = d
    other_dir = str(tmp_path / "hub" / "org" / "other")
    _write_model(os.path.join(other_dir, "model.safetensors"),
                 np.random.RandomState(7), scale=1.0)
    repos["org/other"] = other_dir
    victim_dir = str(tmp_path / "hub" / "org" / "victim")
    _write_model(os.path.join(victim_dir, "model.safetensors"),
                 np.random.RandomState(9), scale=1.0)
    repos["org/victim"] = victim_dir

    store = ZLLMStore(str(tmp_path / "store"), workers=2, backend=TorchBackend(device="cpu"))
    for rid, d in repos.items():
        store.ingest_file(os.path.join(d, "model.safetensors"), rid,
                          declared_base="org/base" if rid.startswith("u") else None)
    originals = {rid: open(os.path.join(d, "model.safetensors"), "rb").read()
                 for rid, d in repos.items()}
    yield store, originals
    store.close()


def _http_get(host, port, path):
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as r:
        return r.status, dict(r.headers), r.read()


# ---------------------------------------------------------------------------
# SingleFlight
# ---------------------------------------------------------------------------

def test_singleflight_coalesces_concurrent_same_key():
    async def run():
        sf = SingleFlight()
        calls = []

        async def slow():
            calls.append(1)
            await asyncio.sleep(0.05)
            return b"payload"

        outs = await asyncio.gather(*(sf.run("k", slow) for _ in range(8)))
        assert all(o == b"payload" for o in outs)
        assert len(calls) == 1 and sf.leaders == 1 and sf.joined == 7
        assert sf.inflight == 0
    asyncio.run(run())


def test_singleflight_distinct_keys_run_independently():
    async def run():
        sf = SingleFlight()

        async def make(v):
            await asyncio.sleep(0.01)
            return v

        outs = await asyncio.gather(*(sf.run(i, lambda v=i: make(v))
                                      for i in range(4)))
        assert outs == [0, 1, 2, 3] and sf.leaders == 4 and sf.joined == 0
    asyncio.run(run())


def test_singleflight_leader_error_propagates_to_joiners():
    async def run():
        sf = SingleFlight()

        async def boom():
            await asyncio.sleep(0.02)
            raise ValueError("decode failed")

        results = await asyncio.gather(*(sf.run("k", boom) for _ in range(3)),
                                       return_exceptions=True)
        assert all(isinstance(r, ValueError) for r in results)
        assert sf.leaders == 1 and sf.inflight == 0
    asyncio.run(run())


# ---------------------------------------------------------------------------
# RetrievalEngine
# ---------------------------------------------------------------------------

def test_engine_file_and_tensor_bit_exact(served_store):
    store, originals = served_store

    async def run():
        engine = RetrievalEngine(store, max_concurrency=4)
        try:
            for rid, orig in originals.items():
                assert await engine.get_file(rid) == orig
            # tensor-granular retrieval matches the source mmap bytes
            src = st.SafetensorsFile(
                os.path.join(os.path.dirname(store.root), "hub", "u0", "ft",
                             "model.safetensors"))
            try:
                for ti in src.infos:
                    data, meta = await engine.get_tensor("u0/ft", ti.name)
                    assert data == bytes(src.tensor_bytes(ti.name))
                    assert meta["dtype"] == ti.dtype_str
                    assert tuple(meta["shape"]) == ti.shape
            finally:
                src.close()
        finally:
            await engine.aclose()
    asyncio.run(run())


def test_engine_singleflights_concurrent_decodes(served_store):
    store, originals = served_store

    async def run():
        engine = RetrievalEngine(store, max_concurrency=8)
        try:
            outs = await asyncio.gather(*(engine.get_file("org/base")
                                          for _ in range(8)))
            assert all(o == originals["org/base"] for o in outs)
            stats = engine.stats()
            # one decode, 7 joiners (nothing was cached before the burst)
            assert stats["singleflight"]["leaders"] == 1
            assert stats["singleflight"]["joined"] == 7
            # a second wave hits the response cache, no new flight
            assert await engine.get_file("org/base") == originals["org/base"]
            assert engine.stats()["response_cache"]["hits"] >= 1
        finally:
            await engine.aclose()
    asyncio.run(run())


# ---------------------------------------------------------------------------
# HTTP server
# ---------------------------------------------------------------------------

def test_server_http_endpoints(served_store):
    store, originals = served_store
    with ServerThread(store, max_concurrency=8) as srv:
        status, _, body = _http_get(srv.host, srv.port, "/healthz")
        assert status == 200 and json.loads(body)["ok"] is True

        status, headers, body = _http_get(srv.host, srv.port,
                                          "/repo/org/base/file/model.safetensors")
        assert status == 200
        assert body == originals["org/base"]
        assert headers["x-content-sha256"] == hashlib.sha256(body).hexdigest()

        status, headers, body = _http_get(srv.host, srv.port,
                                          "/repo/u0/ft/tensor/model.t0.weight")
        assert status == 200
        assert headers["x-tensor-dtype"] == "F32"
        # unambiguous query form returns the same bytes
        status2, _, body2 = _http_get(srv.host, srv.port,
                                      "/repo/u0/ft/tensor?name=model.t0.weight")
        assert status2 == 200 and body2 == body
        src = st.SafetensorsFile(os.path.join(
            os.path.dirname(store.root), "hub", "u0", "ft", "model.safetensors"))
        try:
            assert body == bytes(src.tensor_bytes("model.t0.weight"))
        finally:
            src.close()

        status, _, body = _http_get(srv.host, srv.port, "/stats")
        assert status == 200
        stats = json.loads(body)
        assert stats["server"]["requests"] >= 2 and "lifecycle" in stats["store"]

        with pytest.raises(urllib.error.HTTPError) as ei:
            _http_get(srv.host, srv.port, "/repo/no/such/file/model.safetensors")
        assert ei.value.code == 404


def test_server_8_concurrent_retrievals_byte_identical_during_gc(served_store):
    """The main serving test: 8 concurrent clients hammer the server
    while a gc() (with something real to reclaim) runs mid-flight; every
    response is byte-identical to the direct store read and gc completes."""
    store, originals = served_store
    store.delete_repo("org/victim")         # make the sweep non-trivial
    survivors = [r for r in originals if r != "org/victim"]

    with ServerThread(store, max_concurrency=8) as srv:
        errors = []
        mismatches = []
        start = threading.Barrier(9)        # 8 clients + the gc thread
        gc_result = {}

        def client(cid):
            try:
                start.wait(timeout=30)
                for round_ in range(4):
                    for rid in survivors:
                        _, _, body = _http_get(
                            srv.host, srv.port, f"/repo/{rid}/file/model.safetensors")
                        if body != originals[rid]:
                            mismatches.append((cid, round_, rid))
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append((cid, repr(e)))

        def run_gc():
            start.wait(timeout=30)
            gc_result.update(store.gc())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        threads.append(threading.Thread(target=run_gc))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert not mismatches, mismatches
        assert gc_result.get("collected", 0) >= 1  # the victim was reclaimed

    # post-gc: victim is gone (404), survivors still serve
    with ServerThread(store, max_concurrency=2) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _http_get(srv.host, srv.port, "/repo/org/victim/file/model.safetensors")
        assert ei.value.code == 404
        _, _, body = _http_get(srv.host, srv.port,
                               "/repo/org/base/file/model.safetensors")
        assert body == originals["org/base"]


def test_8_clients_byte_identical_during_compact_and_incremental_gc(
        served_store, tmp_path):
    """8 concurrent HTTP clients read while compact()
    AND an incremental gc() run via the admin endpoints; every response is
    byte-identical to the direct store read, compaction genuinely retires a
    superseded generation mid-serve, and the max exclusive read-gate hold
    stays under the configured pause bound."""
    store, originals = served_store
    # superseded-but-pinned generation: re-register the family base — the
    # fine-tunes keep BitX-pinning base@g0 (skip case) — plus a dedup chain
    # on org/other so compact has real moves+retires, plus plain garbage
    v2 = str(tmp_path / "v2" / "model.safetensors")
    _write_model(v2, np.random.RandomState(55), scale=1.0)
    store.ingest_file(v2, "org/base")
    other = {f"model.t{i}.weight": np.random.RandomState(60 + i).randn(
        2048).astype(np.float32) for i in range(5)}
    for r in range(2):  # partial re-registers -> dedup chain on org/other
        for i in range(5):
            if i % 2 == r:
                other[f"model.t{i}.weight"] = np.random.RandomState(
                    70 + 10 * r + i).randn(2048).astype(np.float32)
        p = str(tmp_path / f"o{r}" / "model.safetensors")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        st.save_file(other, p)
        store.ingest_file(p, "org/other")
    store.delete_repo("org/victim")  # garbage for the incremental sweep
    # post-churn snapshot: what every client must see, byte for byte
    expected = {rid: store.retrieve_file(rid, "model.safetensors")
                for rid in originals if rid != "org/victim"}
    superseded_before = store.summary()["lifecycle"]["superseded_bytes"]
    assert superseded_before > 0

    pause_bound_ms = 1000.0
    with ServerThread(store, max_concurrency=8) as srv:
        errors, mismatches = [], []
        start = threading.Barrier(9)  # 8 clients + the admin thread
        admin: dict = {}

        def client(cid):
            try:
                start.wait(timeout=30)
                for round_ in range(4):
                    for rid in expected:
                        _, _, body = _http_get(
                            srv.host, srv.port,
                            f"/repo/{rid}/file/model.safetensors")
                        if body != expected[rid]:
                            mismatches.append((cid, round_, rid))
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append((cid, repr(e)))

        def run_admin():
            try:
                start.wait(timeout=30)
                _, _, body = _http_get(srv.host, srv.port, "/admin/compact")
                admin["compact"] = json.loads(body)
                _, _, body = _http_get(
                    srv.host, srv.port,
                    f"/admin/gc?incremental=1&max_pause_ms={pause_bound_ms}")
                admin["gc"] = json.loads(body)
            except Exception as e:  # pragma: no cover - failure reporting
                errors.append(("admin", repr(e)))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        threads.append(threading.Thread(target=run_admin))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert not mismatches, mismatches

    # compaction really happened mid-serve...
    assert admin["compact"]["retired_versions"] >= 1
    assert admin["compact"]["moved_records"] >= 1
    assert admin["gc"]["steps"] >= 1
    # ...and every exclusive hold respected the configured bound
    assert admin["compact"]["exclusive_hold_ms"] < pause_bound_ms
    assert admin["gc"]["max_pause_ms"] < pause_bound_ms
    assert store.stats.gc_max_pause_ms < pause_bound_ms

    # direct post-churn reads agree with what was served, and the store is
    # clean (all post-compact pins validated)
    for rid, data in expected.items():
        assert store.retrieve_file(rid, "model.safetensors") == data
    assert store.fsck(spot_check=None).ok
    assert store.summary()["lifecycle"]["superseded_bytes"] < superseded_before


def test_reregistration_during_serving_rolls_caches_over(served_store, tmp_path):
    """read_gen snapshot keys: after re-registering a key mid-serve, the
    next request must see the NEW bytes, never a stale cached decode."""
    store, originals = served_store
    with ServerThread(store, max_concurrency=4) as srv:
        _, _, body = _http_get(srv.host, srv.port,
                               "/repo/org/other/file/model.safetensors")
        assert body == originals["org/other"]

        v2_path = str(tmp_path / "v2" / "model.safetensors")
        _write_model(v2_path, np.random.RandomState(123), scale=1.0)
        store.ingest_file(v2_path, "org/other")     # ingest while serving
        v2 = open(v2_path, "rb").read()

        _, headers, body = _http_get(srv.host, srv.port,
                                     "/repo/org/other/file/model.safetensors")
        assert body == v2 and body != originals["org/other"]
        # and the old generation is still pinned for old dependants until gc
        assert int(headers["x-read-gen"]) == store.read_gen
