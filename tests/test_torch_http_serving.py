"""The port's counterpart of tests/test_http_serving.py: the same cases against
``repro_torch``, every store on ``TorchBackend(device="cpu")`` (the plain
versions of the kernels).

HTTP/1.1 serving surface: keep-alive, range GETs, the remote write
path, zero-copy sendfile and the multi-store router.

Covers the serving behaviour: suffix/out-of-bounds/multi
range semantics (206 / 416 / 200-full fallback), range over a BitX-delta
tensor byte-identical to slicing the full GET, connection reuse across
requests, PUT → spooled ingest job → ranged read-back against a routed
2-root server, and /stats keeping the flat single-root shape while
aggregating per-root under a router.
"""

import asyncio
import json
import http.client
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import pytest

from repro_torch.core.bitx import BitXReader
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.serve.router import StoreRouter
from repro_torch.serve.singleflight import TieredResponseCache
from repro_torch.serve.store_server import (RetrievalEngine, ServerThread,
                                      parse_byte_range)


def _write_model(path, rng, n_tensors=3, n=2048, scale=0.02, blob=False):
    tensors = {f"model.t{i}.weight": (rng.randn(n) * scale).astype(np.float32)
               for i in range(n_tensors)}
    if blob:  # incompressible non-float payload -> `stored` codec on disk
        tensors["tok.table"] = np.frombuffer(rng.bytes(32768), np.uint8).copy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    st.save_file(tensors, path)
    return tensors


def _write_finetune(path, base_tensors, rng, sigma=1e-3):
    ft = {k: ((v + rng.randn(*v.shape).astype(np.float32) * sigma)
              .astype(np.float32) if v.dtype.kind == "f" else v.copy())
          for k, v in base_tensors.items()}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    st.save_file(ft, path)
    return ft


class Client:
    """Thin keep-alive HTTP client: one connection, many requests."""

    def __init__(self, srv):
        self.conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)

    def get(self, path, headers=None):
        self.conn.request("GET", path, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def put(self, path, body):
        self.conn.request("PUT", path, body=body)
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def post(self, path, body=b""):
        self.conn.request("POST", path, body=body)
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def close(self):
        self.conn.close()


@pytest.fixture
def family_store(tmp_path):
    """Base + BitX fine-tune + an incompressible (`stored`) tensor."""
    rng = np.random.RandomState(42)
    base_path = str(tmp_path / "hub" / "org" / "base" / "model.safetensors")
    base = _write_model(base_path, rng, blob=True)
    ft_path = str(tmp_path / "hub" / "u0" / "ft" / "model.safetensors")
    _write_finetune(ft_path, base, rng)
    store = ZLLMStore(str(tmp_path / "store"), workers=2, backend=TorchBackend(device="cpu"))
    store.ingest_file(base_path, "org/base")
    store.ingest_file(ft_path, "u0/ft", declared_base="org/base")
    yield store, {"org/base": open(base_path, "rb").read(),
                  "u0/ft": open(ft_path, "rb").read()}
    store.close()


# ---------------------------------------------------------------------------
# Range parser unit coverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("header,size,expect", [
    (None, 100, None),
    ("bytes=0-9", 100, (0, 9)),
    ("bytes=10-", 100, (10, 99)),
    ("bytes=-10", 100, (90, 99)),
    ("bytes=-200", 100, (0, 99)),        # oversized suffix clamps to all
    ("bytes=0-500", 100, (0, 99)),       # end clamps to size-1
    ("bytes=100-", 100, "unsat"),        # first-pos at EOF
    ("bytes=-0", 100, "unsat"),          # empty suffix
    ("bytes=-5", 0, "unsat"),            # empty body
    ("bytes=0-1,4-5", 100, None),        # multi-range -> full fallback
    ("bytes=5-2", 100, None),            # inverted -> full fallback
    ("bytes=abc", 100, None),
    ("chars=0-5", 100, None),
    # RFC 9110 hardening (regression: int() is laxer than the ABNF's
    # 1*DIGIT — it accepts "+5", "1_0", inner whitespace and unicode
    # digits, so these grammar-invalid forms used to answer 206)
    ("bytes=-1_0", 100, None),           # int("1_0") == 10 — not a DIGIT run
    ("bytes=-+5", 100, None),            # int("+5") == 5 — sign not allowed
    ("bytes=- 5", 100, None),            # int(" 5") == 5 — inner whitespace
    ("bytes=-٥", 100, None),        # int("٥") == 5 — unicode digit
    ("bytes=٠-٥", 100, None),  # \d matches unicode without re.ASCII
    ("bytes=5 -9", 100, None),           # whitespace inside the spec
    ("bytes=0- 5", 100, None),
    ("bytes=-00", 100, "unsat"),         # zero-length suffix, padded form
    ("bytes=00-05", 100, (0, 5)),        # leading zeros ARE valid 1*DIGIT
    ("bytes=" + "9" * 30 + "-", 100, "unsat"),   # huge first-pos: past EOF
    ("bytes=0-" + "9" * 30, 100, (0, 99)),       # huge last-pos clamps
    ("bytes=-" + "9" * 30, 100, (0, 99)),        # huge suffix clamps to all
])
def test_parse_byte_range(header, size, expect):
    assert parse_byte_range(header, size) == expect


# ---------------------------------------------------------------------------
# Range GETs over HTTP
# ---------------------------------------------------------------------------

def test_file_range_semantics(family_store):
    store, originals = family_store
    data = originals["org/base"]
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            path = "/repo/org/base/file/model.safetensors"
            status, headers, body = c.get(path)
            assert status == 200 and body == data
            assert headers["accept-ranges"] == "bytes"

            status, headers, body = c.get(path, {"Range": "bytes=100-299"})
            assert status == 206 and body == data[100:300]
            assert headers["content-range"] == f"bytes 100-299/{len(data)}"

            status, _, body = c.get(path, {"Range": "bytes=-64"})
            assert status == 206 and body == data[-64:]

            status, headers, body = c.get(
                path, {"Range": f"bytes={len(data)}-{len(data) + 10}"})
            assert status == 416
            assert headers["content-range"] == f"bytes */{len(data)}"

            # multi-range: deliberate 200-full fallback
            status, _, body = c.get(path, {"Range": "bytes=0-1,10-11"})
            assert status == 200 and body == data
        finally:
            c.close()


def test_bitx_tensor_range_matches_full_get_slice(family_store):
    """A range over a BitX-delta tensor must be
    byte-identical to slicing the full GET (and the direct store read)."""
    store, _ = family_store
    # pick a tensor the fine-tune actually stored as a BitX delta
    rec = store.file_index["u0/ft/model.safetensors"]
    reader = BitXReader.open(rec["path"], runtime=store._codec_runtime)
    bitx_names = [r.name for r in reader.records if r.codec == "bitx"]
    reader.close()
    assert bitx_names, "fixture must produce at least one BitX record"
    name = bitx_names[0]
    direct, meta = store.retrieve_tensor("u0/ft", "model.safetensors", name)

    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            path = f"/repo/u0/ft/tensor/{name}"
            status, headers, full = c.get(path)
            assert status == 200 and full == direct
            assert headers["x-tensor-codec"] == "bitx"
            n = len(full)
            for rng_hdr, lo, hi in [("bytes=0-99", 0, 100),
                                    (f"bytes={n // 2}-", n // 2, n),
                                    ("bytes=-128", n - 128, n),
                                    (f"bytes=7-{n + 999}", 7, n)]:
                status, _, part = c.get(path, {"Range": rng_hdr})
                assert status == 206
                assert part == full[lo:hi] == direct[lo:hi]
            # the decode ran once per read generation: every slice above
            # was cut from the cached buffer, not re-decoded
            sf = srv.server.engine.stats()["singleflight"]
            assert sf["leaders"] <= 2  # one file decode path + one tensor
        finally:
            c.close()


def test_stored_tensor_served_via_sendfile(family_store):
    store, _ = family_store
    direct, meta = store.retrieve_tensor("org/base", "model.safetensors",
                                         "tok.table")
    assert meta["codec"] == "stored"
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            path = "/repo/org/base/tensor/tok.table"
            status, headers, full = c.get(path)
            assert status == 200 and full == direct
            assert headers["x-zllm-sendfile"] == "1"
            assert headers["x-tensor-codec"] == "stored"
            status, headers, part = c.get(path, {"Range": "bytes=1000-1999"})
            assert status == 206 and part == direct[1000:2000]
            assert headers["x-zllm-sendfile"] == "1"
            status, headers, _ = c.get(path,
                                       {"Range": f"bytes={len(direct)}-"})
            assert status == 416
            assert srv.server.http["sendfile_responses"] >= 2
        finally:
            c.close()


def test_keepalive_connection_reuse(family_store):
    store, originals = family_store
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            for _ in range(16):
                status, headers, _ = c.get("/healthz")
                assert status == 200
                assert headers["connection"] == "keep-alive"
            status, _, body = c.get("/repo/org/base/file/model.safetensors")
            assert status == 200 and body == originals["org/base"]
        finally:
            c.close()
        # 17+ requests, exactly one connection
        assert srv.server.http["requests"] >= 17
        assert srv.server.http["connections"] == 1


# ---------------------------------------------------------------------------
# Remote write path
# ---------------------------------------------------------------------------

def test_put_sync_then_read_back(family_store, tmp_path):
    store, _ = family_store
    rng = np.random.RandomState(7)
    p = str(tmp_path / "new" / "model.safetensors")
    _write_model(p, rng, scale=1.0)
    data = open(p, "rb").read()
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            status, _, body = c.put(
                "/repo/org/new/file/model.safetensors?sync=1", data)
            out = json.loads(body)
            assert status == 200 and out["job"]["state"] == "done", out
            res = out["job"]["results"][0]
            assert res["repo_id"] == "org/new" and res["raw_bytes"] == len(data)
            status, _, got = c.get("/repo/org/new/file/model.safetensors")
            assert status == 200 and got == data
            # the spool was cleaned up after the job finished
            assert os.listdir(store.spool_dir()) == []
        finally:
            c.close()


def test_put_async_job_lifecycle_and_declared_base(family_store, tmp_path):
    """Async PUT: 202 + job id, /admin/jobs reaches `done`, the declared
    base (?base=) produces BitX records, and the result is bit-exact."""
    store, originals = family_store
    rng = np.random.RandomState(11)
    base_tensors = st.load_file(
        str(tmp_path / "hub" / "org" / "base" / "model.safetensors"))
    p = str(tmp_path / "ft2" / "model.safetensors")
    _write_finetune(p, base_tensors, rng)
    data = open(p, "rb").read()
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            status, _, body = c.put(
                "/repo/u1/ft2/file/model.safetensors?base=org/base", data)
            out = json.loads(body)
            assert status == 202 and "job_id" in out, out
            deadline = time.time() + 60
            while True:
                status, _, body = c.get(f"/admin/jobs?job={out['job_id']}")
                job = json.loads(body)
                if job["state"] in ("done", "failed"):
                    break
                assert time.time() < deadline, job
                time.sleep(0.02)
            assert job["state"] == "done", job
            assert job["results"][0]["base_id"] == "org/base"
            assert job["results"][0]["n_bitx"] >= 1
            status, _, got = c.get("/repo/u1/ft2/file/model.safetensors")
            assert status == 200 and got == data
            # job listing includes the finished job
            status, _, body = c.get("/admin/jobs")
            assert any(j["job_id"] == out["job_id"]
                       for j in json.loads(body)["jobs"])
        finally:
            c.close()
    assert store.fsck(spot_check=2).ok


def test_put_base_survives_restart_and_serves_finetunes(tmp_path):
    """Regression: the job worker must adopt a spooled BASE into
    basecache/ BEFORE persisting the index — a restarted store must not
    resurrect a dead spool path in base_paths/families (which would make
    every later same-family ingest fail at the bit-distance matcher)."""
    rng = np.random.RandomState(21)
    base_path = str(tmp_path / "hub" / "model.safetensors")
    base = _write_model(base_path, rng)
    root = str(tmp_path / "store")
    store = ZLLMStore(root, workers=2, backend=TorchBackend(device="cpu"))
    with ServerThread(store, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            status, _, body = c.put(
                "/repo/org/base/file/model.safetensors?sync=1",
                open(base_path, "rb").read())
            assert status == 200, body
        finally:
            c.close()
    store.close()

    # fresh process: every persisted base path must exist on disk, and a
    # declared-base fine-tune must still delta against the adopted base
    store2 = ZLLMStore(root, workers=2, backend=TorchBackend(device="cpu"))
    assert store2.load_index()
    for bid, p in store2.base_paths.items():
        assert os.path.exists(p), f"base path for {bid} rotted: {p}"
    ft_path = str(tmp_path / "ft" / "model.safetensors")
    _write_finetune(ft_path, base, rng)
    res = store2.ingest_file(ft_path, "u9/ft", declared_base="org/base")
    assert res.base_id == "org/base" and res.n_bitx >= 1
    assert store2.retrieve_file("u9/ft", "model.safetensors") == \
        open(ft_path, "rb").read()
    store2.close()


def test_corrupt_stored_span_is_never_served(family_store):
    """verify=True must cover the sendfile path too: flip a byte inside a
    stored-codec span on disk — the span check fails, the decode path
    takes over, and ITS verification turns the rot into a 500 (never a
    silent 200 of corrupt bytes)."""
    store, _ = family_store
    cpath, off, ln, meta = store.tensor_sendfile_span(
        "org/base", "model.safetensors", "tok.table")
    with open(cpath, "r+b") as f:
        f.seek(off + 7)
        orig = f.read(1)
        f.seek(off + 7)
        f.write(bytes([orig[0] ^ 0xFF]))
    with ServerThread(store, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            status, headers, body = c.get("/repo/org/base/tensor/tok.table")
            assert status == 500, (status, headers)
            assert "x-zllm-sendfile" not in headers
            assert srv.server.http["sendfile_responses"] == 0
        finally:
            c.close()


def test_put_without_content_length_is_rejected(family_store):
    store, _ = family_store
    with ServerThread(store, max_concurrency=2) as srv:
        import socket
        s = socket.create_connection((srv.host, srv.port), timeout=30)
        try:
            s.sendall(b"PUT /repo/a/b/file/f HTTP/1.1\r\n"
                      b"transfer-encoding: chunked\r\n\r\n")
            resp = s.recv(4096)
            assert b"411" in resp.split(b"\r\n", 1)[0]
        finally:
            s.close()


# ---------------------------------------------------------------------------
# Multi-store router
# ---------------------------------------------------------------------------

@pytest.fixture
def two_root_router(tmp_path):
    s0 = ZLLMStore(str(tmp_path / "r0"), workers=2, backend=TorchBackend(device="cpu"))
    s1 = ZLLMStore(str(tmp_path / "r1"), workers=2, backend=TorchBackend(device="cpu"))
    router = StoreRouter(OrderedDict([("r0", s0), ("r1", s1)]))
    yield router
    router.close()


def test_router_placement_is_deterministic_and_spreads(two_root_router):
    router = two_root_router
    placed = {router.place(f"org/model-{i}") for i in range(64)}
    assert placed == {"r0", "r1"}          # both roots get keys
    for i in range(16):
        rid = f"org/model-{i}"
        assert router.place(rid) == router.place(rid)


def test_router_put_get_and_aggregated_stats(two_root_router, tmp_path):
    router = two_root_router
    rng = np.random.RandomState(3)
    payloads = {}
    for i in range(4):
        p = str(tmp_path / f"m{i}" / "model.safetensors")
        _write_model(p, rng, scale=1.0)
        payloads[f"org/m{i}"] = open(p, "rb").read()

    with ServerThread(router, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            for rid, data in payloads.items():
                status, _, body = c.put(f"/repo/{rid}/file/model.safetensors"
                                        f"?sync=1", data)
                assert status == 200, body
            # reads route to whichever root holds the repo
            for rid, data in payloads.items():
                status, _, got = c.get(f"/repo/{rid}/file/model.safetensors")
                assert status == 200 and got == data
                # ranged read through the router too
                status, _, part = c.get(f"/repo/{rid}/file/model.safetensors",
                                        {"Range": "bytes=32-95"})
                assert status == 206 and part == data[32:96]
            status, _, body = c.get("/stats")
            stats = json.loads(body)
            # aggregated multi-root shape
            assert stats["store"]["n_roots"] == 2
            assert stats["store"]["n_files"] == 4
            assert set(stats["store"]["roots"]) == {"r0", "r1"}
            assert set(stats["server"]["roots"]) == {"r0", "r1"}
            # both roots actually hold data (consistent hashing spread 4
            # repos; collisions onto one root are possible but the chosen
            # ids split across roots — placement is deterministic)
            per_root_files = [s["n_files"]
                              for s in stats["store"]["roots"].values()]
            assert sum(per_root_files) == 4
            # admin fan-out hits every root
            status, _, body = c.post("/admin/gc")
            gc = json.loads(body)
            assert set(gc["roots"]) == {"r0", "r1"}
            status, _, body = c.get("/admin/fsck")
            assert json.loads(body)["ok"] is True
            # single-root selection
            status, _, body = c.post("/admin/compact?root=r1")
            assert "roots" in json.loads(body)
            status, _, body = c.post("/admin/gc?root=nope")
            assert status == 404
        finally:
            c.close()


def test_single_root_stats_keep_flat_shape(family_store):
    """One root -> /stats keeps the flat single-store shape
    (server_smoke back-compat); no per-root nesting leaks in."""
    store, _ = family_store
    with ServerThread(store, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            status, _, body = c.get("/stats")
            stats = json.loads(body)
            assert "lifecycle" in stats["store"]          # flat summary
            assert "n_roots" not in stats["store"]
            assert "requests" in stats["server"]
            assert "roots" not in stats["server"]
            assert "http" in stats["server"]
            # flat admin reports too
            status, _, body = c.post("/admin/gc")
            assert "collected" in json.loads(body)
            assert "roots" not in json.loads(body)
        finally:
            c.close()


def test_put_with_declared_base_colocates_with_base_root(two_root_router,
                                                         tmp_path):
    """Family co-location: a new fine-tune declaring ?base= must land on
    the root serving that base (per-root delta domains), even when hash
    placement would pick the other root — and actually BitX-delta."""
    router = two_root_router
    rng = np.random.RandomState(31)
    base_path = str(tmp_path / "fam" / "model.safetensors")
    base = _write_model(base_path, rng)
    with ServerThread(router, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            status, _, body = c.put(
                "/repo/fam/base/file/model.safetensors?sync=1",
                open(base_path, "rb").read())
            assert status == 200, body
            base_root = json.loads(body)["root"]
            # a fine-tune id that hash-places on the OTHER root
            other = next(f"fam/ft-{i}" for i in range(64)
                         if router.place(f"fam/ft-{i}") != base_root)
            ft_path = str(tmp_path / "famft" / "model.safetensors")
            _write_finetune(ft_path, base, rng)
            status, _, body = c.put(
                f"/repo/{other}/file/model.safetensors?base=fam/base&sync=1",
                open(ft_path, "rb").read())
            out = json.loads(body)
            assert status == 200, out
            assert out["root"] == base_root          # co-located
            assert out["job"]["results"][0]["base_id"] == "fam/base"
            assert out["job"]["results"][0]["n_bitx"] >= 1
        finally:
            c.close()


def test_reregistration_routes_to_owning_root(two_root_router, tmp_path):
    """A re-PUT of an existing repo must land on the root already holding
    it (not the hash placement), preserving the generation chain."""
    router = two_root_router
    rng = np.random.RandomState(5)
    p = str(tmp_path / "v1" / "model.safetensors")
    _write_model(p, rng, scale=1.0)
    # seed the repo on the NON-placement root directly
    rid = "org/displaced"
    anti = "r0" if router.place(rid) == "r1" else "r1"
    router.store(anti).ingest_file(p, rid)
    assert router.locate(rid) == anti

    p2 = str(tmp_path / "v2" / "model.safetensors")
    _write_model(p2, rng, scale=1.0)
    v2 = open(p2, "rb").read()
    with ServerThread(router, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            status, _, body = c.put(f"/repo/{rid}/file/model.safetensors"
                                    f"?sync=1", v2)
            assert status == 200, body
            status, _, got = c.get(f"/repo/{rid}/file/model.safetensors")
            assert status == 200 and got == v2
        finally:
            c.close()
    # the re-registration stayed on the owning root: two generations there,
    # nothing on the placement root
    assert len(router.store(anti).lifecycle.versions) == 2
    assert not router.store("r0" if anti == "r1" else "r1").file_index


# ---------------------------------------------------------------------------
# Conditional GETs: ETag / If-None-Match vs the key lifecycle
# ---------------------------------------------------------------------------

def test_conditional_get_lifecycle(family_store, tmp_path):
    """Strong `key@gN` validators on files AND
    tensors, 304 revalidation (also on ranged requests — If-None-Match
    precedes Range per RFC 9110), gc leaving the validator alone, and a
    re-registration (new generation) turning the old ETag back into a
    200 with fresh bytes."""
    store, originals = family_store
    data = originals["org/base"]
    with ServerThread(store, max_concurrency=4) as srv:
        c = Client(srv)
        try:
            path = "/repo/org/base/file/model.safetensors"
            status, h, body = c.get(path)
            assert status == 200 and body == data
            etag = h["etag"]
            gen = store.file_index["org/base/model.safetensors"]["gen"]
            assert etag == f'"org/base/model.safetensors@g{gen}"'
            assert h["cache-control"] == "no-cache"

            # revalidation: bodiless 304 echoing the validator
            status, h2, b2 = c.get(path, {"If-None-Match": etag})
            assert status == 304 and b2 == b"" and h2["etag"] == etag
            # weak comparison, list members and * all match
            assert c.get(path, {"If-None-Match": f'W/{etag}, "nope"'})[0] == 304
            assert c.get(path, {"If-None-Match": "*"})[0] == 304
            # a stale validator misses: full 200
            status, _, b3 = c.get(
                path, {"If-None-Match": '"org/base/model.safetensors@g999"'})
            assert status == 200 and b3 == data

            # If-None-Match is evaluated BEFORE Range: 304, never a 206
            status, _, b4 = c.get(path, {"If-None-Match": etag,
                                         "Range": "bytes=0-9"})
            assert status == 304 and b4 == b""

            # tensors share the file's (key, gen) validator — on the
            # decode path and on the sendfile (stored-codec) path alike
            status, th, _ = c.get("/repo/org/base/tensor/model.t0.weight")
            assert status == 200 and th["etag"] == etag
            assert c.get("/repo/org/base/tensor/model.t0.weight",
                         {"If-None-Match": etag})[0] == 304
            status, th2, _ = c.get("/repo/org/base/tensor/tok.table")
            assert status == 200 and th2["etag"] == etag
            status, th3, b5 = c.get("/repo/org/base/tensor/tok.table",
                                    {"If-None-Match": etag,
                                     "Range": "bytes=0-99"})
            assert status == 304 and b5 == b""

            # gc does not touch the record -> revalidation stays free
            c.post("/admin/gc")
            assert c.get(path, {"If-None-Match": etag})[0] == 304

            # re-register the key: new generation, old validator dead
            rng = np.random.RandomState(77)
            p2 = str(tmp_path / "v2" / "model.safetensors")
            _write_model(p2, rng, blob=True)
            v2 = open(p2, "rb").read()
            status, _, jb = c.put(path + "?sync=1", v2)
            assert status == 200, jb
            status, h5, b6 = c.get(path, {"If-None-Match": etag})
            assert status == 200 and b6 == v2, \
                "old ETag must MISS after re-registration"
            assert h5["etag"] != etag
            assert c.get(path, {"If-None-Match": h5["etag"]})[0] == 304
            # ... and while gc reclaims the superseded generation
            c.post("/admin/gc")
            status, _, b7 = c.get(path, {"If-None-Match": etag})
            assert status == 200 and b7 == v2

            assert srv.server.http["conditional_requests"] >= 10
            assert srv.server.http["not_modified"] >= 7
        finally:
            c.close()


def test_delete_kills_the_validator(family_store):
    """A deleted key stops emitting an ETag and stops revalidating."""
    store, originals = family_store
    with ServerThread(store, max_concurrency=2) as srv:
        c = Client(srv)
        try:
            path = "/repo/u0/ft/file/model.safetensors"
            status, h, _ = c.get(path)
            assert status == 200
            etag = h["etag"]
            self_conn = c.conn  # DELETE via the same keep-alive connection
            self_conn.request("DELETE", path)
            r = self_conn.getresponse()
            assert r.status == 200 and json.loads(r.read())["deleted"] == 1
            status, h2, _ = c.get(path, {"If-None-Match": etag})
            assert status == 404 and "etag" not in h2
        finally:
            c.close()


# ---------------------------------------------------------------------------
# Two-tier decoded cache
# ---------------------------------------------------------------------------

def test_tiered_cache_spill_promote_and_purge(tmp_path):
    sd = str(tmp_path / "spill")
    cache = TieredResponseCache(sd, max_bytes=150, spill_max_bytes=4096,
                                max_items=8)
    a, b, d = b"A" * 60, b"B" * 60, b"D" * 60
    cache.put(("file", "r", "a"), "va", a, len(a))
    cache.put(("file", "r", "b"), "vb", b, len(b))
    cache.put(("file", "r", "d"), "vd", d, len(d))   # budget: evicts "a"
    st1 = cache.stats()
    assert st1["spilled_items"] >= 1 and cache.spill_bytes > 0
    assert len(os.listdir(sd)) == st1["spilled_items"]

    # disk hit promotes back into RAM and consumes the spill file
    assert cache.get(("file", "r", "a"), "va") == a
    st2 = cache.stats()
    assert st2["disk_hits"] == 1 and st2["promotions"] == 1
    assert cache.get(("file", "r", "a"), "va") == a   # now a RAM hit
    assert cache.stats()["hits"] >= 1

    # wrong validator is a miss on both tiers
    assert cache.get(("file", "r", "a"), "OTHER") is None

    # (bytes, meta) tuples — the tensor response shape — survive a
    # spill/promote round trip intact
    meta = {"dtype": "F32", "shape": [4, 2], "codec": "bitx"}
    cache.put(("tensor", "r", "f", "t"), "vt", (b"\x07" * 64, meta), 64)
    for i in range(4):  # push it out of RAM
        cache.put(("file", "r", f"x{i}"), f"v{i}", bytes([i]) * 60, 60)
    got = cache.get(("tensor", "r", "f", "t"), "vt")
    assert got == (b"\x07" * 64, meta)

    # purge drops dead entries from BOTH tiers without spilling them
    n = cache.purge(lambda objkey, validator: False)
    assert n >= 1 and len(cache) == 0
    assert cache.ram_bytes == 0 and cache.spill_bytes == 0
    assert os.listdir(sd) == []


def test_tiered_cache_spill_budget_and_cold_start_wipe(tmp_path):
    sd = str(tmp_path / "spill")
    cache = TieredResponseCache(sd, max_bytes=100, spill_max_bytes=300,
                                max_items=64)
    for i in range(8):  # each insert evicts the previous entry to disk
        cache.put(("file", "r", f"k{i}"), f"v{i}", bytes([i]) * 90, 90)
    assert cache.spill_bytes <= 300  # disk tier holds its own budget
    assert len(os.listdir(sd)) == cache.stats()["spilled_items"]
    # a new cache over the same directory starts cold: stale spill files
    # (another process's cache state) are wiped, not trusted
    again = TieredResponseCache(sd, max_bytes=100)
    assert os.listdir(sd) == [] and len(again) == 0


def test_fsck_cleans_decoded_spill_debris(tmp_path):
    """Crash debris contract: half-written `.part` temps under
    `.decoded/` are fsck orphans (removed under repair=True); finished
    spill files belong to a possibly-live engine and are left alone."""
    store = ZLLMStore(str(tmp_path / "s"), workers=0, backend=TorchBackend(device="cpu"))
    droot = store.decoded_dir()
    part = os.path.join(droot, "deadbeef.dec.part")
    dec = os.path.join(droot, "cafecafe.dec")
    for p in (part, dec):
        with open(p, "wb") as f:
            f.write(b"torn")
    rep = store.fsck(repair=True, spot_check=0)
    assert rep.ok  # orphan debris never fails the check
    assert any(p.endswith(".part") for p in rep.orphans)
    assert not os.path.exists(part), "crash debris survived repair"
    assert os.path.exists(dec), "live spill file deleted by fsck"
    store.close()


def test_two_tier_cache_serves_spilled_tensor_byte_identical(family_store):
    """A tensor evicted from the RAM tier comes back
    from the decoded-spill tier byte-identical to `retrieve_tensor`,
    without re-paying the decode (single-flight leader count frozen)."""
    store, _ = family_store
    rec = store.file_index["u0/ft/model.safetensors"]
    reader = BitXReader.open(rec["path"], runtime=store._codec_runtime)
    bitx_names = [r.name for r in reader.records if r.codec == "bitx"]
    reader.close()
    name = bitx_names[0]
    direct, _ = store.retrieve_tensor("u0/ft", "model.safetensors", name)

    # RAM tier sized to hold the tensor but NOT the full file: the file
    # GET must cascade the tensor entry onto the disk tier
    with ServerThread(store, max_concurrency=4,
                      cache_bytes=len(direct) + 1024,
                      spill_bytes=64 << 20) as srv:
        c = Client(srv)
        try:
            path = f"/repo/u0/ft/tensor/{name}"
            status, _, b1 = c.get(path)
            assert status == 200 and b1 == direct
            status, _, full = c.get("/repo/u0/ft/file/model.safetensors")
            assert status == 200
            cache = srv.server.engine._cache
            assert cache.stats()["spilled_items"] >= 1, \
                "file GET should have spilled the tensor entry to disk"
            leaders_before = srv.server.engine._flight.leaders
            status, _, b2 = c.get(path)
            assert status == 200 and b2 == direct == b1
            st = cache.stats()
            assert st["disk_hits"] >= 1 and st["promotions"] >= 1
            assert srv.server.engine._flight.leaders == leaders_before, \
                "promotion must not re-run the decode"
        finally:
            c.close()


# ---------------------------------------------------------------------------
# Bugfix regression: stale-generation cache leak
# ---------------------------------------------------------------------------

def test_slow_decode_outliving_its_generation_is_not_cached(tmp_path):
    """Regression (failing-first against the read_gen-keyed cache): a
    single-flight decode that completes AFTER its key is re-registered /
    deleted used to insert its result under the dead key, where it could
    never be hit and squatted on the byte budget until LRU pressure."""
    rng = np.random.RandomState(9)
    src = str(tmp_path / "hub" / "model.safetensors")
    _write_model(src, rng)
    blob = open(src, "rb").read()
    store = ZLLMStore(str(tmp_path / "store"), workers=0, backend=TorchBackend(device="cpu"))
    store.ingest_file(src, "org/slow")

    release = threading.Event()
    in_flight = threading.Event()
    real = store.retrieve_file_digest

    def slow(repo_id, filename, verify=True):
        out = real(repo_id, filename, verify=verify)  # gate released here
        in_flight.set()
        release.wait(30)  # hold the flight open past the mutation
        return out

    store.retrieve_file_digest = slow

    async def scenario():
        engine = RetrievalEngine(store, max_concurrency=2,
                                 cache_bytes=1 << 20, spill_bytes=0)
        try:
            task = asyncio.ensure_future(
                engine.get_file_digest("org/slow", "model.safetensors"))
            await asyncio.get_running_loop().run_in_executor(
                None, in_flight.wait, 30)
            # the mutation lands mid-flight: key deleted, read_gen bumped
            store.delete_file("org/slow", "model.safetensors")
            release.set()
            data, _ = await task
            assert data == blob  # the in-flight caller still gets its bytes
            st = engine._cache.stats()
            assert st["items"] == 0 and st["ram_bytes"] == 0, \
                f"dead-generation bytes squat on the budget: {st}"
        finally:
            await engine.aclose()

    asyncio.run(scenario())
    store.close()


def test_gen_bump_purges_only_dead_entries(tmp_path):
    """The purge-on-gen-bump half of the fix — and the improvement over
    the old whole-cache wipe: a mutation of key A reclaims A's bytes
    immediately while key B's hot entry survives."""
    rng = np.random.RandomState(10)
    store = ZLLMStore(str(tmp_path / "store"), workers=0, backend=TorchBackend(device="cpu"))
    blobs = {}
    for repo in ("org/a", "org/b"):
        p = str(tmp_path / repo.replace("/", "_") / "model.safetensors")
        _write_model(p, rng)
        store.ingest_file(p, repo)
        blobs[repo] = open(p, "rb").read()

    async def scenario():
        engine = RetrievalEngine(store, max_concurrency=2,
                                 cache_bytes=1 << 20, spill_bytes=0)
        try:
            for repo in blobs:
                data, _ = await engine.get_file_digest(repo,
                                                       "model.safetensors")
                assert data == blobs[repo]
            assert engine._cache.stats()["items"] == 2
            both = engine._cache.ram_bytes
            store.delete_file("org/a", "model.safetensors")  # bumps read_gen
            # next access observes the bump and purges ONLY the dead entry
            data, _ = await engine.get_file_digest("org/b",
                                                   "model.safetensors")
            assert data == blobs["org/b"]
            st = engine._cache.stats()
            assert st["purged"] == 1 and st["items"] == 1
            assert engine._cache.ram_bytes == both - len(blobs["org/a"])
        finally:
            await engine.aclose()

    asyncio.run(scenario())
    store.close()
