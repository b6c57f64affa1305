"""The reference HTTP hub and the port's, side by side on the CPU.

* The same request sequence (PUT, GET with ``Range`` and ``If-None-Match``,
  tensor GETs on all three lanes, DELETE, ``/admin/gc``) against a reference
  server over a ``backend="numpy"`` store and a port server over
  ``TorchBackend(device="cpu")`` gives the same statuses, headers (ETags
  included), byte-equal bodies, equal JSON once times, job ids and paths
  are dropped, and byte-identical container files.
* A mixed peer group (a coordinator of one package with a node of the other
  as its ``PeerStore``, both ways round) converges under
  ``/admin/anti_entropy``, tombstones included, and each node retrieves
  bit-exactly what was written to the other.
* Both packages register the same ``ROUTES``, so ``docs/HTTP_API.md`` holds
  for both.
"""

import http.client
import json
import os
import time
from collections import OrderedDict

import numpy as np
import pytest

from repro.core.pipeline import ZLLMStore as RefStore
from repro.formats import safetensors as ref_st
from repro.serve import store_server as ref_server
from repro.serve.peer import PeerStore as RefPeer
from repro.serve.router import StoreRouter as RefRouter
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore as PortStore
from repro_torch.serve import store_server as port_server
from repro_torch.serve.peer import PeerStore as PortPeer
from repro_torch.serve.router import StoreRouter as PortRouter

FNAME = "model.safetensors"


def _model(rng, n=4096, blob=False):
    t = {f"model.t{i}.weight": (rng.randn(n) * 0.02).astype(np.float32) for i in range(3)}
    t["model.t3.half"] = (rng.randn(n) * 0.02).astype(np.float16)
    if blob:  # incompressible non-float payload: the `stored` codec, served by sendfile
        t["tok.table"] = np.frombuffer(rng.bytes(16384), np.uint8).copy()
    return t


def _finetune(base, rng, sigma=1e-3):
    return {k: (v + (rng.randn(*v.shape) * sigma).astype(v.dtype)).astype(v.dtype)
            if v.dtype.kind == "f" else v.copy() for k, v in base.items()}


def _blob(tensors, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ref_st.save_file(tensors, path)
    with open(path, "rb") as f:
        return f.read()


class _Client:
    def __init__(self, port):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    def call(self, method, path, body=None, headers=None):
        self.conn.request(method, path, body=body, headers=headers or {})
        r = self.conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def close(self):
        self.conn.close()


_VOLATILE = ("job_id", "submitted", "started", "finished", "elapsed", "seconds",
             "_at", "_s", "_ms", "_MBps", "time", "pause", "spool", "path", "dir", "root")


def _scrub(obj, root):
    """JSON without what differs by construction between two runs: times,
    job ids, and paths under the store root."""
    if isinstance(obj, dict):
        return {k: _scrub(v, root) for k, v in obj.items()
                if not any(k == w or k.endswith(w) or k.startswith(w) for w in _VOLATILE)}
    if isinstance(obj, list):
        return [_scrub(v, root) for v in obj]
    if isinstance(obj, str) and root and root in obj:
        return obj.replace(root, "<root>")
    return obj


def _drive(port, root, blobs):
    """The sequence; returns one comparable row per request."""
    c = _Client(port)
    rows = []

    def req(method, path, body=None, headers=None):
        status, h, b = c.call(method, path, body, headers)
        ctype = h.get("content-type", "")
        if "json" in ctype:
            b = json.loads(b)  # its length varies with the times in it
            rows.append((method, path, headers, status,
                         {k: v for k, v in h.items() if k != "content-length"},
                         _scrub(b, root)))
        else:
            rows.append((method, path, headers, status, h, b))
        return status, h, b

    try:
        base_path = f"/repo/org/base/file/{FNAME}"
        ft_path = f"/repo/u0/ft/file/{FNAME}"
        status, _, out = req("PUT", base_path + "?sync=1", blobs["base"])
        assert status == 200 and out["job"]["state"] == "done", out
        status, _, out = c.call("PUT", ft_path + "?base=org/base", blobs["ft"])
        assert status == 202, out
        job = json.loads(out)["job_id"]
        deadline = time.monotonic() + 60
        while True:
            status, _, out = c.call("GET", f"/admin/jobs?job={job}")
            state = json.loads(out)
            if state["state"] in ("done", "failed"):
                break
            assert time.monotonic() < deadline, state
            time.sleep(0.02)
        rows.append(("job", _scrub(state, root)))
        assert state["state"] == "done" and state["results"][0]["n_bitx"] >= 1, state

        for path, want in ((base_path, blobs["base"]), (ft_path, blobs["ft"])):
            status, h, body = req("GET", path)
            assert status == 200 and body == want
            status, _, body = req("GET", path, headers={"Range": "bytes=100-4099"})
            assert status == 206 and body == want[100:4100]
            assert req("GET", path, headers={"If-None-Match": h["etag"]})[0] == 304
            assert req("GET", path, headers={"If-None-Match": h["etag"],
                                             "Range": "bytes=0-9"})[0] == 304
            req("GET", path, headers={"Range": f"bytes={len(want) + 5}-"})  # 416
        for repo, names in (("u0/ft", ("model.t0.weight", "model.t3.half", "tok.table")),
                            ("org/base", ("model.t1.weight", "tok.table"))):
            for name in names:
                tpath = f"/repo/{repo}/tensor/{name}"
                status, h, _ = req("GET", tpath)
                assert status == 200, (tpath, status)
                assert req("GET", tpath, headers={"Range": "bytes=10-1033"})[0] == 206
                assert req("GET", tpath, headers={"If-None-Match": h["etag"]})[0] == 304
        req("GET", f"/repo/org/base/tensor/nope")  # 404
        req("GET", "/healthz")
        req("GET", "/admin/fsck")
        status, _, out = req("DELETE", ft_path)
        assert status == 200 and out["deleted"] == 1, out
        assert req("GET", ft_path)[0] == 404
        assert req("POST", "/admin/gc")[0] == 200
        req("GET", base_path, headers={"Range": "bytes=-64"})
        status, _, stats = c.call("GET", "/stats")
        return rows, json.loads(stats)
    finally:
        c.close()


def _containers(root):
    out = {}
    for sub in ("containers", "basecache"):
        top = os.path.join(root, sub)
        for dirpath, _, files in os.walk(top):
            for fn in files:
                p = os.path.join(dirpath, fn)
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def test_same_requests_same_answers_and_same_containers(tmp_path):
    rng = np.random.RandomState(3)
    base = _model(rng, blob=True)
    blobs = {"base": _blob(base, str(tmp_path / "src" / "base" / FNAME)),
             "ft": _blob(_finetune(base, rng), str(tmp_path / "src" / "ft" / FNAME))}
    runs = {}
    for name, store_cls, server, kw in (
            ("ref", RefStore, ref_server, {"backend": "numpy"}),
            ("port", PortStore, port_server, {"backend": TorchBackend(device="cpu")})):
        root = str(tmp_path / name)
        store = store_cls(root, workers=2, **kw)
        try:
            with server.ServerThread(store, max_concurrency=4) as srv:
                rows, stats = _drive(srv.port, root, blobs)
            store.save_index()
        finally:
            store.close()
        runs[name] = (rows, stats, _containers(root))
    ref_rows, ref_stats, ref_files = runs["ref"]
    port_rows, port_stats, port_files = runs["port"]
    assert len(port_rows) == len(ref_rows) == 34
    for want, got in zip(ref_rows, port_rows):
        assert got == want
    assert ref_files and port_files.keys() == ref_files.keys()
    for name in ref_files:
        assert port_files[name] == ref_files[name], f"{name} differs between the packages"
    # the store summaries agree; the port's adds what its backend launched
    # (the plain versions here, on the CPU): every lane went through a wrapper
    counters = port_stats["store"].pop("backend_counters")
    assert (port_stats["store"].pop("array_backend"), ref_stats["store"].pop("array_backend")) \
        == ("torch", "numpy")
    assert _scrub(port_stats["store"], None) == _scrub(ref_stats["store"], None)
    assert counters["device"] == "cpu"
    assert all(counters["kernel_calls"][k] > 0
               for k in ("xor_split", "merge_xor", "split", "merge")), counters


PACKAGES = {
    "ref": dict(store=lambda root: RefStore(root, workers=1, backend="numpy"),
                router=RefRouter, peer=RefPeer, server=ref_server),
    "port": dict(store=lambda root: PortStore(root, workers=1,
                                              backend=TorchBackend(device="cpu")),
                 router=PortRouter, peer=PortPeer, server=port_server),
}


def _settle(stores, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(j["state"] in ("queued", "running")
                   for s in stores for j in s.ingest_jobs(256)):
            return
        time.sleep(0.02)
    raise TimeoutError(f"ingest jobs never settled: {[s.ingest_jobs(256) for s in stores]}")


@pytest.mark.parametrize("coord,leaf", [("ref", "port"), ("port", "ref")])
def test_mixed_peer_group_converges_under_anti_entropy(coord, leaf, tmp_path):
    """A coordinator of one package holds its own store and a node of the
    other package as its ``PeerStore``; run both ways, each package is the
    other's peer once. (Two nodes that mount each other at once recurse: a
    PUT fans out through the peer's PUT route and back, and so does the
    sweep's ``/admin/fsck``; the reference's peers are leaf servers.) A write
    and a delete land on the peer alone and a write on the coordinator
    alone; one ``/admin/anti_entropy`` converges both, tombstone included."""
    C, L = PACKAGES[coord], PACKAGES[leaf]
    leaf_store = L["store"](str(tmp_path / "leaf"))
    coord_store = C["store"](str(tmp_path / "coord"))
    leaf_srv = L["server"].ServerThread(leaf_store).start()
    router = C["router"](OrderedDict([("rC", coord_store),
                                      ("pL", C["peer"](f"http://127.0.0.1:{leaf_srv.port}",
                                                       timeout=10.0))]),
                         replicas=2, write_quorum=1)
    stores = (coord_store, leaf_store)
    rng = np.random.RandomState(5)
    paths = {name: str(tmp_path / "src" / name / FNAME)
             for name in ("shared", "from-coord", "from-leaf")}
    srcs = {name: _blob(_model(rng, n=1024), p) for name, p in paths.items()}
    clients = {}
    try:
        coord_srv = C["server"].ServerThread(router).start()
        clients = {"coord": _Client(coord_srv.port), "leaf": _Client(leaf_srv.port)}

        def put(node, repo, body):
            status, _, out = clients[node].call("PUT", f"/repo/{repo}/file/{FNAME}?sync=1", body)
            assert status == 200, out
            _settle(stores)

        put("coord", "org/shared", srcs["shared"])  # fans out to the peer over the wire
        for store in stores:
            assert store.retrieve_file("org/shared", FNAME) == srcs["shared"]
        coord_store.ingest_file(paths["from-coord"], "org/from-coord")
        put("leaf", "org/from-leaf", srcs["from-leaf"])
        status, _, out = clients["leaf"].call("DELETE", f"/repo/org/shared/file/{FNAME}")
        assert status == 200 and json.loads(out)["deleted"] == 1, out
        assert f"org/shared/{FNAME}" in coord_store.file_index
        assert f"org/from-coord/{FNAME}" not in leaf_store.file_index
        assert f"org/from-leaf/{FNAME}" not in coord_store.file_index

        status, _, out = clients["coord"].call("POST", "/admin/anti_entropy")
        out = json.loads(out)
        assert status == 200 and not out["errors"] and out["diff_after"] == {}, out
        assert out["tombstones_applied"] >= 1 and out["shipped_versions"] >= 2, out
        _settle(stores)

        live = {"org/from-coord": srcs["from-coord"], "org/from-leaf": srcs["from-leaf"]}
        for name, store in zip(("coordinator", "peer"), stores):
            assert f"org/shared/{FNAME}" not in store.file_index, f"tombstone lost on the {name}"
            for repo, want in live.items():
                assert store.retrieve_file(repo, FNAME) == want, f"{repo} differs on the {name}"
            assert store.fsck(repair=False, spot_check=None).ok
        gens = [{k: r["gen"] for k, r in s.file_index.items()} for s in stores]
        assert gens[0] == gens[1] and len(gens[0]) == 2
        # over HTTP, each server hands out what was written to the other
        for node, repo in (("leaf", "org/from-coord"), ("coord", "org/from-leaf")):
            status, _, body = clients[node].call("GET", f"/repo/{repo}/file/{FNAME}")
            assert status == 200 and body == live[repo]
            assert clients[node].call("GET", f"/repo/org/shared/file/{FNAME}")[0] == 404
    finally:
        for c in clients.values():
            c.close()
        if "coord_srv" in locals():
            coord_srv.stop()
        leaf_srv.stop()
        router.close()  # closes the coordinator's store and its peer mount
        leaf_store.close()


def test_routes_are_the_reference_routes():
    assert port_server.ROUTES == ref_server.ROUTES
    assert port_server.__all__ == ref_server.__all__
