"""The port's ``TorchBackend`` (plain path on the CPU) against the JAX
package's backends, per op and at the store level.

Per op: ``TorchBackend(device="cpu")`` must emit exactly what the reference
``NumpyBackend`` and ``JaxBackend`` (Pallas in interpret mode) emit over the
same dtypes x odd/padded shapes x bucket sizes as tests/test_backend_equiv.py.
Store level: a port store and a reference store fed the same corpus write
byte-identical containers, and each package retrieves the other's store
bit-exactly from its persisted index (the state carried across: ``index.json``
plus the containers).
"""

import os

import numpy as np
import pytest
import torch

from repro.core.bitx import JaxBackend, NumpyBackend
from repro.core.pipeline import ZLLMStore as RefStore
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo

NP = NumpyBackend()
JX = JaxBackend()

# as tests/test_backend_equiv.py:26-32
DTYPES = ["uint16", "float32", "int8", "float64"]
SHAPES = [(1,), (3,), (37, 5), (1023,), (1024,), (1025,), (4096,)]
BUCKETS = [1, 2, 5]


def _mk(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "ui":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype)
    return rng.random(shape).astype(dtype)


def _assert_planes_equal(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def tb():
    return TorchBackend(device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_single_op_equivalence(tb, dtype, shape):
    x, base = _mk(dtype, shape, 11), _mk(dtype, shape, 12)
    # zipnn split/merge
    p = tb.byte_planes(x)
    _assert_planes_equal(p, NP.byte_planes(x), JX.byte_planes(x))
    m = tb.merge_planes(p, np.dtype(dtype), shape)
    m_np = NP.merge_planes(p, np.dtype(dtype), shape)
    m_jx = JX.merge_planes(p, np.dtype(dtype), shape)
    for want in (m_np, m_jx, x):
        assert m.dtype == want.dtype and m.shape == want.shape
        np.testing.assert_array_equal(m, want)
    # bitx xor/merge
    d = tb.xor_delta_planes(base.reshape(-1), x.reshape(-1))
    _assert_planes_equal(d, NP.xor_delta_planes(base.reshape(-1), x.reshape(-1)),
                         JX.xor_delta_planes(base.reshape(-1), x.reshape(-1)))
    r = tb.merge_planes_xor(d, base.reshape(-1))
    for want in (NP.merge_planes_xor(d, base.reshape(-1)),
                 JX.merge_planes_xor(d, base.reshape(-1))):
        assert r.dtype == want.dtype and r.shape == want.shape
        np.testing.assert_array_equal(r, want)


@pytest.mark.parametrize("bucket", BUCKETS)
def test_batched_ops_equal_mapped_singles(bucket):
    """One call over a mixed-dtype batch buckets by word width (one kernel
    call per width) and slices back exactly the per-tensor results."""
    tb = TorchBackend(device="cpu")
    xs, pairs = [], []
    seed = 0
    for dtype in DTYPES:
        for shape in SHAPES[:bucket + 2]:
            seed += 2
            x, b = _mk(dtype, shape, seed), _mk(dtype, shape, seed + 1)
            xs.append(x)
            pairs.append((b.reshape(-1), x.reshape(-1)))
    xs, pairs = xs[: bucket * 4], pairs[: bucket * 4]
    for got, x in zip(tb.byte_planes_batch(xs), xs):
        _assert_planes_equal(got, NP.byte_planes(x))
    d_ref = [NP.xor_delta_planes(b, f) for b, f in pairs]
    for got, want in zip(tb.xor_delta_planes_batch(pairs), d_ref):
        _assert_planes_equal(got, want)
    m_batch = tb.merge_planes_xor_batch([(d, b) for d, (b, _) in zip(d_ref, pairs)])
    for got, d, (b, _) in zip(m_batch, d_ref, pairs):
        want = NP.merge_planes_xor(d, b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    z_batch = tb.merge_planes_batch([(NP.byte_planes(x), x.dtype, x.shape) for x in xs])
    for got, x in zip(z_batch, xs):
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got, x)
    widths = len({np.dtype(np.asarray(x).dtype).itemsize for x in xs})
    calls = tb.counters()["kernel_calls"]
    assert calls == {"xor_split": widths, "merge_xor": widths, "split": widths, "merge": widths}


def test_empty_tensors_call_no_kernel():
    tb = TorchBackend(device="cpu")
    e = np.empty(0, np.float32)
    assert [p.size for p in tb.byte_planes(e)] == [0] * 4
    assert [p.size for p in tb.xor_delta_planes(e, e)] == [0] * 4
    assert tb.merge_planes_xor(tb.xor_delta_planes(e, e), e).size == 0
    assert tb.merge_planes([np.empty(0, np.uint8)] * 4, np.float32, (0, 3)).shape == (0, 3)
    assert sum(tb.counters()["kernel_calls"].values()) == 0


# ---------------------------------------------------------------------------
# Store level: same corpus, same bytes on disk, readable across packages
# ---------------------------------------------------------------------------

def _container_bytes(store_root):
    out = {}
    croot = os.path.join(store_root, "containers")
    for dirpath, _, files in os.walk(croot):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, croot)] = f.read()
    return out


@pytest.fixture(scope="module")
def stores(tmp_path_factory, corpus_dir):
    """The reference numpy store (serial) and the port's torch store
    (``workers=4``) over the shared corpus, both persisted and closed."""
    root, manifest = corpus_dir
    tmp = tmp_path_factory.mktemp("torch-equiv")
    roots = {"ref": str(tmp / "ref"), "port": str(tmp / "port")}
    ref = RefStore(roots["ref"], backend="numpy", workers=0)
    port = ZLLMStore(roots["port"], backend=TorchBackend(device="cpu"), workers=4)
    for s in (ref, port):
        for rid, _ in manifest:
            s.ingest_repo(os.path.join(root, rid), rid)
        s.save_index()
    summary = port.summary()
    ref.close()
    port.close()
    return roots, manifest, root, summary


def test_store_containers_bit_identical_reference_vs_port(stores):
    roots, _, _, summary = stores
    c_ref, c_port = _container_bytes(roots["ref"]), _container_bytes(roots["port"])
    assert c_ref.keys() == c_port.keys() and len(c_ref) > 0
    for name in c_ref:
        assert c_ref[name] == c_port[name], f"container diverged across packages: {name}"
    assert summary["array_backend"] == "torch"
    calls = summary["backend_counters"]["kernel_calls"]
    assert calls["xor_split"] > 0 and calls["split"] > 0
    # on the CPU nothing crosses to a device
    assert summary["backend_counters"]["h2d_bytes"] == 0


@pytest.mark.parametrize("reader,writer", [("port", "ref"), ("ref", "port")])
def test_cross_package_reads(stores, reader, writer):
    """Each package load_index()es the other's root and retrieves every file
    bit-exactly."""
    roots, manifest, root, _ = stores
    if reader == "port":
        s = ZLLMStore(roots[writer], backend=TorchBackend(device="cpu"), workers=2)
    else:
        s = RefStore(roots[writer], backend="numpy", workers=2)
    try:
        assert s.load_index()
        for rid, _ in manifest:
            with open(os.path.join(root, rid, "model.safetensors"), "rb") as f:
                orig = f.read()
            assert s.retrieve_file(rid, "model.safetensors") == orig
    finally:
        s.close()


def test_port_corpus_ingested_identically_by_both_packages(tmp_path):
    """The port's corpus generator (Qwen2-style GQA + QKV bias at a small
    width): both packages write the same containers and take the same lanes."""
    hub = str(tmp_path / "hub")
    spec = CorpusSpec(n_layers=2, d_model=64, d_ff=128, vocab=256, n_heads=4, n_kv_heads=2,
                      qkv_bias=True)
    gen = torch.Generator().manual_seed(5)
    base = make_base_tensors(spec, gen)
    write_repo(hub, "org/base", base)
    write_repo(hub, "u/ft-declared", make_finetune(base, spec, gen), base_model="org/base")
    write_repo(hub, "u/ft-undeclared", make_finetune(base, spec, gen, sigma_delta=0.001))
    repos = ["org/base", "u/ft-declared", "u/ft-undeclared"]
    results = {}
    for name, s in (("ref", RefStore(str(tmp_path / "ref"), backend="numpy")),
                    ("port", ZLLMStore(str(tmp_path / "port"),
                                       backend=TorchBackend(device="cpu"), workers=4))):
        results[name] = [s.ingest_repo(os.path.join(hub, rid), rid)[0] for rid in repos]
        for rid in repos:
            with open(os.path.join(hub, rid, "model.safetensors"), "rb") as f:
                assert s.retrieve_file(rid, "model.safetensors") == f.read()
        s.close()
    c_ref, c_port = _container_bytes(str(tmp_path / "ref")), _container_bytes(str(tmp_path / "port"))
    assert c_ref and c_ref == c_port
    lanes = [(r.base_source, r.base_id, r.n_zipnn > 0, r.n_bitx > 0) for r in results["port"]]
    assert lanes == [(r.base_source, r.base_id, r.n_zipnn > 0, r.n_bitx > 0)
                     for r in results["ref"]]
    assert lanes[1][:2] == ("metadata", "org/base") and lanes[1][3]
    assert lanes[2][:2] == ("bitdistance", "org/base") and lanes[2][3]
