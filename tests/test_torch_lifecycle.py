"""The port's counterpart of tests/test_lifecycle.py, and the harness that
runs the reference's store suites on the port.

``Suite(name)`` executes a reference suite's source with its ``repro.``
imports turned into ``repro_torch.`` (plus the few edits the suite names),
the port's default backend on ``TorchBackend(device="cpu")`` (the plain
versions of the kernels), and makes one test of each of its cases. A test runs the case on
the port with the fixtures pytest gives it. Where the case leaves a store
state behind (it retrieved a file or a tensor, or wrote a container), the
test then runs the same case on the reference, in a directory of its own,
and holds the port to it: the same sha256 for every retrieval, and the same
bytes in every container file.

Below the mirrored cases: the churn fault of the family-base registry, step
by step, and the hashes that gc and compaction must keep.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import re
import sys
import threading
import types
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from repro.core import pipeline as ref_pipeline
from repro_torch.core import bitx as port_bitx
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core.bitx import TorchBackend, get_backend
from repro_torch.formats import safetensors as st

TESTS = Path(__file__).resolve().parent
_REPRO = re.compile(r"\brepro\.(?=\w)")


class _Record:
    """What one run of a case leaves: a digest per retrieval."""

    current = None  # the run being recorded
    lock = threading.Lock()

    @classmethod
    def start(cls) -> Counter:
        cls.current = Counter()
        return cls.current

    @classmethod
    def note(cls, key, digest) -> None:
        with cls.lock:
            if cls.current is not None:
                cls.current[(key, digest)] += 1


def _recorded(key, call):
    try:
        out = call()
    except BaseException as e:
        _Record.note(key, type(e).__name__)
        raise
    data = out[0] if isinstance(out, tuple) else out
    _Record.note(key, hashlib.sha256(data).hexdigest())
    return out


def _recording(store_cls):
    """``store_cls`` recording its retrievals."""

    class Recording(store_cls):
        def retrieve_file(self, repo_id, filename, *args, **kw):
            return _recorded(("file", repo_id, filename),
                             lambda: super(Recording, self).retrieve_file(
                                 repo_id, filename, *args, **kw))

        def retrieve_tensor(self, repo_id, filename, tensor_name, *args, **kw):
            return _recorded(("tensor", repo_id, filename, tensor_name),
                             lambda: super(Recording, self).retrieve_tensor(
                                 repo_id, filename, tensor_name, *args, **kw))

    Recording.__name__ = Recording.__qualname__ = "ZLLMStore"
    return Recording


def _containers(root: Path) -> dict:
    """sha256 of every file under a ``containers`` directory below ``root``."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = p.relative_to(root)
        if "containers" in rel.parts and p.is_file():
            out[str(rel)] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def _load(suite: str, pkg: str, src: str) -> types.ModuleType:
    mod = types.ModuleType(f"{suite}__{pkg}")
    mod.__file__ = str(TESTS / f"{suite}.py")  # tracebacks show the reference's lines
    sys.modules[mod.__name__] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    if hasattr(mod, "ZLLMStore"):
        mod.ZLLMStore = _recording(mod.ZLLMStore)
    return mod


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    """The port's default backend (``"torch"``: the card) is its plain
    version on the CPU here, for every store, codec runtime and facade a
    case makes."""
    def on_the_cpu(spec="torch"):
        return TorchBackend(device="cpu") if spec == "torch" else get_backend(spec)
    for mod in (port_bitx, port_pipeline):
        monkeypatch.setattr(mod, "get_backend", on_the_cpu)


class Suite:
    """A reference suite loaded twice: as it is, and on the port."""

    def __init__(self, suite: str, edits=(), shared=(), skip=()):
        src = (TESTS / f"{suite}.py").read_text()
        port_src = _REPRO.sub("repro_torch.", src)
        for old, new in edits:
            assert old in port_src, f"{suite}: the edit of {old!r} no longer applies"
            port_src = port_src.replace(old, new)
        self.ref = _load(suite, "reference", src)
        self.port = _load(suite, "port", port_src)
        self.shared = set(shared)  # the suite's fixtures that make inputs, not stores
        self.cases = {name: fn for name, fn in vars(self.port).items()
                      if name.startswith("test_") and inspect.isfunction(fn)
                      and name not in skip}
        self.fixtures = {p for fn in self.cases.values()
                         for p in inspect.signature(fn).parameters if hasattr(self.port, p)}

    def tests(self) -> dict:
        """The cases as tests, and the suite's fixtures, for a module's globals."""
        out = {name: getattr(self.port, name) for name in self.fixtures}
        out["_port_on_the_cpu"] = _port_on_the_cpu
        out.update({name: self._paired(name, fn) for name, fn in self.cases.items()})
        return out

    def _paired(self, name, port_fn):
        params = list(inspect.signature(port_fn).parameters)

        def case(request, **kw):
            port_log = _Record.start()
            try:
                port_fn(**kw)
            finally:
                _Record.current = None
            port_log = (+port_log, _containers(request.getfixturevalue("tmp_path")))
            if any(port_log):  # the case left a store state: hold the port to the reference
                ref_log = self._run_reference(name, request, kw)
                assert port_log == ref_log, f"{name}: the port and the reference differ"

        case.__name__ = case.__qualname__ = name
        case.__doc__ = port_fn.__doc__
        case.__signature__ = inspect.Signature(
            [inspect.Parameter(p, inspect.Parameter.POSITIONAL_OR_KEYWORD)
             for p in ["request", *params]])
        case.pytestmark = list(getattr(port_fn, "pytestmark", []))
        return case

    def _run_reference(self, name, request, kw):
        tmp = request.getfixturevalue("tmp_path_factory").mktemp("reference")
        values = {"tmp_path": tmp}
        monkeypatch = pytest.MonkeyPatch()
        teardown = []

        def value(p):
            if p not in values:
                if p == "monkeypatch":
                    values[p] = monkeypatch
                elif p in self.fixtures and p not in self.shared:
                    fn = getattr(self.ref, p).__wrapped__
                    v = fn(**{q: value(q) for q in inspect.signature(fn).parameters})
                    if inspect.isgenerator(v):
                        teardown.append(v)
                        v = next(v)
                    values[p] = v
                else:  # an input both runs share: a corpus, a parameter
                    values[p] = kw[p] if p in kw else request.getfixturevalue(p)
            return values[p]

        log = _Record.start()
        try:
            fn = getattr(self.ref, name)
            fn(**{p: value(p) for p in inspect.signature(fn).parameters})
        finally:
            _Record.current = None
            for gen in reversed(teardown):
                next(gen, None)
            monkeypatch.undo()
        return +log, _containers(tmp)


globals().update(Suite("test_lifecycle").tests())


# ---------------------------------------------------------------------------
# The churn fault: a family base bound to a generation gc has retired
# ---------------------------------------------------------------------------

def _tensors(seed, n=3, elems=64):
    rng = np.random.RandomState(seed)
    return {f"t{i}": rng.randn(elems).astype(np.float32) for i in range(n)}


def _write(path, tensors):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    st.save_file(tensors, path)
    with open(path, "rb") as f:
        return f.read()


def _replay_trace(store_cls, hub, root, finetune=False):
    """Steps 1-5 of the fault: r0 takes A, r1 takes B, r0 takes B's exact
    bytes (a whole-file dedup that leaves r0 bound as a family base to A),
    gc retires A's generation, and r0 takes A again; or, with ``finetune``,
    r2 takes a fine-tune of A that declares r0 its base."""
    a, b = _tensors(1), _tensors(2)
    rng = np.random.RandomState(3)
    last = ({k: v + rng.randn(*v.shape).astype(np.float32) * 1e-3 for k, v in a.items()}
            if finetune else a)
    files = {"A": _write(os.path.join(hub, "a", "model.safetensors"), a),
             "B": _write(os.path.join(hub, "b", "model.safetensors"), b),
             "last": _write(os.path.join(hub, "last", "model.safetensors"), last)}
    p = os.path.join(hub, "b2", "model.safetensors")
    os.makedirs(os.path.dirname(p))
    with open(p, "wb") as f:
        f.write(files["B"])
    store = store_cls(root)
    r = store.ingest_file(os.path.join(hub, "a", "model.safetensors"), "r0")
    assert r.base_id is None and "r0" in store.base_paths
    store.ingest_file(os.path.join(hub, "b", "model.safetensors"), "r1")
    assert store.ingest_file(p, "r0").file_dedup_hit
    assert store.gc()["collected"] == 1
    a_hashes = [hashlib.sha256(v.tobytes()).hexdigest() for v in a.values()]
    # what the fault needs: gc scrubbed A's pins, the binding to A survived
    assert not any(h in store.tensor_locations for h in a_hashes)
    assert "r0" in store.base_paths
    rid = "r2" if finetune else "r0"
    res = store.ingest_file(os.path.join(hub, "last", "model.safetensors"), rid,
                            declared_base="r0" if finetune else None)
    return store, res, {"r0": files["B"], "r1": files["B"], rid: files["last"]}


def _resolved_records(store):
    """(hash, the record its pool entry names) for every pinned hash."""
    out = []
    for h, (k, g, i) in store.tensor_locations.items():
        with store._reader_ctx(store.lifecycle.version_path(k, g)) as reader:
            out.append((h, reader.records[i]))
    return out


def _port_store(root, **kw):
    return port_pipeline.ZLLMStore(root, backend=TorchBackend(device="cpu"), **kw)


@pytest.mark.parametrize("finetune", [False, True], ids=["reupload", "finetune"])
def test_upload_after_gc_never_codes_against_a_retired_base(finetune, tmp_path):
    """The stale binding is dropped at election: the upload goes in
    standalone and takes the binding itself. No record is its own base,
    every BitX base has a pool entry, and the store reloads fsck-clean."""
    store, res, files = _replay_trace(_port_store, str(tmp_path / "hub"),
                                      str(tmp_path / "store"), finetune)
    try:
        assert res.base_id is None and res.n_bitx == 0 and res.n_zipnn == 3
        assert store.base_key_of[res.repo_id] == f"{res.repo_id}/model.safetensors"
        for h, rec in _resolved_records(store):
            assert rec.self_hash == h and rec.base_hash != h
        assert all(h in store.tensor_locations for h in _named_hashes(store))
        for rid, data in files.items():
            assert store.retrieve_file(rid, "model.safetensors") == data
        store.save_index()
    finally:
        store.close()
    with _port_store(str(tmp_path / "store")) as s2:
        assert s2.load_index()
        assert s2.fsck(spot_check=None).ok
        for rid, data in files.items():
            assert s2.retrieve_file(rid, "model.safetensors") == data


@pytest.mark.parametrize("finetune,error", [(False, (RuntimeError, "tensor resolution cycle")),
                                            (True, (KeyError, None))],
                         ids=["reupload", "finetune"])
def test_reference_codes_the_upload_against_its_retired_base(finetune, error, tmp_path):
    """The same steps on the reference: the upload is BitX-coded against the
    stale base, and retrieval meets the cycle (A again: every tensor is its
    own base) or a base hash with no pool entry (the fine-tune)."""
    store, res, _ = _replay_trace(ref_pipeline.ZLLMStore, str(tmp_path / "hub"),
                                  str(tmp_path / "store"), finetune)
    try:
        assert res.base_id == "r0" and res.n_bitx == 3
        store._tensor_cache.clear()
        with pytest.raises(error[0], match=error[1]):
            store.retrieve_file(res.repo_id, "model.safetensors")
    finally:
        store.close()


def _finetune_of(tensors, seed):
    rng = np.random.RandomState(seed)
    return {k: v + rng.randn(*v.shape).astype(np.float32) * 1e-3 for k, v in tensors.items()}


def test_stale_bindings_leave_the_family_lane_to_live_bases(tmp_path):
    """The ratio after the fine-tune trace: r0's repo and key bindings both
    named A and both go, so a fine-tune of r0's current bytes (B, one element
    of each tensor changed) that declares r0 is matched by bit distance to
    B's own base, r1; once r0 takes new standalone content it is bound again
    and a fine-tune declaring it is BitX-coded against it."""
    hub = str(tmp_path / "hub")
    store, res, files = _replay_trace(_port_store, hub, str(tmp_path / "store"), True)
    try:
        assert "r0" not in store.base_paths and "r0/model.safetensors" not in store.base_paths
        near_b = {k: np.concatenate([v[:1] + 1, v[1:]]) for k, v in _tensors(2).items()}
        files["r3"] = _write(os.path.join(hub, "ftb", "model.safetensors"), near_b)
        r = store.ingest_file(os.path.join(hub, "ftb", "model.safetensors"), "r3",
                              declared_base="r0")
        assert (r.base_id, r.base_source, r.n_bitx) == ("r1", "bitdistance", 3)
        c = _tensors(5)
        files["r0"] = _write(os.path.join(hub, "c", "model.safetensors"), c)
        assert store.ingest_file(os.path.join(hub, "c", "model.safetensors"), "r0").base_id is None
        files["r4"] = _write(os.path.join(hub, "ftc", "model.safetensors"), _finetune_of(c, 6))
        r = store.ingest_file(os.path.join(hub, "ftc", "model.safetensors"), "r4",
                              declared_base="r0")
        assert (r.base_id, r.base_source, r.n_bitx) == ("r0", "declared", 3)
        for rid, data in files.items():
            assert store.retrieve_file(rid, "model.safetensors") == data
        assert store.fsck(spot_check=None).ok
    finally:
        store.close()


def _retired_first_base(store_cls, hub, root):
    """r0 takes A, then new standalone content A2 (its key's binding moves to
    A2, its repo binding stays on A, the first standalone file), gc retires
    A's generation, and r1 takes a fine-tune of A2 that declares r0."""
    a, a2 = _tensors(1), _tensors(7)
    files = {"r0": _write(os.path.join(hub, "a2", "model.safetensors"), a2),
             "r1": _write(os.path.join(hub, "ft", "model.safetensors"), _finetune_of(a2, 8))}
    _write(os.path.join(hub, "a", "model.safetensors"), a)
    store = store_cls(root)
    store.ingest_file(os.path.join(hub, "a", "model.safetensors"), "r0")
    assert store.ingest_file(os.path.join(hub, "a2", "model.safetensors"), "r0").base_id is None
    assert store.base_paths["r0"] != store.base_paths["r0/model.safetensors"]
    assert store.gc()["collected"] == 1
    res = store.ingest_file(os.path.join(hub, "ft", "model.safetensors"), "r1",
                            declared_base="r0")
    return store, res, files


def test_repo_whose_first_base_was_retired_takes_its_keys_live_binding(tmp_path):
    """The fine-tune keeps its BitX lane: r0's repo binding is stale, so it
    takes its key's binding (A2, live) and the fine-tune is coded against A2;
    every file retrieves, also after a reload, and fsck is clean."""
    store, res, files = _retired_first_base(_port_store, str(tmp_path / "hub"),
                                            str(tmp_path / "store"))
    try:
        assert (res.base_id, res.base_source, res.n_bitx) == ("r0", "declared", 3)
        assert store.base_paths["r0"] == store.base_paths["r0/model.safetensors"]
        assert all(h in store.tensor_locations for h in _named_hashes(store))
        for rid, data in files.items():
            assert store.retrieve_file(rid, "model.safetensors") == data
        store.save_index()
    finally:
        store.close()
    with _port_store(str(tmp_path / "store")) as s2:
        assert s2.load_index()
        assert s2.fsck(spot_check=None).ok
        for rid, data in files.items():
            assert s2.retrieve_file(rid, "model.safetensors") == data


def test_reference_codes_the_fine_tune_against_the_retired_first_base(tmp_path):
    """The same steps on the reference: the fine-tune is BitX-coded against
    A, whose hashes gc scrubbed, and its retrieval fails."""
    store, res, _ = _retired_first_base(ref_pipeline.ZLLMStore, str(tmp_path / "hub"),
                                        str(tmp_path / "store"))
    try:
        assert (res.base_id, res.n_bitx) == ("r0", 3)
        store._tensor_cache.clear()
        with pytest.raises(KeyError):
            store.retrieve_file("r1", "model.safetensors")
    finally:
        store.close()


def _named_hashes(store):
    """Every hash a live container's record names as its dedup target or
    BitX base."""
    out = []
    for v in store.lifecycle.versions.values():
        with store._reader_ctx(v.path) as reader:
            for rec in reader.records:
                if rec.codec == "dedup":
                    out.append(rec.self_hash)
                elif rec.codec in ("bitx", "bitxq") and rec.base_hash:
                    out.append(rec.base_hash)
    return out


def test_gc_and_compact_keep_every_hash_a_live_record_names(tmp_path):
    """A fine-tune BitX-coded against a base that is then re-registered, a
    dedup chain of re-registrations, a deleted repo: after gc and after
    compact, every dedup target and BitX base a live record names still has
    its pool entry, and every file still retrieves."""
    hub = tmp_path / "hub"
    base = _tensors(10, n=6, elems=512)
    rng = np.random.RandomState(11)
    files = {"org/b": _write(str(hub / "b0" / "model.safetensors"), base),
             "u/ft": _write(str(hub / "ft" / "model.safetensors"),
                            {k: v + rng.randn(512).astype(np.float32) * 1e-3
                             for k, v in base.items()}),
             "org/gone": _write(str(hub / "gone" / "model.safetensors"), _tensors(12))}
    store = _port_store(str(tmp_path / "store"))
    try:
        store.ingest_file(str(hub / "b0" / "model.safetensors"), "org/b")
        assert store.ingest_file(str(hub / "ft" / "model.safetensors"), "u/ft",
                                 declared_base="org/b").n_bitx == 6
        store.ingest_file(str(hub / "gone" / "model.safetensors"), "org/gone")
        cur = dict(base)
        for r in range(2):  # re-register org/b, a third of it fresh each time
            for i in range(r, 6, 3):
                cur[f"t{i}"] = np.random.RandomState(20 + 10 * r + i).randn(
                    512).astype(np.float32)
            files["org/b"] = _write(str(hub / f"b{r + 1}" / "model.safetensors"), cur)
            assert store.ingest_file(str(hub / f"b{r + 1}" / "model.safetensors"),
                                     "org/b").n_dedup > 0
        store.delete_repo("org/gone")
        del files["org/gone"]
        assert store.gc()["collected"] == 1
        for sweep in ("gc", "compact"):
            if sweep == "compact":
                assert store.compact()["moved_records"] > 0
            named = _named_hashes(store)
            assert named and all(h in store.tensor_locations for h in named), sweep
            for rid, data in files.items():
                assert store.retrieve_file(rid, "model.safetensors") == data
        assert store.fsck(spot_check=None).ok
    finally:
        store.close()
