"""The port's checkpoint manager and trainer (``repro_torch.checkpoint``,
``repro_torch.train.trainer``, ``python -m repro_torch.launch.train``)
against the JAX package's, on the CPU (stores on
``TorchBackend(device="cpu")``, the plain versions of the kernels).

* The files are byte-identical to the reference manager's for the same
  params and AdamW / Adafactor state, and each package restores the other's,
  from the plain file and from a compressed-only store.
* ``save_async`` snapshots before it returns: mutating the params afterwards
  leaves the file unchanged.
* The reference's trainer cases (``tests/test_substrate.py:159-283``):
  crash-resume through the store, elastic restore into another global batch,
  restore from compressed-only checkpoints, serving cold start from a
  training run; and the launcher's crash (exit 42) and resume.
"""

import os
import subprocess
import sys
import tempfile
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core.pipeline import ZLLMStore as JaxStore
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.bitx import TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.formats import safetensors as st
from repro_torch.models import api
from repro_torch.optim.optimizers import AdamW, OptimizerConfig, make_optimizer
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.trainer import FailureInjector, SimulatedFailure, TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
CPU = TorchBackend(device="cpu")


def _store(root):
    return ZLLMStore(str(root), backend=CPU)


def _to_torch_tree(tree):
    """A JAX tree of dicts as torch CPU tensors (bf16 bits kept)."""
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    return api.params_from_reference({"x": np.asarray(tree)}, "cpu")["x"]


def _bits(x) -> tuple:
    """(shape, raw bytes) of a torch tensor or a (JAX / ml_dtypes) array."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.shape, x.reshape(-1).view(np.uint8)


def _same_tree(a, b, path=""):
    if isinstance(a, dict) or isinstance(b, dict):
        assert sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
        return
    (sa, ba), (sb, bb) = _bits(a), _bits(b)
    assert sa == sb, (path, sa, sb)
    np.testing.assert_array_equal(ba, bb, err_msg=path)


@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def state(request):
    """(JAX params, JAX opt state, port params, port opt state) after one
    optimizer step of the qwen2-7b smoke config (bf16 params, float32 state)."""
    cfg = jax_get_config("qwen2-7b", smoke=True)
    jp = japi.init_params(cfg, jax.random.PRNGKey(0))
    jo = jopt.make_optimizer(jopt.OptimizerConfig(name=request.param, factored_min_dim=16,
                                                  warmup_steps=0))
    rng = np.random.default_rng(1)
    g = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)).astype(v.dtype)
         for k, v in jp.items()}
    jp, js = jo.update(g, jo.init(jp), jp)
    return request.param, jp, js, _to_torch_tree(jp), _to_torch_tree(js)


def test_files_are_byte_identical_to_the_reference(state, tmp_path):
    name, jp, js, tp, ts = state
    jpath = JaxManager(str(tmp_path / "jax"), run_id="r").save(7, jp, js)
    tpath = CheckpointManager(str(tmp_path / "port"), run_id="r").save(7, tp, ts)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    infos, meta, _ = st.read_header(tpath)
    tags = {ti.name: ti.dtype_str for ti in infos}
    assert tags["params/embed"] == "BF16" and tags["opt/step"] == "I32"
    assert [ti.shape for ti in infos if ti.name == "opt/step"] == [()]
    assert meta["step"] == "7" and meta["run_id"] == "r"
    if name == "adafactor":
        assert any(n.startswith("opt/vr/") for n in tags) and any(n.startswith("opt/v/") for n in tags)


@pytest.mark.parametrize("compressed", [False, True], ids=["plain", "compressed-only"])
def test_each_package_restores_the_others_checkpoint(state, tmp_path, compressed):
    name, jp, js, tp, ts = state
    template = make_optimizer(OptimizerConfig(name=name, factored_min_dim=16)).state_templates(
        api.get_model(get_config("qwen2-7b", smoke=True)).param_templates())
    # the port writes, the reference reads
    pstore = _store(tmp_path / "a" / "store") if compressed else None
    CheckpointManager(str(tmp_path / "a" / "run"), store=pstore, run_id="r",
                      keep_plain=not compressed).save(3, tp, ts)
    jstore = None
    if compressed:
        pstore.save_index()
        pstore.close()
        assert not any(f.endswith(".safetensors") for f in os.listdir(tmp_path / "a" / "run"))
        jstore = JaxStore(str(tmp_path / "a" / "store"), backend="numpy")
        assert jstore.load_index()
    step, gp, go = JaxManager(str(tmp_path / "a" / "run"), store=jstore, run_id="r").restore(
        opt_template=js)
    assert step == 3
    _same_tree(gp, jp)
    _same_tree(go, js)
    # the reference writes, the port reads
    jstore = JaxStore(str(tmp_path / "b" / "store"), backend="numpy") if compressed else None
    JaxManager(str(tmp_path / "b" / "run"), store=jstore, run_id="r",
               keep_plain=not compressed).save(4, jp, js)
    pstore = None
    if compressed:
        jstore.save_index()
        pstore = _store(tmp_path / "b" / "store")
        assert pstore.load_index()
    step, gp, go = CheckpointManager(str(tmp_path / "b" / "run"), store=pstore,
                                     run_id="r").restore(opt_template=template)
    assert step == 4
    assert all(gp[k].dtype == tp[k].dtype for k in tp)
    _same_tree(gp, jp)
    _same_tree(go, js)
    assert go["step"].dtype == torch.int32 and go["step"].shape == ()


def test_save_stream_writes_each_payload_before_drawing_the_next(tmp_path):
    # a mesh checkpoint is gathered one tensor at a time: the writer must
    # have let go of each payload before it asks for the next one
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.integers(0, 2 ** 16, (7,), dtype=np.uint16),
              "c": np.array(4, dtype=np.int32), "d": np.zeros((2, 0, 3), np.float16)}
    tags = {"b": "BF16"}
    st.save_file(arrays, tmp_path / "whole.safetensors", metadata={"step": "1"}, dtype_tags=tags)
    live = []

    def payloads():
        for a in arrays.values():
            assert all(r() is None for r in live), "an earlier payload is still held"
            a = a.copy()
            live.append(weakref.ref(a))
            yield a

    entries = [(k, tags.get(k) or st.DTYPE_TO_STR[a.dtype.name], a.shape)
               for k, a in arrays.items()]
    st.save_stream(entries, payloads(), tmp_path / "stream.safetensors", metadata={"step": "1"})
    assert len(live) == len(arrays)
    assert (tmp_path / "stream.safetensors").read_bytes() == \
        (tmp_path / "whole.safetensors").read_bytes()
    with pytest.raises(ValueError):
        st.save_stream(entries, iter(list(arrays.values())[:2]), tmp_path / "short.safetensors")
    assert not list(tmp_path.glob("short.safetensors*"))


def test_save_async_snapshots_before_it_returns(tmp_path):
    """The optimizer writes the parameters in place: a write-behind save must
    hold a copy, even on the CPU, where ``.cpu()`` is the tensor itself."""
    cfg = get_config("qwen2-7b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    want = {k: v.clone() for k, v in params.items()}
    opt = AdamW(OptimizerConfig())
    ostate = opt.init(params)
    mgr = CheckpointManager(str(tmp_path / "run"), store=_store(tmp_path / "store"), run_id="r")
    mgr.save_async(1, params, ostate)
    for v in params.values():
        v.add_(1.0)
    ostate["step"].add_(5)
    mgr.wait()
    step, got, gopt = mgr.restore(opt_template=opt.state_templates(
        api.get_model(cfg).param_templates()))
    assert step == 1 and int(gopt["step"]) == 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_restore_into_the_template_dtypes_and_onto_a_device(tmp_path):
    cfg = get_config("falcon-mamba-7b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(1))
    opt = AdamW(OptimizerConfig())
    mgr = CheckpointManager(str(tmp_path / "run"), run_id="r")
    mgr.save(2, params, opt.init(params))
    tmpl = opt.state_templates(api.get_model(cfg).param_templates())
    step, got, gopt = mgr.restore_sharded("cpu", opt_template=tmpl)
    assert step == 2 and got.keys() == params.keys()
    for k, v in params.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k  # f32 A_log/D stay f32
    assert set(gopt) == {"m", "v", "step"} and gopt["m"].keys() == params.keys()
    assert CheckpointManager(str(tmp_path / "empty")).restore() == (None, None, None)
    with pytest.raises(FileNotFoundError):
        os.remove(mgr.ckpt_path(2))
        mgr.restore()


# ---------------------------------------------------------------------------
# Trainer fault tolerance (tests/test_substrate.py:159-283)
# ---------------------------------------------------------------------------

def test_trainer_crash_resume_and_store(tmp_path):
    cfg = TrainConfig(arch=get_config("qwen2-7b", smoke=True), seq_len=16,
                      global_batch=4, steps=8, ckpt_every=3,
                      run_dir=str(tmp_path / "run"), async_checkpoint=False, device="cpu")
    store = _store(tmp_path / "store")
    t1 = Trainer(cfg, store=store, run_id="r", failure=FailureInjector(fail_at_step=5))
    with pytest.raises(SimulatedFailure):
        t1.run()
    t2 = Trainer(cfg, store=store, run_id="r")
    assert t2.resumed_from == 3                     # latest committed checkpoint
    h = t2.run()
    assert h[-1]["step"] == 8
    # deterministic data: resumed steps see the same batches the crashed run did
    assert [r["loss"] for r in h[:2]] == [r["loss"] for r in t1.history[3:5]]
    assert t2.ckpt.latest_step() == 8
    # checkpoints chain through zLLM with a declared base
    chained = [r for r in store.results if r.base_source == "declared"]
    assert chained and all(r.n_bitx > 0 for r in chained)


def test_trainer_elastic_restore_smaller_run(tmp_path):
    """Checkpoint written by one trainer restores into a fresh config."""
    arch = get_config("qwen2-7b", smoke=True)
    c1 = TrainConfig(arch=arch, seq_len=16, global_batch=4, steps=4, ckpt_every=2,
                     run_dir=str(tmp_path / "runA"), async_checkpoint=False, device="cpu")
    Trainer(c1, run_id="a").run()
    # new trainer, same run dir, different global batch (elastic data parallel)
    c2 = TrainConfig(arch=arch, seq_len=16, global_batch=8, steps=6, ckpt_every=2,
                     run_dir=str(tmp_path / "runA"), async_checkpoint=False, device="cpu")
    t2 = Trainer(c2, run_id="a")
    assert t2.resumed_from == 4
    h = t2.run()
    assert h[-1]["step"] == 6 and np.isfinite(h[-1]["loss"])


def test_checkpoint_restore_from_compressed_only(tmp_path):
    """keep_plain=False: restore reconstructs from BitX containers."""
    arch = get_config("falcon-mamba-7b", smoke=True)
    store = _store(tmp_path / "store")
    cfg = TrainConfig(arch=arch, seq_len=16, global_batch=2, steps=4, ckpt_every=2,
                      run_dir=str(tmp_path / "run"), async_checkpoint=False,
                      keep_plain_ckpt=False, device="cpu")
    t1 = Trainer(cfg, store=store, run_id="m")
    t1.run()
    assert not any(f.endswith(".safetensors") for f in os.listdir(cfg.run_dir))
    t2 = Trainer(cfg, store=store, run_id="m")
    assert t2.resumed_from == 4
    for k, v in t1.params.items():
        assert torch.equal(t2.params[k], v), k
    for k, v in t1.opt_state["m"].items():
        assert torch.equal(t2.opt_state["m"][k], v), k


def test_async_trainer_matches_the_synchronous_one(tmp_path):
    arch = get_config("qwen2-7b", smoke=True)
    runs = {}
    for mode in (False, True):
        cfg = TrainConfig(arch=arch, seq_len=16, global_batch=2, steps=4, ckpt_every=2,
                          run_dir=str(tmp_path / f"run{mode}"), async_checkpoint=mode,
                          device="cpu")
        t = Trainer(cfg, run_id="s")
        t.run()
        runs[mode] = [open(t.ckpt.ckpt_path(s), "rb").read() for s in (2, 4)]
    assert runs[False] == runs[True]


def test_trainer_refuses_a_mesh_and_a_missing_card(tmp_path, monkeypatch):
    # a mesh of two devices needs a process group of two ranks (the launcher
    # starts one; tests/test_torch_launch.py trains on one): alone, it is refused
    arch = get_config("qwen2-7b", smoke=True)
    with pytest.raises((RuntimeError, ValueError), match="2 ranks"):
        Trainer(TrainConfig(arch=arch, mesh_shape=(2, 1), run_dir=str(tmp_path), device="cpu"))
    Trainer(TrainConfig(arch=arch, mesh_shape=(1, 1), run_dir=str(tmp_path / "one"),
                        device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Trainer(TrainConfig(arch=arch, run_dir=str(tmp_path / "cuda")))


def test_serve_cold_start_from_store(tmp_path):
    arch = get_config("qwen2-7b", smoke=True)
    store = _store(tmp_path / "store")
    cfg = TrainConfig(arch=arch, seq_len=16, global_batch=2, steps=2, ckpt_every=2,
                      run_dir=str(tmp_path / "run"), async_checkpoint=False, device="cpu")
    t = Trainer(cfg, store=store, run_id="serve-run")
    t.run()
    eng = ServeEngine.from_store(store, "serve-run", "checkpoint-00000002.safetensors", arch,
                                 device="cpu")
    res = eng.generate(np.array([[1, 2, 3]], np.int32), n_new=2)
    assert res.tokens.shape == (1, 5)
    # the served params equal the trained ones bit-for-bit
    for k, v in t.params.items():
        assert torch.equal(eng.params[k], v), k


def _cli(tmp_path, *extra, run_dir=True, **env):
    args = ["--arch", "qwen2-7b", "--smoke", "--steps", "8", "--ckpt-every", "3", "--seq", "16",
            "--global-batch", "4", "--store", str(tmp_path / "store"),
            *(["--run-dir", str(tmp_path / "run")] if run_dir else []), "--fail-at", "5", *extra]
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=300, cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src"), **env))


def test_launcher_crashes_then_resumes_to_the_end(tmp_path):
    """The reference's fault-tolerance demo through the port's CLI: exit 42
    at the injected crash, then the same command resumes from step 3 and ends
    at step 8, its later checkpoints BitX-chained to the first in the store;
    a third run of the same command finds step 8 done and trains 0 steps."""
    first = _cli(tmp_path, "--device", "cpu")
    assert first.returncode == 42, first.stderr
    assert "injected failure at step 5" in first.stdout
    second = _cli(tmp_path, "--device", "cpu")
    assert second.returncode == 0, second.stderr
    out = second.stdout
    assert "[train] device cpu" in out and "resumed from step 3" in out
    assert "[train] done: 5 steps" in out
    chained = [ln for ln in out.splitlines() if ln.startswith("[train] checkpoint ")]
    assert len(chained) == 2 and all("(declared)" in ln and " 0 BitX" not in ln for ln in chained)
    step, params, opt = CheckpointManager(str(tmp_path / "run"), run_id="qwen2-7b-smoke-run") \
        .restore(opt_template=AdamW(OptimizerConfig()).state_templates(
            api.get_model(get_config("qwen2-7b", smoke=True)).param_templates()))
    assert step == 8 and int(opt["step"]) == 8
    third = _cli(tmp_path, "--device", "cpu")
    assert third.returncode == 0, third.stderr
    assert "resumed from step 8" in third.stdout and "[train] done: 0 steps" in third.stdout


def test_launcher_without_a_run_dir_starts_fresh_under_tmpdir(tmp_path):
    """Without --run-dir every run gets a new directory under TMPDIR: a second
    run of the same command does not resume the first one's checkpoints."""
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    runs = [_cli(tmp_path, "--device", "cpu", "--steps", "2", "--ckpt-every", "1",
                 "--store", str(tmp_path / f"store{i}"), run_dir=False, TMPDIR=str(tmpdir))
            for i in range(2)]
    dirs = []
    for proc in runs:
        assert proc.returncode == 0, proc.stderr
        assert "resumed" not in proc.stdout and "[train] done: 2 steps" in proc.stdout
        dirs.append(proc.stdout.split(" run dir ", 1)[1].split()[0])
    assert dirs[0] != dirs[1] and all(os.path.dirname(d) == str(tmpdir) for d in dirs)
    assert all(sorted(os.listdir(d)) == ["checkpoint-00000001.safetensors",
                                         "checkpoint-00000002.safetensors", "manifest.json"]
               for d in dirs)


def test_train_config_defaults_to_a_fresh_run_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    arch = get_config("qwen2-7b", smoke=True)
    a, b = TrainConfig(arch=arch), TrainConfig(arch=arch)
    assert a.run_dir != b.run_dir
    assert all(os.path.dirname(d) == str(tmp_path) and not os.listdir(d)
               for d in (a.run_dir, b.run_dir))


def test_launcher_without_a_card_refuses(tmp_path):
    proc = _cli(tmp_path, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr, proc.stderr
    assert not (tmp_path / "run").exists()
