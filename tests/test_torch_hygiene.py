"""The port stands alone: no JAX, nothing of the reference package, no
hidden fallback from the card to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import bitdistance, bitx, pipeline
from repro_torch.kernels import _build, bitx_xor, byte_planes, hamming
from repro_torch.models import api
from repro_torch.serve import engine

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "torch_quickstart.py",
    REPO / "examples" / "torch_hub_simulation.py",
    REPO / "examples" / "torch_serve_from_compressed.py",
    REPO / "examples" / "torch_train_with_zllm_checkpoints.py"]
BANNED = {"jax", "jaxlib", "repro", "benchmarks", "ml_dtypes"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = sorted(set(_imported_roots(path)) & BANNED)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port, and chip_smoke, import in a process where
    ``jax`` and ``repro`` cannot be imported."""
    modules = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.is_relative_to(REPO / "src"))
    code = ("import sys\n"
            "for m in ('jax', 'repro', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    for m in ("repro_torch.core.pipeline", "repro_torch.models.transformer",
              "repro_torch.serve.engine", "repro_torch.kernels.flash_attention",
              "repro_torch.configs.qwen2_7b", "repro_torch.sharding.rules",
              "repro_torch.core.chunkdedup", "repro_torch.serve.singleflight",
              "repro_torch.serve.router", "repro_torch.serve.peer",
              "repro_torch.serve.store_server", "repro_torch.optim.optimizers",
              "repro_torch.train.step", "repro_torch.train.trainer",
              "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
              "repro_torch.checkpoint.straggler", "repro_torch.launch.train"):
        assert m in modules, m


def test_no_card_means_no_store(monkeypatch, tmp_path):
    """Without a card the default backend and a default store raise: the
    port never carries on on the CPU unless asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bitx.TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.ZLLMStore(str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bitx.get_backend("torch")
    # asked for explicitly, the CPU path is there
    assert bitx.TorchBackend(device="cpu").device.type == "cpu"


def test_no_card_means_no_server(tmp_path):
    """``python -m repro_torch.serve.store_server`` with no visible card exits
    non-zero with ``TorchBackend``'s error: it never serves from the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.store_server", "--root",
         str(tmp_path / "store"), "--port", "0"],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "TorchBackend(device='cuda') needs a CUDA device" in proc.stderr, proc.stderr
    assert "serving" not in proc.stdout, proc.stdout


def test_no_card_means_no_calibration(monkeypatch):
    """The Monte-Carlo calibration runs on the card by default; without one it
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bitdistance.expected_bit_distance_mc(0.02, 0.001)
    with pytest.raises(RuntimeError, match="CUDA"):
        bitdistance.calibration_heatmap(n=10)
    with pytest.raises(ValueError):
        bitdistance.expected_bit_distance_mc(0.02, 0.001, n=10, device="meta")
    assert bitdistance.expected_bit_distance_mc(0.02, 0.001, n=10, device="cpu") >= 0.0


@pytest.mark.parametrize("spec", ["jax", "auto", "pallas"])
def test_get_backend_rejects_reference_names(spec):
    with pytest.raises(ValueError, match="torch"):
        bitx.get_backend(spec)


def test_get_backend_resolution():
    assert bitx.get_backend("numpy").name == "numpy"
    tb = bitx.TorchBackend(device="cpu")
    assert bitx.get_backend(tb) is tb
    with pytest.raises(ValueError):
        bitx.TorchBackend(device="meta")


def test_build_module_imports_without_nvcc_and_never_falls_back(tmp_path):
    """``_build`` imports with no nvcc on PATH and no CUDA toolkit; asking it
    for the library then raises instead of handing out the plain versions."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
            "from repro_torch.kernels import _build\n"
            f"_build.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
            "try:\n"
            "    _build.library()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n"
            "else:\n"
            "    print('built')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "no-cuda"))
    env.pop("CUDA_PATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised: nvcc not found"), proc.stdout


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    x = torch.arange(16, dtype=torch.uint8)
    before = _build.launch_counts()
    assert torch.equal(byte_planes.merge(byte_planes.split(x, 4)), x)
    assert torch.equal(bitx_xor.merge_xor(bitx_xor.xor_split(x, x.flip(0), 2), x), x.flip(0))
    assert bitx_xor.xor(x, x, 4).count_nonzero() == 0
    assert hamming.hamming_total(x, x.flip(0), 8) > 0
    assert _build.launch_counts() == before
    with pytest.raises(ValueError):
        byte_planes.split(torch.empty(16, dtype=torch.uint8, device="meta"), 4)
    with pytest.raises(ValueError):
        hamming.hamming_total(torch.empty(16, dtype=torch.uint8, device="meta"),
                              torch.empty(16, dtype=torch.uint8, device="meta"), 4)
    with pytest.raises(TypeError):
        byte_planes.split(torch.zeros(4, dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        byte_planes.split(torch.zeros(6, dtype=torch.uint8), 4)  # not whole words
    with pytest.raises(ValueError):
        byte_planes.split(torch.zeros(8, dtype=torch.uint8), 3)  # no such width


def test_launch_counters_reset():
    _build.reset_launch_counts()
    assert _build.launch_counts() == {k: 0 for k in _build.KERNELS}
    assert set(_build.KERNELS) == {"xor_split", "merge_xor", "split", "merge", "xor", "hamming",
                                   "flash_attention"}


def test_no_card_means_no_engine(monkeypatch):
    """Without a card the serving engine and its cold start raise, before
    touching the store; ``device="cpu"`` works when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-7b", smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.ServeEngine(cfg, params)

    class NoStore:
        def retrieve_file(self, *a, **k):
            raise AssertionError("the store was read before the device check")

    with pytest.raises(RuntimeError, match="CUDA"):
        engine.ServeEngine.from_store(NoStore(), "org/m", "model.safetensors", cfg)
    with pytest.raises(ValueError):
        engine.ServeEngine(cfg, params, device="meta")
    eng = engine.ServeEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu" and eng.params["embed"].device.type == "cpu"


def test_flash_on_cuda_without_a_card_raises(tmp_path):
    """A CUDA tensor reaching the flash wrapper on a machine without nvcc and
    a card raises (the build fails); it is never handed to the plain path.
    Fake CUDA tensors stand in for real ones."""
    code = ("import sys, warnings\n"
            f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
            "warnings.simplefilter('ignore')\n"
            "import torch\n"
            "from torch._subclasses.fake_tensor import FakeTensorMode\n"
            "from repro_torch.kernels import _build, flash_attention\n"
            f"_build.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
            "with FakeTensorMode():\n"
            "    q = torch.empty((1, 8, 2, 16), device='cuda')\n"
            "    try:\n"
            "        flash_attention.flash_attention(q, q, q)\n"
            "    except RuntimeError as e:\n"
            "        print('raised:', e)\n"
            "    else:\n"
            "        print('ran')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent")
    env.pop("CUDA_PATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised: nvcc not found"), proc.stdout


def test_off_the_mesh_nothing_imports_dtensor():
    # the first import of torch.distributed.tensor takes seconds: serving off
    # the mesh (every family's prefill and decode) must not pay for it on its
    # first request (a fresh interpreter: other tests import it here; a
    # differentiated loss imports it anyway, through torch.utils.checkpoint)
    script = """
import sys, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine
for arch in ("falcon-mamba-7b", "zamba2-2.7b", "whisper-medium", "mixtral-8x7b"):
    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = api.make_batch(cfg, ShapeCell("p", "prefill", 16, 2),
                           torch.Generator().manual_seed(1), device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", attn="plain")
    eng.generate(batch["tokens"].numpy(), 2,
                 {"frames": batch["frames"]} if "frames" in batch else None)
print("torch.distributed.tensor" in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == "False"
