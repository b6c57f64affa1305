"""The port stands alone: no JAX, nothing of the reference package, no
hidden fallback from the card to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import bitdistance, bitx, pipeline
from repro_torch.kernels import _build, bitx_xor, byte_planes, hamming

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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
        for p in PORT_FILES if p.name != "chip_smoke.py")
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
    assert "repro_torch.core.pipeline" in modules


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
