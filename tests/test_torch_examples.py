"""The port's examples run end to end at their tiny size on the CPU
(``--device cpu``: the plain versions of the kernels), and refuse to run
without a card otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart.py": ("all files reconstruct bit-exactly", "ingest job done",
                            "equal to the direct read", "'device': 'cpu'"),
    "torch_hub_simulation.py": ("every file reconstructs bit-exactly", "final: zLLM saves",
                                "2 exact re-uploads", "device: cpu"),
    "torch_serve_from_compressed.py": ("params bit-equal to the source", "batched serving done",
                                       "equal to the in-process reconstruction",
                                       "store kernels: {'xor_split': 1"),
    "torch_train_with_zllm_checkpoints.py": ("resumed from step 6", "finished at step 12",
                                             "bitx=42", "bit-equal to the trained ones: True",
                                             "device: cpu"),
}
# arguments of an example besides ``--device cpu`` (its tiny size)
ARGS = {"torch_train_with_zllm_checkpoints.py": ("--tiny", "--steps", "12"),
        "torch_hub_simulation.py": ("--families", "2", "--per-family", "3")}


def _run(name, *args, **env):
    return subprocess.run([sys.executable, str(REPO / "examples" / name), *args],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **env), cwd=str(REPO))


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    proc = _run(name, "--device", "cpu", *ARGS.get(name, ()))
    assert proc.returncode == 0, proc.stderr
    for line in EXAMPLES[name]:
        assert line in proc.stdout, proc.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_refuses(name):
    proc = _run(name, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "needs a CUDA device" in proc.stderr, proc.stderr
