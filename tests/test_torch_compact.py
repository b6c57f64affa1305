"""The port's counterpart of tests/test_compact.py: its cases on the port's
store (``TorchBackend(device="cpu")``), each held to the reference's
retrievals and containers (see ``test_torch_lifecycle.Suite``), and the
churn property with real ``hypothesis``.

The reference's churn property draws 10 fresh examples a run and fails
whenever one reaches the family-base fault: a re-upload BitX-coded against
its own retired base (``ROADMAP.md`` §3). The port repairs it, so its
property runs 200 examples drawn the same way every run, plus the shrunk
sequences that reach the fault, which the reference still fails.
"""

import shutil
import tempfile

import pytest
from hypothesis import example, given, settings, strategies as stt

from test_torch_lifecycle import Suite

_SUITE = Suite("test_compact", skip={"test_property_random_churn_matches_shadow_oracle"})
globals().update(_SUITE.tests())

# shrunk from failing hypothesis runs: each re-uploads a file after gc or
# compaction retired the generation its family-base binding was primed from
FAULT_SEQUENCES = (
    [0, 1, 8, 112, 0],
    [0, 0, 1, 8, 112, 0],
    [0, 0, 1, 8, 116, 0],
    [0, 0, 74, 115570, 160, 74],
    [0, 0, 362811, 3, 112, 362811],
    [0, 0, 688394, 938982, 68, 688394],
)


@pytest.mark.parametrize("ops", FAULT_SEQUENCES, ids=str)
def test_fault_sequence_keeps_every_file_on_the_port(ops, tmp_path):
    _SUITE.port._churn(ops, str(tmp_path))


def test_reference_still_raises_the_cycle_on_the_fault_sequences(tmp_path):
    """A fact about the reference, recorded: its store meets the resolution
    cycle on every shrunk sequence."""
    for n, ops in enumerate(FAULT_SEQUENCES):
        with pytest.raises(RuntimeError, match="tensor resolution cycle"):
            _SUITE.ref._churn(ops, str(tmp_path / str(n)))


def _with_examples(test):
    for ops in FAULT_SEQUENCES:
        test = example(ops)(test)
    return test


@settings(deadline=None, max_examples=200, derandomize=True, database=None)
@given(stt.lists(stt.integers(0, 2 ** 20), min_size=6, max_size=24))
@_with_examples
def test_property_random_churn_matches_shadow_oracle(ops):
    root = tempfile.mkdtemp(prefix="zllm-torch-churn-")
    try:
        _SUITE.port._churn(ops, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
