import os
import sys

# the dry-run forces 512 host devices in its own subprocesses; tests must see
# the default single CPU device
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
# tests import sibling helpers (_hypothesis_compat) without a package prefix
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def corpus_dir(tmp_path_factory):
    """Small synthetic hub corpus shared across tests."""
    from benchmarks.corpus import CorpusSpec, make_corpus
    root = str(tmp_path_factory.mktemp("hub"))
    # quantized_per_family=1 puts one int8 repack per family in the shared
    # corpus, so every store-level suite (persistence, parallel determinism,
    # backend equivalence) exercises the bitxq dtype-crossing lane for free
    spec = CorpusSpec(n_families=2, finetunes_per_family=2, lora_per_family=1,
                      vocab_expanded_per_family=1, checkpoints_per_family=1,
                      quantized_per_family=1,
                      n_layers=2, d_model=64, d_ff=128, vocab=256, seed=7)
    manifest = make_corpus(root, spec)
    return root, manifest
