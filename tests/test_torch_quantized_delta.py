"""The port's counterpart of tests/test_quantized_delta.py: the bitxq
dtype-crossing lane of ``repro_torch.core`` and the store's quantized repos
on ``TorchBackend(device="cpu")``, each store case held to the reference's
retrievals and containers (see ``test_torch_lifecycle.Suite``). The numpy
store is held to a torch store (in the directory named ``jax``) where the
reference holds it to a jax one.
The corpus comes from the reference's generator, as the reference suite's
does; both runs of a case read the same corpus."""

from test_torch_lifecycle import Suite

globals().update(Suite("test_quantized_delta", shared={"qcorpus"}, edits=[
    ("from repro_torch.core.bitx import JaxBackend, TensorRecord",
     "from repro_torch.core.bitx import TensorRecord"),
    ("@pytest.mark.skipif(not JaxBackend.available(), reason=\"jax not installed\")",
     "@pytest.mark.skipif(False, reason=\"the torch backend is the port's own\")"),
    ("s = ZLLMStore(str(tmp_path / backend), backend=backend)",
     "s = ZLLMStore(str(tmp_path / backend), backend=backend.replace(\"jax\", \"torch\"))"),
]).tests())
