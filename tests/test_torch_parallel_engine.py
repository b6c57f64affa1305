"""The port's counterpart of tests/test_parallel_engine.py: the parallel and
pipelined ingest engine, its rollbacks, the base-map cache and the index
round trip on the port's store (``TorchBackend(device="cpu")``), each case
held to the reference's retrievals and containers (see
``test_torch_lifecycle.Suite``). The fresh process that reloads the index
opens its store on the CPU too."""

from test_torch_lifecycle import Suite

globals().update(Suite("test_parallel_engine", edits=[
    ('"from repro_torch.core.pipeline import ZLLMStore\\n"',
     '"from repro_torch.core.pipeline import ZLLMStore\\n"'
     ' "from repro_torch.core.bitx import TorchBackend\\n"'),
    ('f"s = ZLLMStore({store_root!r}, workers=2)\\n"',
     'f"s = ZLLMStore({store_root!r}, workers=2, backend=TorchBackend(device=\'cpu\'))\\n"'),
]).tests())
