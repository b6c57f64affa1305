"""The four storage kernels of the port on the card, byte for byte against
their plain PyTorch versions, plus the device store path.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the decision is made inside the ``cuda``
fixture, so every worker collects the same tests).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.bitx import NumpyBackend, TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo
from repro_torch.kernels import _build, bitx_xor, byte_planes, ref

pytestmark = pytest.mark.gpu

WIDTHS = [1, 2, 4, 8]
LENGTHS = [0, 1, 1023, 1025, 4096 + 3, (1 << 20) + 3]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _build.library()  # build once; a failed build fails the tests
    return torch.device("cuda")


def _rand_bytes(n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("nb", WIDTHS)
@pytest.mark.parametrize("n", LENGTHS)
def test_kernels_match_plain_versions(cuda, nb, n):
    a, b = _rand_bytes(n * nb, 1, cuda), _rand_bytes(n * nb, 2, cuda)
    planes = _rand_bytes(n * nb, 3, cuda).view(nb, n)
    before = _build.launch_counts()
    got = {
        "xor_split": bitx_xor.xor_split(a, b, nb),
        "merge_xor": bitx_xor.merge_xor(planes, a),
        "split": byte_planes.split(a, nb),
        "merge": byte_planes.merge(planes),
    }
    torch.cuda.synchronize()
    want = {
        "xor_split": ref.xor_split_planes(a, b, nb),
        "merge_xor": ref.merge_planes_xor(planes, a),
        "split": ref.byte_split(a, nb),
        "merge": ref.byte_merge(planes),
    }
    after = _build.launch_counts()
    for name in got:
        assert got[name].device.type == "cuda"
        assert torch.equal(got[name], want[name]), name
        # one launch per call; an empty buffer launches nothing
        assert after[name] - before[name] == (1 if n else 0), name
    # and the numpy host path agrees: plane i is byte column nb-1-i
    xor = np.bitwise_xor(a.cpu().numpy(), b.cpu().numpy()).reshape(-1, nb)
    for i in range(nb):
        assert (got["xor_split"][i].cpu().numpy() == xor[:, nb - 1 - i]).all()


def test_roundtrip_on_card(cuda):
    base, ft = _rand_bytes(4 << 20, 4, cuda), _rand_bytes(4 << 20, 5, cuda)
    for nb in WIDTHS:
        assert torch.equal(bitx_xor.merge_xor(bitx_xor.xor_split(base, ft, nb), base), ft)
        assert torch.equal(byte_planes.merge(byte_planes.split(ft, nb)), ft)


def test_wrappers_reject_misaligned_and_mixed_devices(cuda):
    buf = _rand_bytes(4 * 1024 + 1, 6, cuda)
    with pytest.raises(ValueError):
        byte_planes.split(buf[1:], 4)  # not aligned to 4-byte words
    with pytest.raises(ValueError):
        bitx_xor.xor_split(buf[:4096], buf[:4096].cpu(), 4)


def test_torch_backend_on_card_matches_numpy(cuda):
    dev, host = TorchBackend(), NumpyBackend()
    rng = np.random.default_rng(7)
    xs = [rng.random(s).astype(d) for d in ("float32", "float16", "float64")
          for s in [(1,), (37, 5), (1025,)]]
    xs.append(rng.integers(-128, 127, 999, dtype=np.int8))
    pairs = [(x.reshape(-1), (x.reshape(-1)[::-1]).copy()) for x in xs]
    for got, (b, f) in zip(dev.xor_delta_planes_batch(pairs), pairs):
        assert all((g == w).all() for g, w in zip(got, host.xor_delta_planes(b, f)))
    deltas = [host.xor_delta_planes(b, f) for b, f in pairs]
    for got, d, (b, f) in zip(dev.merge_planes_xor_batch(list(zip(deltas, [p[0] for p in pairs]))),
                              deltas, pairs):
        want = host.merge_planes_xor(d, b)
        assert got.dtype == want.dtype and (got == want).all()
    for got, x in zip(dev.byte_planes_batch(xs), xs):
        assert all((g == w).all() for g, w in zip(got, host.byte_planes(x)))
    merged = dev.merge_planes_batch([(host.byte_planes(x), x.dtype, x.shape) for x in xs])
    for got, x in zip(merged, xs):
        assert got.dtype == x.dtype and got.shape == x.shape and (got == x).all()
    c = dev.counters()
    # one launch per width bucket and op: widths 4, 2, 8, 1
    assert c["kernel_calls"] == {"xor_split": 4, "merge_xor": 4, "split": 4, "merge": 4}
    assert c["h2d_bytes"] > 0 and c["d2h_bytes"] > 0 and c["kernel_ms"] > 0


def test_device_store_matches_numpy_store(cuda, tmp_path):
    root = str(tmp_path / "hub")
    spec = CorpusSpec(n_layers=2, d_model=64, d_ff=128, vocab=256, n_heads=4, n_kv_heads=2,
                      qkv_bias=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = make_base_tensors(spec, gen)
    write_repo(root, "org/base", base)
    write_repo(root, "u/ft-a", make_finetune(base, spec, gen), base_model="org/base")
    write_repo(root, "u/ft-b", make_finetune(base, spec, gen, sigma_delta=0.001))
    repos = ["org/base", "u/ft-a", "u/ft-b"]
    blobs = {}
    for name, backend in (("numpy", "numpy"), ("torch", TorchBackend())):
        store = ZLLMStore(str(tmp_path / name), workers=4, backend=backend)
        for rid in repos:
            store.ingest_repo(os.path.join(root, rid), rid)
        for rid in repos:
            orig = open(os.path.join(root, rid, "model.safetensors"), "rb").read()
            assert store.retrieve_file(rid, "model.safetensors") == orig
        store.close()
        croot = tmp_path / name / "containers"
        blobs[name] = {str(p.relative_to(croot)): p.read_bytes()
                       for p in croot.rglob("*") if p.is_file()}
    assert blobs["numpy"] and blobs["numpy"] == blobs["torch"]
