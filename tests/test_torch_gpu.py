"""The kernels of the port on the card against their plain PyTorch versions
(the six storage kernels byte for byte, the bit counts exactly; both routes of
flash attention within the reference's tolerances, each call asserting the
route it took), the device store path, the bit-distance calibration, the
serving engine, the HTTP store server, one optimizer step against the CPU's
and the trainer with its checkpoints on the card.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the decision is made inside the ``cuda``
fixture, so every worker collects the same tests).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import bitdistance
from repro_torch.core.bitx import NumpyBackend, TorchBackend
from repro_torch.core.pipeline import ZLLMStore
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo
from repro_torch.configs import get_config
from repro_torch.kernels import _build, bitx_xor, byte_planes, flash_attention, hamming, ops, ref
from repro_torch.models.api import init_params
from repro_torch.serve.engine import RequestBatcher, ServeEngine

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


@pytest.mark.parametrize("nb", WIDTHS)
@pytest.mark.parametrize("n", LENGTHS)
def test_bit_distance_kernels_match_plain_versions(cuda, nb, n):
    a, b = _rand_bytes(n * nb, 8, cuda), _rand_bytes(n * nb, 9, cuda)
    before = _build.launch_counts()
    xor = bitx_xor.xor(a, b, nb)
    partials = hamming.hamming_partials(a, b, nb)
    total = hamming.hamming_total(a, b, nb)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert xor.device.type == "cuda" and torch.equal(xor, ref.xor_words(a, b))
    # one 64-bit partial per block of the grid every launcher uses
    assert partials.device.type == "cuda" and partials.dtype == torch.int64
    assert partials.numel() == min(-(-n // 256), 132 * 16)
    want = ref.hamming_total(a, b, nb)
    assert total == int(partials.sum()) == want
    assert want == int(np.unpackbits(np.bitwise_xor(a.cpu().numpy(), b.cpu().numpy())).sum())
    assert after["xor"] - before["xor"] == (1 if n else 0)
    assert after["hamming"] - before["hamming"] == (2 if n else 0)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (15, 15, 15), (1, 0, 0), (0, 3, 7),
                                     (5, 5, 2)])
def test_xor_is_exact_on_misaligned_and_odd_lengths(cuda, n, offsets):
    """The word XOR streams bytes: 16-byte vectors where a, b and out share
    their offset from a 16-byte boundary (scalar head and tail), single bytes
    where they do not. Every byte equals the plain version's."""
    oa, ob, oo = offsets
    a, b = _rand_bytes(n + 16, 12, cuda), _rand_bytes(n + 16, 13, cuda)
    x, y = a[oa:oa + n], b[ob:ob + n]
    want = ref.xor_words(x, y)
    before = _build.launch_counts()["xor"]
    assert torch.equal(bitx_xor.xor(x, y, 1), want)  # into a new, aligned buffer
    out = torch.zeros(n + 32, dtype=torch.uint8, device=cuda)
    _build.launch("xor", x, y, out[oo:oo + n], n=n, nb=1)  # into one at offset oo
    torch.cuda.synchronize()
    assert torch.equal(out[oo:oo + n], want)
    assert not out[:oo].any() and not out[oo + n:].any()  # nothing written outside
    assert _build.launch_counts()["xor"] - before == 2


def test_hamming_total_past_two_to_the_32(cuda):
    """Two independent random buffers of 1.1 GB differ in about 4.4e9 bits:
    no stage of the count may keep 32 bits."""
    n = 550_000_000  # 2-byte words
    gen = torch.Generator(device="cuda").manual_seed(10)
    a = torch.randint(0, 256, (2 * n,), dtype=torch.uint8, device="cuda", generator=gen)
    b = torch.randint(0, 256, (2 * n,), dtype=torch.uint8, device="cuda", generator=gen)
    got = hamming.hamming_total(a, b, 2)
    assert got > 2**32
    assert got == ref.hamming_total(a, b, 2)
    assert got == int(np.bitwise_count(np.bitwise_xor(a.cpu().numpy().view(np.uint64),
                                                      b.cpu().numpy().view(np.uint64)))
                      .sum(dtype=np.uint64))


def test_bit_distance_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((257, 129)).astype(np.float32) * 0.02)
    y = x + torch.from_numpy(rng.standard_normal((257, 129)).astype(np.float32) * 0.001)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        xc, yc = x.to(dt), y.to(dt)
        assert ops.hamming_total(xc.cuda(), yc.cuda()) == ops.hamming_total(xc, yc) > 0
        assert ops.bit_distance(xc.cuda(), yc.cuda()) == ops.bit_distance(xc, yc)


def test_calibration_on_card(cuda):
    """The calibration's default device is the card, and its estimates pass
    the band checks of tests/test_core_storage.py:163-168."""
    before = _build.launch_counts()["hamming"]
    lo = bitdistance.expected_bit_distance_mc(0.05, 0.0005, n=20_000)
    hi = bitdistance.expected_bit_distance_mc(0.015, 0.02, n=20_000)
    assert 0.5 <= lo <= 6.0 and 2.5 <= hi <= 7.0
    res = bitdistance.calibration_heatmap(n=20_000)
    assert res.heatmap.shape == (6, 6) and np.isfinite(res.heatmap).all()
    assert 1.0 <= res.within_family_range[0] <= res.within_family_range[1] <= 7.0
    assert _build.launch_counts()["hamming"] - before == 2 + 36


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


FLASH_CASES = [
    # (B, Sq, Sk, H, D, causal, window): tests/test_flash_kernel.py:12-19 first
    (2, 256, 256, 4, 128, True, 0),
    (1, 512, 512, 2, 128, False, 0),
    (2, 256, 256, 4, 128, True, 64),
    (1, 1024, 1024, 1, 128, True, 0),
    (1, 256, 256, 2, 256, True, 0),
    # ragged lengths, every head dim, bidirectional windows, Sq != Sk and rows
    # whose keys are all masked (they average v uniformly)
    (2, 33, 33, 3, 16, True, 0),
    (1, 1000, 1000, 2, 128, True, 0),
    (2, 100, 100, 2, 32, False, 0),
    (1, 300, 300, 4, 64, False, 64),
    (1, 70, 200, 2, 64, False, 0),
    (1, 128, 16, 2, 32, False, 8),
    # the sm90 route in bf16 (D 64 and 128): ragged lengths, Sq != Sk causal
    # and not, a window over ragged tiles, fully masked rows at D 64
    (2, 77, 77, 3, 128, True, 0),
    (1, 300, 170, 2, 64, True, 0),
    (1, 170, 300, 2, 128, False, 0),
    (1, 260, 260, 2, 64, True, 64),
    (1, 128, 16, 2, 64, False, 8),
    # the serving path's prefills: Qwen2-7B's 28 heads of dim 128, batches of
    # 4 left-padded to 2032 (not a multiple of either tile) and to 512 tokens
    (4, 2032, 2032, 28, 128, True, 0),
    (4, 512, 512, 28, 128, True, 0),
    # head dim 80 (zamba2-2.7b's shared attention; the simt route in both
    # dtypes): ragged, Sq != Sk, a window, and the family phase's prefill
    (2, 333, 333, 4, 80, True, 0),
    (1, 64, 300, 2, 80, False, 0),
    (1, 200, 200, 2, 80, True, 64),
    (4, 1024, 1024, 32, 80, True, 0),
    # whisper-medium's three attentions at head dim 64: the encoder (1500
    # frames, bidirectional), the decoder's causal self attention, and cross
    # attention from 64 decoder tokens to the 1500 frames
    (4, 1500, 1500, 16, 64, False, 0),
    (4, 64, 64, 16, 64, True, 0),
    (4, 64, 1500, 16, 64, False, 0),
]


def _qkv(shape_q, shape_k, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in (shape_q, shape_k, shape_k)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain_version(cuda, case, dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, Sq, Sk, H, D, causal, window = case
    q, k, v = _qkv((B, Sq, H, D), (B, Sk, H, D), dtype, 20, cuda)
    # contiguous new tensors: bf16 at D 64/128 takes the tensor cores
    route = "sm90" if dtype == torch.bfloat16 and D in (64, 128) else "simt"
    assert flash_attention.route(q, k, v) == route
    before = _build.launch_counts()["flash_attention"]
    by_route = flash_attention.route_launches()
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention"] - before == 1
    after = flash_attention.route_launches()
    assert {r: after[r] - by_route[r] for r in after} == {r: int(r == route) for r in after}
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    tol = 2e-5 if dtype == torch.float32 else 2e-2  # tests/test_flash_kernel.py:33
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_reads_strided_operands(cuda):
    """q, k and v sliced out of one fused (B, S, 3H, D) projection: the kernel
    reads them through their strides."""
    B, S, H, D = 2, 130, 4, 64
    qkv = torch.randn((B, S, 3 * H, D), generator=torch.Generator(device="cuda").manual_seed(21),
                      device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    assert not q.is_contiguous()
    assert flash_attention.route(q, k, v) == "sm90"  # TMA reads the slices in place
    got = flash_attention.flash_attention(q, k, v, causal=True)
    want = ref.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_misaligned_slice_takes_simt(cuda, D):
    """A bf16 operand 2 bytes off a 16-byte boundary is one no tensor map can
    address: the call takes the SIMT kernel and is still right."""
    B, S, H = 2, 130, 4
    buf = torch.randn((B, S, H, D + 8), generator=torch.Generator(device="cuda").manual_seed(22),
                      device=cuda).to(torch.bfloat16)
    q = buf[..., 1:1 + D]
    k, v = (torch.randn((B, S, H, D), device=cuda).to(torch.bfloat16) for _ in range(2))
    assert q.data_ptr() % 16 == 2 and flash_attention.route(q, k, v) == "simt"
    before = flash_attention.route_launches()
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.route_launches()["simt"] - before["simt"] == 1
    want = ref.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_route_rules_by_head_dim(cuda):
    """bf16 at D 64 and 128 takes sm90; D 80 and the other head dims, and
    float32 at any, take simt; both launch and match the plain version."""
    for D in flash_attention.HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _qkv((1, 70, 2, D), (1, 70, 2, D), dt, D, cuda)
            want = "sm90" if dt == torch.bfloat16 and D in flash_attention.SM90_HEAD_DIMS else "simt"
            assert flash_attention.route(q, k, v) == want
            before = flash_attention.route_launches()[want]
            got = flash_attention.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            assert flash_attention.route_launches()[want] == before + 1
            tol = 2e-5 if dt == torch.float32 else 2e-2
            torch.testing.assert_close(got.float(), ref.mha_reference(q, k, v).float(),
                                       rtol=tol, atol=tol)


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention.flash_attention(q, q, q)


def test_serve_engine_on_card(cuda):
    """The qwen2-7b smoke config in bf16 on the card: prefill goes through the
    flash kernel once per layer and agrees with the plain engine; decode
    launches no flash kernel."""
    cfg = get_config("qwen2-7b", smoke=True)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4))
    flash = ServeEngine(cfg, params, device="cuda")
    plain = ServeEngine(cfg, params, device="cuda", attn="plain")
    prompts = np.random.default_rng(5).integers(1, cfg.vocab, (4, 40)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    lf, _ = flash.model.prefill(flash.params, batch)
    lp, _ = plain.model.prefill(plain.params, batch)
    # bf16 activations rounded at other points in the two attentions
    torch.testing.assert_close(lf, lp, rtol=0.05, atol=0.05)
    _build.reset_launch_counts()
    flash_attention.reset_route_launches()
    batcher = RequestBatcher(flash, batch_size=4, n_new=5)
    ids = [batcher.submit(p[: 10 + 7 * i]) for i, p in enumerate(prompts)]
    assert sorted(batcher.run_once()) == ids
    assert _build.launch_counts()["flash_attention"] == cfg.n_layers
    # the smoke config's head dim is 16: every call takes the SIMT kernel
    assert cfg.hd == 16
    assert flash_attention.route_launches() == {"sm90": 0, "simt": cfg.n_layers}
    for rid in ids:
        out = batcher.result(rid)
        assert out.shape == (5,) and ((0 <= out) & (out < cfg.vocab)).all()


def test_server_on_card(cuda, tmp_path):
    """The HTTP hub over a store on the card: a PUT of a fine-tune and the
    ranged GETs (file, BitX tensor, ZipNN base tensor) are bit-exact, and
    ``/stats`` shows the launches on ``cuda:0``."""
    import http.client
    import json

    from repro_torch.serve.store_server import ServerThread

    root = str(tmp_path / "hub")
    spec = CorpusSpec(n_layers=2, d_model=256, d_ff=512, vocab=1024, n_heads=4, n_kv_heads=2,
                      qkv_bias=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    base = make_base_tensors(spec, gen)
    write_repo(root, "org/base", base)
    write_repo(root, "u/ft", make_finetune(base, spec, gen), base_model="org/base")
    store = ZLLMStore(str(tmp_path / "store"), workers=2)
    assert str(store.backend.device) == "cuda:0"
    store.ingest_repo(os.path.join(root, "org/base"), "org/base")
    src = open(os.path.join(root, "u/ft", "model.safetensors"), "rb").read()
    base_src = open(os.path.join(root, "org/base", "model.safetensors"), "rb").read()
    store.backend.reset_counters()
    try:
        with ServerThread(store, max_concurrency=4) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=120)

            def get(path, rng=None):
                conn.request("GET", path, headers={"Range": rng} if rng else {})
                r = conn.getresponse()
                return r.status, dict(r.getheaders()), r.read()

            conn.request("PUT", "/repo/u/ft/file/model.safetensors?base=org/base&sync=1",
                         body=src)
            r = conn.getresponse()
            job = json.loads(r.read())["job"]
            assert r.status == 200 and job["state"] == "done", job
            assert job["results"][0]["n_bitx"] > 0
            status, _, body = get("/repo/u/ft/file/model.safetensors")
            assert status == 200 and body == src
            status, _, body = get("/repo/u/ft/file/model.safetensors", "bytes=1000-99999")
            assert status == 206 and body == src[1000:100000]
            for repo, name in (("u/ft", "model.layers.0.self_attn.q_proj.weight"),
                               ("u/ft", "model.embed_tokens.weight"),
                               ("org/base", "model.layers.1.mlp.up_proj.weight")):
                direct, _ = store.retrieve_tensor(repo, "model.safetensors", name)
                status, h, body = get(f"/repo/{repo}/tensor/{name}", "bytes=64-8191")
                assert status == 206 and body == direct[64:8192], (repo, name)
            # the tensors are the source file's bytes
            status, _, body = get("/repo/org/base/file/model.safetensors", "bytes=0-65535")
            assert status == 206 and body == base_src[:65536]
            status, _, stats = get("/stats")
            counters = json.loads(stats)["store"]["backend_counters"]
            conn.close()
    finally:
        store.close()
    assert counters["device"] == "cuda:0"
    calls = counters["kernel_calls"]
    assert calls["xor_split"] > 0 and calls["merge_xor"] > 0 and calls["merge"] > 0, calls
    assert counters["h2d_bytes"] > 0 and counters["d2h_bytes"] > 0


@pytest.mark.parametrize("name,kw", [("adamw", {}), ("adafactor", {"factored_min_dim": 4})])
def test_optimizer_step_on_card_matches_cpu(cuda, name, kw):
    """One update on the card equals the CPU's within 1e-6 of each tensor's
    scale (float32; the card may divide by a scalar through its reciprocal)."""
    from repro_torch.optim.optimizers import OptimizerConfig, make_optimizer

    rng = np.random.default_rng(7)
    shapes = {"w": (64, 32), "stack": (2, 16, 8), "norm": (32,)}
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    opt = make_optimizer(OptimizerConfig(name=name, lr=1e-2, warmup_steps=0, **kw))
    pc = {k: v.clone() for k, v in p.items()}
    pg = {k: v.to(cuda) for k, v in p.items()}
    pc, sc = opt.update(g, opt.init(pc), pc)
    pg, sg = opt.update({k: v.to(cuda) for k, v in g.items()}, opt.init(pg), pg)
    assert int(sg["step"]) == 1 and sg["step"].device.type == "cuda"
    for k in shapes:
        want = pc[k]
        assert float((pg[k].cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max()), k


def test_trainer_on_card_with_store(cuda, tmp_path):
    """The smoke config trained on the card with a store on the card:
    compressed-only checkpoints BitX-chained by the card's kernels, and a
    resumed trainer restores them bit-equal."""
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(arch=get_config("qwen2-7b", smoke=True), seq_len=32, global_batch=4,
                      microbatches=2, steps=4, ckpt_every=2, run_dir=str(tmp_path / "run"),
                      keep_plain_ckpt=False)
    store = ZLLMStore(str(tmp_path / "store"))
    assert str(store.backend.device) == "cuda:0"
    _build.reset_launch_counts()
    t1 = Trainer(cfg, store=store, run_id="r")
    assert t1.device.type == "cuda" and t1.params["embed"].device.type == "cuda"
    h = t1.run()
    assert [r["step"] for r in h] == [1, 2, 3, 4] and all(np.isfinite(r["loss"]) for r in h)
    assert store.results[0].n_zipnn > 0
    assert store.results[1].base_source == "declared" and store.results[1].n_bitx > 0
    t2 = Trainer(cfg, store=store, run_id="r")
    assert t2.resumed_from == 4
    for k, v in t1.params.items():
        assert t2.params[k].device.type == "cuda" and torch.equal(t2.params[k], v), k
    launches = _build.launch_counts()
    assert launches["split"] > 0 and launches["xor_split"] > 0 and launches["merge_xor"] > 0, \
        launches
    store.close()
