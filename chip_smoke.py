#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the zLLM store on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: require CUDA, print ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/planes.cu`` with nvcc;
3. kernels: each of the four kernels against its plain PyTorch version on the
   card, byte for byte, at word widths 1/2/4/8 and awkward lengths, then at the
   main path's largest shape (the Qwen2-7B embedding, 152064 x 3584 bf16),
   timed with CUDA events beside its memory bound;
4. store: the port's ``ZLLMStore`` (default torch backend, on the card)
   ingests one dense family at Qwen2-7B's published widths, depth cut from 28
   decoder layers to 2 (full-vocabulary embedding and lm_head kept) — a base
   (ZipNN lane), a fine-tune declaring its base (BitX lane), a fine-tune
   matched by bit distance and an exact re-upload (file dedup) — and
   retrieves every file, sha256-checked against its source; the kernel launch
   counts of this run show that the path went through all four kernels;
5. byte identity: a one-layer family (no embeddings) ingested by a CUDA store
   and a numpy store of the port writes byte-identical containers.

The last two lines are the kernels line (one JSON object) and the result line
``{"ok": true, "device": {...}}``. Model files and stores go to a temporary
directory outside the repository, removed at the end.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import hashlib  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402
from repro_torch.kernels import _build, bitx_xor, byte_planes, ref  # noqa: E402

DEVICE = "cuda"
SEED = 0  # every weight and input of the run is drawn from generators seeded from it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate (used for every bound below)

# Qwen2-7B's published widths (src/repro/configs/qwen2_7b.py:5-12)
QWEN2_7B = dict(d_model=3584, d_ff=18944, vocab=152064, n_heads=28, n_kv_heads=4, qkv_bias=True)
QWEN2_7B_LAYERS = 28
SMOKE_LAYERS = 2

KERNELS = {
    # name: (TPU kernel it replaces, bytes moved per word of nb bytes)
    "xor_split": ("src/repro/kernels/bitx_xor.py:98", 3),
    "merge_xor": ("src/repro/kernels/bitx_xor.py:124", 3),
    "split": ("src/repro/kernels/byte_planes.py:50", 2),
    "merge": ("src/repro/kernels/byte_planes.py:75", 2),
}
SOURCE = "src/repro_torch/kernels/csrc/planes.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(8 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after a
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(nb: int, n: int, gen: torch.Generator):
    """(kernel call, plain call) per kernel on random words of width nb."""
    rb = lambda size: torch.randint(0, 256, (size,), dtype=torch.uint8, device=DEVICE,
                                    generator=gen)
    a, b, planes = rb(n * nb), rb(n * nb), rb(n * nb).view(nb, n)
    return {
        "xor_split": (lambda: bitx_xor.xor_split(a, b, nb), lambda: ref.xor_split_planes(a, b, nb)),
        "merge_xor": (lambda: bitx_xor.merge_xor(planes, a), lambda: ref.merge_planes_xor(planes, a)),
        "split": (lambda: byte_planes.split(a, nb), lambda: ref.byte_split(a, nb)),
        "merge": (lambda: byte_planes.merge(planes), lambda: ref.byte_merge(planes)),
    }


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
                             f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


def phase_kernels(gen: torch.Generator) -> dict:
    report = {k: {"max_abs_err": 0} for k in KERNELS}
    for nb in (1, 2, 4, 8):
        for n in (1, 1023, 1025, 2 ** 20 + 3):
            for name, (kern, plain) in kernel_cases(nb, n, gen).items():
                err = max_abs_err(kern(), plain())
                torch.cuda.synchronize()
                if err:
                    raise AssertionError(f"{name} nb={nb} n={n}: max_abs_err {err}")
    log("kernels: all 4 byte-equal to their plain versions at nb in {1,2,4,8}, "
        "n in {1, 1023, 1025, 2^20+3} (tolerance: exact)")

    # the main path's largest tensor: the Qwen2-7B embedding, 152064 x 3584 bf16
    V, d = QWEN2_7B["vocab"], QWEN2_7B["d_model"]
    w = (torch.randn((V, d), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
    ft = (w.float() + torch.randn((V, d), generator=gen, device=DEVICE) * 0.005).to(torch.bfloat16)
    base_b, ft_b = w.view(-1).view(torch.uint8), ft.view(-1).view(torch.uint8)
    del w, ft
    nb, n = 2, V * d
    planes = bitx_xor.xor_split(base_b, ft_b, nb)
    calls = {
        "xor_split": (lambda: bitx_xor.xor_split(base_b, ft_b, nb),
                      lambda: ref.xor_split_planes(base_b, ft_b, nb)),
        "merge_xor": (lambda: bitx_xor.merge_xor(planes, base_b),
                      lambda: ref.merge_planes_xor(planes, base_b)),
        "split": (lambda: byte_planes.split(ft_b, nb), lambda: ref.byte_split(ft_b, nb)),
        "merge": (lambda: byte_planes.merge(planes), lambda: ref.byte_merge(planes)),
    }
    if not torch.equal(bitx_xor.merge_xor(planes, base_b), ft_b):
        raise AssertionError("merge_xor(xor_split(base, ft), base) != ft at the embedding shape")
    for name, (kern, plain) in calls.items():
        err = max_abs_err(kern(), plain())
        if err:
            raise AssertionError(f"{name} at the embedding shape: max_abs_err {err}")
        r = report[name]
        r["ms"] = cuda_ms(kern)
        r["plain_ms"] = cuda_ms(plain)
        r["bound_ms"] = KERNELS[name][1] * n * nb / HBM_BYTES_PER_S * 1e3
        log(f"kernel {name}: {r['ms']:.4f} ms at {V}x{d} bf16 (bound {r['bound_ms']:.4f} ms "
            f"at 3.35 TB/s, {r['bound_ms'] / r['ms']:.1%} of it); plain version "
            f"{r['plain_ms']:.4f} ms; no single PyTorch call computes it (library: none)")
    del base_b, ft_b, planes
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 4: the store's ingest/retrieve path at Qwen2-7B width
# ---------------------------------------------------------------------------

def phase_store(tmp: str, seed: int) -> dict:
    """Drive the store; return the kernel launch counts of its run."""
    spec = CorpusSpec(n_layers=SMOKE_LAYERS, **QWEN2_7B)
    log(f"store: Qwen2-7B widths (d_model {spec.d_model}, d_ff {spec.d_ff}, {spec.n_heads} heads, "
        f"{spec.n_kv_heads} KV heads, k/v proj {spec.kv_dim}x{spec.d_model}, QKV bias, vocab "
        f"{spec.vocab}, bf16); depth cut from {QWEN2_7B_LAYERS} decoder layers to {SMOKE_LAYERS}, "
        f"full-vocabulary embed_tokens and lm_head kept")
    hub = os.path.join(tmp, "hub")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    base_id, ft_a, ft_b, reup = ("qwen/base", "alice/ft-declared", "bob/ft-undeclared",
                                 "mirror/ft-declared-reupload")
    base = make_base_tensors(spec, gen)
    n_params = sum(t.numel() for t in base.values())
    write_repo(hub, base_id, base)
    write_repo(hub, ft_a, make_finetune(base, spec, gen), base_model=base_id)
    # low-band delta so the undeclared fine-tune sits clearly under the
    # bit-distance threshold of 4
    write_repo(hub, ft_b, make_finetune(base, spec, gen, sigma_delta=0.001))
    shutil.copytree(os.path.join(hub, ft_a), os.path.join(hub, reup))
    del base
    torch.cuda.empty_cache()
    uploads = [base_id, ft_a, ft_b, reup]
    paths = {rid: os.path.join(hub, rid, "model.safetensors") for rid in uploads}
    raw = sum(os.path.getsize(p) for p in paths.values())
    log(f"store: wrote {len(uploads)} uploads of {n_params / 1e9:.3f} G params "
        f"({os.path.getsize(paths[base_id]) / 1e9:.3f} GB) each, {raw / 1e9:.3f} GB in all, "
        f"in {time.perf_counter() - t0:.1f} s")
    want_sha = {rid: sha256_file(p) for rid, p in paths.items()}

    store = ZLLMStore(os.path.join(tmp, "store"), workers=min(16, os.cpu_count() or 1),
                      entropy_procs=0)
    backend = store.backend
    if backend.name != "torch" or backend.device.type != DEVICE:
        raise AssertionError(f"default store backend is {backend.name} on {backend.device}")
    try:
        # the main path: counts from 0 just before, read just after
        _build.reset_launch_counts()
        backend.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = {rid: store.ingest_repo(os.path.join(hub, rid), rid)[0] for rid in uploads}
        t_ingest = time.perf_counter() - t0
        c_ingest = backend.counters()
        t0 = time.perf_counter()
        for rid in uploads:
            got = hashlib.sha256(store.retrieve_file(rid, "model.safetensors")).hexdigest()
            if got != want_sha[rid]:
                raise AssertionError(f"retrieved {rid} has sha256 {got}, source {want_sha[rid]}")
        t_retrieve = time.perf_counter() - t0
        launches = _build.launch_counts()
        c_all = backend.counters()
        peak = torch.cuda.max_memory_allocated()
        summary = store.summary()
    finally:
        store.close()

    r = results
    checks = {
        "base stored by the ZipNN lane": r[base_id].n_zipnn > 0,
        "declared fine-tune BitX-coded against the base":
            r[ft_a].base_source == "metadata" and r[ft_a].base_id == base_id and r[ft_a].n_bitx > 0,
        "undeclared fine-tune matched by bit distance":
            r[ft_b].base_source == "bitdistance" and r[ft_b].base_id == base_id and r[ft_b].n_bitx > 0,
        "re-upload is a file-dedup hit": r[reup].file_dedup_hit,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"store: {what} failed: {r}")
    log("store: " + "; ".join(checks) + "; every retrieved file matches its source sha256")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    c_ret = {k: c_all[k] - c_ingest[k] for k in ("kernel_ms", "copy_ms", "h2d_bytes", "d2h_bytes")}
    for label, wall, c in (("ingest", t_ingest, c_ingest), ("retrieve", t_retrieve, c_ret)):
        rest = wall * 1e3 - c["kernel_ms"] - c["copy_ms"]
        log(f"store {label}: {raw / wall / 1e6:.1f} MB/s ({raw / 1e9:.3f} GB in {wall:.2f} s); "
            f"kernels {c['kernel_ms']:.1f} ms, host<->device copies {c['copy_ms']:.1f} ms, "
            f"rest (hashing, entropy coding, I/O) {rest:.1f} ms; H2D {c['h2d_bytes']} B, "
            f"D2H {c['d2h_bytes']} B")
    log(f"store: reduction ratio {summary['reduction_ratio']} (stored/raw {summary['stored_bytes']}"
        f"/{summary['raw_bytes']}); kernel launches in the run {launches}; kernel calls per "
        f"backend {c_all['kernel_calls']}; peak device memory {peak / 2**30:.2f} GiB")
    return launches


# ---------------------------------------------------------------------------
# phase 5: CUDA store and numpy store write the same bytes
# ---------------------------------------------------------------------------

def container_bytes(store_root: str) -> dict:
    out = {}
    croot = os.path.join(store_root, "containers")
    for dirpath, _, files in os.walk(croot):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, croot)] = f.read()
    return out


def phase_identity(tmp: str, seed: int) -> None:
    spec = CorpusSpec(n_layers=1, **QWEN2_7B)
    hub = os.path.join(tmp, "hub1")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    base = make_base_tensors(spec, gen, embeddings=False)
    write_repo(hub, "qwen/base-1l", base)
    write_repo(hub, "alice/ft-1l", make_finetune(base, spec, gen), base_model="qwen/base-1l")
    del base
    workers = min(16, os.cpu_count() or 1)
    roots = {}
    for backend in ("torch", "numpy"):
        roots[backend] = os.path.join(tmp, f"store-{backend}")
        store = ZLLMStore(roots[backend], workers=workers, entropy_procs=0, backend=backend)
        try:
            for rid in ("qwen/base-1l", "alice/ft-1l"):
                store.ingest_repo(os.path.join(hub, rid), rid)
        finally:
            store.close()
    c_dev, c_np = container_bytes(roots["torch"]), container_bytes(roots["numpy"])
    if not c_dev or c_dev.keys() != c_np.keys():
        raise AssertionError(f"container sets differ: {sorted(c_dev)} vs {sorted(c_np)}")
    for name in c_dev:
        if c_dev[name] != c_np[name]:
            raise AssertionError(f"container {name} differs between the CUDA and numpy stores")
    log(f"identity: {len(c_dev)} containers byte-identical between the CUDA store and the "
        f"numpy store ({sum(map(len, c_dev.values()))} bytes)")


def main() -> int:
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # phase 2: build
    _build.library()
    log(f"build: {SOURCE} compiled and loaded in {_build.build_seconds():.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    report = phase_kernels(gen)
    tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-")
    try:
        launches = phase_store(tmp, SEED)
        shutil.rmtree(os.path.join(tmp, "hub"))
        shutil.rmtree(os.path.join(tmp, "store"))
        phase_identity(tmp, SEED)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (replaces, _) in KERNELS.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "matched": True, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "card": smi,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
