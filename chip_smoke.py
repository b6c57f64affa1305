#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the zLLM store on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: require CUDA, print ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/planes.cu`` with nvcc;
3. kernels: each of the six kernels against its plain PyTorch version on the
   card, byte for byte (bit counts exactly), at word widths 1/2/4/8 and
   awkward lengths, then at the main path's largest shape (the Qwen2-7B
   embedding, 152064 x 3584 bf16), timed with CUDA events beside its memory
   bound and, where one PyTorch call computes the same function, that call;
   plus a hamming total past 2^32 bits, also checked with numpy;
4. store: the port's ``ZLLMStore`` (default torch backend, on the card)
   ingests one dense family at Qwen2-7B's published widths, depth cut from 28
   decoder layers to 2 (full-vocabulary embedding and lm_head kept) — a base
   (ZipNN lane), a fine-tune declaring its base (BitX lane), a fine-tune
   matched by bit distance and an exact re-upload (file dedup) — and
   retrieves every file, sha256-checked against its source; the kernel launch
   counts of this run show that the path went through all four kernels;
4b. bit distance, on the files phase 4 wrote: the full-scan bit distance
   (paper Eq. 1) of each fine-tune to the base, every tensor loaded to the
   card and counted by the hamming kernel, equal to the numpy host path tensor
   by tensor and file by file, beside the prefix distance the store's family
   matcher uses; two independent N(0, 0.02^2) bf16 embeddings lie above 4.5;
5. byte identity: a one-layer family (no embeddings) ingested by a CUDA store
   and a numpy store of the port writes byte-identical containers;
6. calibration: the Monte-Carlo heatmap of E[D(w, w+delta)] (paper Fig. 11,
   N = 100,000, the reference's 6x6 grid) on the card, with the reference
   tests' band checks. The hamming launches of phases 4b and 6 show that bit
   distance went through its kernel.

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.bitdistance import (bit_distance_files, calibration_heatmap,  # noqa: E402
                                          hamming_total_arrays, shape_signature)
from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402
from repro_torch.formats.safetensors import SafetensorsFile  # noqa: E402
from repro_torch.kernels import _build, bitx_xor, byte_planes, hamming, ops, ref  # noqa: E402

DEVICE = "cuda"
SEED = 0  # every weight and input of the run is drawn from generators seeded from it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate (used for every bound below)

# Qwen2-7B's published widths (src/repro/configs/qwen2_7b.py:5-12)
QWEN2_7B = dict(d_model=3584, d_ff=18944, vocab=152064, n_heads=28, n_kv_heads=4, qkv_bias=True)
QWEN2_7B_LAYERS = 28
SMOKE_LAYERS = 2

# the four uploads of phase 4: base, declared fine-tune, undeclared fine-tune, re-upload
UPLOADS = ("qwen/base", "alice/ft-declared", "bob/ft-undeclared", "mirror/ft-declared-reupload")
MATCH_SAMPLE = 65536  # elements per tensor the store's FamilyRegistry compares (its default)

NO_CALL = "none: no single PyTorch call computes it"
KERNELS = {
    # name: (TPU kernel it replaces, bytes moved per word of nb bytes,
    #        the one PyTorch call that computes the same function)
    "xor_split": ("src/repro/kernels/bitx_xor.py:98", 3, NO_CALL),
    "merge_xor": ("src/repro/kernels/bitx_xor.py:124", 3, NO_CALL),
    "split": ("src/repro/kernels/byte_planes.py:50", 2, NO_CALL),
    "merge": ("src/repro/kernels/byte_planes.py:75", 2, NO_CALL),
    "xor": ("src/repro/kernels/bitx_xor.py:74", 3, "torch.bitwise_xor"),
    "hamming": ("src/repro/kernels/hamming.py:36", 2, "none: PyTorch has no popcount"),
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
        "xor": (lambda: bitx_xor.xor(a, b, nb), lambda: ref.xor_words(a, b)),
        "hamming": (lambda: hamming.hamming_total(a, b, nb), lambda: ref.hamming_total(a, b, nb)),
    }


def max_abs_err(got, want) -> int:
    """Largest elementwise difference of two byte tensors, or the difference
    of two bit counts."""
    if isinstance(got, int) and isinstance(want, int):
        return abs(got - want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
                             f"{tuple(want.shape)}/{want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.int() - want.int()).abs().max())


def phase_kernels(gen: torch.Generator) -> dict:
    _build.reset_launch_counts()
    report = {k: {"max_abs_err": 0} for k in KERNELS}
    for nb in (1, 2, 4, 8):
        for n in (1, 1023, 1025, 2 ** 20 + 3):
            for name, (kern, plain) in kernel_cases(nb, n, gen).items():
                err = max_abs_err(kern(), plain())
                torch.cuda.synchronize()
                if err:
                    raise AssertionError(f"{name} nb={nb} n={n}: max_abs_err {err}")
    log(f"kernels: all {len(KERNELS)} equal to their plain versions at nb in {{1,2,4,8}}, "
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
        "xor": (lambda: bitx_xor.xor(base_b, ft_b, nb), lambda: ref.xor_words(base_b, ft_b)),
        "hamming": (lambda: hamming.hamming_total(base_b, ft_b, nb),
                    lambda: ref.hamming_total(base_b, ft_b, nb)),
    }
    # what is timed where it is not the whole call: the hamming kernel alone,
    # without the sum of its partials and the read-back
    timed = {"hamming": lambda: hamming.hamming_partials(base_b, ft_b, nb)}
    library = {"xor": lambda: torch.bitwise_xor(base_b, ft_b)}
    if not torch.equal(bitx_xor.merge_xor(planes, base_b), ft_b):
        raise AssertionError("merge_xor(xor_split(base, ft), base) != ft at the embedding shape")
    for name, (kern, plain) in calls.items():
        err = max_abs_err(kern(), plain())
        if err:
            raise AssertionError(f"{name} at the embedding shape: max_abs_err {err}")
        r = report[name]
        r["ms"] = cuda_ms(timed.get(name, kern))
        r["plain_ms"] = cuda_ms(plain)
        r["bound_ms"] = KERNELS[name][1] * n * nb / HBM_BYTES_PER_S * 1e3
        r["library_ms"] = cuda_ms(library[name]) if name in library else None
        lib = KERNELS[name][2] + (f" {r['library_ms']:.4f} ms" if name in library else "")
        log(f"kernel {name}: {r['ms']:.4f} ms at {V}x{d} bf16 (bound {r['bound_ms']:.4f} ms "
            f"at 3.35 TB/s, {r['bound_ms'] / r['ms']:.1%} of it); plain version "
            f"{r['plain_ms']:.4f} ms; library: {lib}")
    del base_b, ft_b, planes

    # a total past 2^32: two independent random buffers of the embedding's
    # size differ in about 4.36e9 bits
    a = torch.randint(0, 256, (n * nb,), dtype=torch.uint8, device=DEVICE, generator=gen)
    b = torch.randint(0, 256, (n * nb,), dtype=torch.uint8, device=DEVICE, generator=gen)
    got, plain = hamming.hamming_total(a, b, nb), ref.hamming_total(a, b, nb)
    host = int(np.bitwise_count(np.bitwise_xor(a.cpu().numpy().view(np.uint64),
                                               b.cpu().numpy().view(np.uint64))).sum(dtype=np.uint64))
    if not got == plain == host or got <= 2 ** 32:
        raise AssertionError(f"hamming past 2^32: kernel {got}, plain {plain}, numpy {host}")
    log(f"kernel hamming: {got} differing bits (> 2^32 = {2 ** 32}) between two random "
        f"{n * nb}-byte buffers, equal to the plain version and to numpy's bitwise_count")
    del a, b
    torch.cuda.empty_cache()
    report["xor"]["launches"] = _build.launch_counts()["xor"]
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
    base_id, ft_a, ft_b, reup = UPLOADS
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
    if any(launches[k] == 0 for k in TorchBackend.KERNELS):
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
# phase 4b: bit distance at Qwen2-7B width, on the files phase 4 wrote
# ---------------------------------------------------------------------------

_UINT = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32, 8: torch.uint64}


def to_card(v: np.ndarray) -> torch.Tensor:
    """A host bit view on the card, crossed as bytes."""
    return torch.from_numpy(v.reshape(-1).view(np.uint8).copy()).to(DEVICE).view(_UINT[v.itemsize])


def file_distance_on_card(path_a: str, path_b: str) -> tuple:
    """Full-scan bit distance of two files through ``ops.hamming_total``, each
    tensor's count required equal to the numpy host path's. Returns
    (distance, differing bits, elements)."""
    bits = elems = 0
    with SafetensorsFile(path_a) as fa, SafetensorsFile(path_b) as fb:
        if shape_signature(fa.infos) != shape_signature(fb.infos):
            raise AssertionError(f"{path_a} and {path_b} differ in shape")
        for ta, tb in zip(fa.infos, fb.infos):
            va, vb = fa.tensor(ta.name), fb.tensor(tb.name)
            got = ops.hamming_total(to_card(va), to_card(vb))
            want = hamming_total_arrays(va, vb)
            if got != want:
                raise AssertionError(f"{ta.name}: card counts {got} differing bits, numpy {want}")
            bits += got
            elems += va.size
    return bits / max(elems, 1), bits, elems


def phase_bitdistance(tmp: str, seed: int) -> int:
    """Bit distance of both fine-tunes to the base on the card; returns the
    hamming launches of this run."""
    hub = os.path.join(tmp, "hub")
    path = lambda rid: os.path.join(hub, rid, "model.safetensors")  # noqa: E731
    base_id, ft_a, ft_b, _ = UPLOADS
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for rid in (ft_a, ft_b):
        t1 = time.perf_counter()
        dist, bits, elems = file_distance_on_card(path(base_id), path(rid))
        t_card = time.perf_counter() - t1
        want = bit_distance_files(path(base_id), path(rid), sample_elems_per_tensor=None)
        if dist != want:
            raise AssertionError(f"{rid}: full-scan distance {dist} on the card, {want} in numpy")
        prefix = bit_distance_files(path(base_id), path(rid), sample_elems_per_tensor=MATCH_SAMPLE)
        log(f"bitdistance: {rid} vs {base_id}: full scan {dist!r} bits/element ({bits} bits over "
            f"{elems} elements; {t_card:.1f} s for the card pass with its host reads, copies and "
            f"per-tensor numpy check), equal to numpy's "
            f"bit_distance_files tensor by tensor and in total; the {MATCH_SAMPLE}-element "
            f"prefix distance the family matcher uses: {prefix!r}")
    # cross-family: two independent N(0, 0.02^2) bf16 embeddings
    V, d = QWEN2_7B["vocab"], QWEN2_7B["d_model"]
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    e1 = (torch.randn((V, d), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
    e2 = (torch.randn((V, d), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
    cross = ops.bit_distance(e1, e2)
    del e1, e2
    torch.cuda.empty_cache()
    if not cross > 4.5:
        raise AssertionError(f"independent N(0, 0.02^2) embeddings at {cross} bits, not above 4.5")
    launches = _build.launch_counts()["hamming"]
    if launches == 0:
        raise AssertionError("bit distance on the card never launched the hamming kernel")
    log(f"bitdistance: two independent N(0, 0.02^2) {V}x{d} bf16 embeddings at {cross!r} bits "
        f"(> 4.5); phase {time.perf_counter() - t0:.1f} s, hamming launches {launches}")
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


# ---------------------------------------------------------------------------
# phase 6: the Monte-Carlo threshold calibration on the card
# ---------------------------------------------------------------------------

def phase_calibration() -> int:
    """Paper Fig. 11 at N = 100,000; returns the hamming launches of this run."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = calibration_heatmap(n=100_000)
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()["hamming"]
    hm, sw, sd = res.heatmap, res.sigma_w_grid, res.sigma_delta_grid
    log("calibration: E[D(w, w+delta)] in bits, bf16, N = 100000 (rows sigma_w, columns "
        f"sigma_delta {sd})")
    for i, s_w in enumerate(sw):
        log(f"calibration:   sigma_w {s_w}: " + " ".join(f"{v:.5f}" for v in hm[i]))
    lo, hi = float(hm[sw.index(0.05), sd.index(0.0005)]), float(hm[sw.index(0.015), sd.index(0.02)])
    # the band checks of tests/test_core_storage.py:165-168
    if not (np.isfinite(hm).all() and 0.5 <= lo <= 6.0 and 2.5 <= hi <= 7.0):
        raise AssertionError(f"calibration outside the band: {lo} at (0.05, 0.0005), "
                             f"{hi} at (0.015, 0.02)")
    if launches == 0:
        raise AssertionError("the calibration never launched the hamming kernel")
    log(f"calibration: within_family_range {res.within_family_range}; band checks pass "
        f"({lo!r} at (0.05, 0.0005) in [0.5, 6], {hi!r} at (0.015, 0.02) in [2.5, 7]); "
        f"{wall:.2f} s, hamming launches {launches}")
    return launches


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
        launches["hamming"] = phase_bitdistance(tmp, SEED)
        shutil.rmtree(os.path.join(tmp, "hub"))
        shutil.rmtree(os.path.join(tmp, "store"))
        phase_identity(tmp, SEED)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["hamming"] += phase_calibration()
    # no path of the JAX package calls xor_2d: its count is phase 3's
    launches["xor"] = report["xor"]["launches"]
    log(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    launched_by = {"hamming": "phases 4b and 6 (bit distance, calibration)",
                   "xor": "phase 3 (kernel checks): no path of the JAX package calls xor_2d"}
    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "launched_by": launched_by.get(name, "phase 4 (store)"),
            "matched": True, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "library": KERNELS[name][2],
            "card": smi,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
