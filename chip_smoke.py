#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the zLLM store on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: require CUDA, print ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/planes.cu``,
   ``flash_attention.cu`` and ``flash_attention_sm90.cu`` with nvcc (with
   ``-Xptxas -v``), one process per source, in parallel; print each flash
   kernel's registers and spills and the count of ``HGMMA`` (tensor-core)
   instructions in each flash kernel's SASS (``cuobjdump -sass``);
3. kernels: each of the six storage kernels against its plain PyTorch version
   on the card, byte for byte (bit counts exactly), at word widths 1/2/4/8 and
   awkward lengths (the word XOR also on operands off a 16-byte boundary and at
   odd byte lengths), then at the main path's largest shape (the Qwen2-7B
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
   distance went through its kernel;
7. serve: the paper's serving cold start at Qwen2-7B's published widths,
   depth cut from 28 decoder layers to 4 (full-vocabulary embed and lm_head
   kept). Base parameters drawn on the card with ``init_params``, a fine-tune
   from ``make_finetune``, both written as ``params/<name>`` BF16 safetensors
   and ingested into the port's store (the fine-tune BitX-coded against its
   declared base); ``ServeEngine.from_store`` cold-starts the fine-tune
   (params bit-equal to the source) and ``RequestBatcher(batch_size=4,
   n_new=16)`` serves 8 requests of 33-2032 prompt tokens. Prefill runs the
   flash kernel in every layer (exactly 4 layers x 2 prefills). The same
   requests are then served again with each flash call held against its plain
   version on its own inputs, and the prefill logits of the flash and plain
   attention engines are held to the float32 model's. Every flash call of the
   serving run takes the ``sm90`` route.

Phase 3 also holds both flash-attention kernels (routes ``sm90`` and ``simt``)
against their plain version (``ref.mha_reference``) at the reference tests'
cases, ragged lengths, every head dim, Sq != Sk, bidirectional and windowed
masks, fully masked rows and strided (fused-projection) and misaligned
operands, asserting the route of each call, and times both at the shapes
phase 7's prefills give the kernel (B 4, S 2032 and 512, H 28, D 128, bf16,
causal) and at S 2048, beside their bound, the plain version and
``torch.nn.functional.scaled_dot_product_attention``, with the wrapper's host
time per call.

The last two lines are the kernels line (one JSON object) and the result line
``{"ok": true, "device": {...}}``. Model files and stores go to a temporary
directory outside the repository, removed at the end.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import qwen2_7b  # noqa: E402
from repro_torch.core.bitdistance import (bit_distance_files, calibration_heatmap,  # noqa: E402
                                          hamming_total_arrays, shape_signature)
from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402
from repro_torch.formats.safetensors import SafetensorsFile  # noqa: E402
from repro_torch.kernels import _build, bitx_xor, byte_planes, hamming, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import get_model, init_params  # noqa: E402
from repro_torch.serve.engine import RequestBatcher, ServeEngine  # noqa: E402

DEVICE = "cuda"
SEED = 0  # every weight and input of the run is drawn from generators seeded from it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate (used for every bound below)
BF16_FLOP_PER_S = 989e12   # H100 SXM published dense bf16 tensor-core rate

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
# the two routes of the flash-attention wrapper (kernels/flash_attention.py::route)
FLASH = {
    "sm90": {"name": "flash_attention_sm90",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"},
    "simt": {"name": "flash_attention", "source": "src/repro_torch/kernels/csrc/flash_attention.cu"},
}
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:99"
FLASH_LIBRARY = "torch.nn.functional.scaled_dot_product_attention"

# the serving run of phase 7
SERVE_LAYERS = 4
SERVE_PROMPTS = (2032, 1500, 1024, 700, 512, 300, 128, 33)
SERVE_BATCH, SERVE_NEW = 4, 16
# Prefill logits of the bf16 engines are held to the float32 model on the same
# parameters and batches. Both attentions round bf16 at different points (the
# kernel once from its float32 accumulator, the plain version after a bf16 PV
# product), so the flash engine's logits may not equal the plain engine's; it
# may stray from the float32 model no more than SERVE_DRIFT times as far as
# the plain engine does: the kernel adds no error of its own beyond bf16's.
SERVE_DRIFT = 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(8 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


HOLD_CYCLES = 60_000_000  # about 30 ms of a spin kernel at the H100's clocks


def cuda_ms(fn, iters: int = 10, hold: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after a
    warm-up call, from CUDA events. With ``hold``, a spin kernel holds the
    stream while the host enqueues the calls, so they run back to back on the
    card and the wrapper's host time per call (see :func:`host_us`) is not in
    the number; raises if the host took longer than the spin. A call that
    reads its result back to the host (a sync) is timed without the hold."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    held = not start.query()  # the spin still runs: every call was enqueued before the first ran
    end.synchronize()
    if hold and not held:
        raise AssertionError("the host enqueued the timed calls slower than the spin held them")
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 20) -> float:
    """Host wall time of one call of ``fn``, in microseconds: the enqueue
    (checks, route, tensor maps, ctypes), with the card kept busy so the
    host never waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


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


XOR_LENGTHS = (1, 15, 17, 2 ** 20 + 3)  # bytes
XOR_OFFSETS = ((0, 0, 0), (1, 1, 1), (15, 15, 15), (1, 1, 0), (1, 0, 0), (3, 5, 7))  # a, b, out


def xor_offsets() -> None:
    """The word XOR streams bytes: 16-byte vectors where a, b and out share
    their offset from a 16-byte boundary (scalar head and tail), single bytes
    where they do not. Every byte of every case equals the plain version's,
    and nothing outside ``out`` is written."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    n_max = max(XOR_LENGTHS) + 32
    a, b = (torch.randint(0, 256, (n_max,), dtype=torch.uint8, device=DEVICE, generator=g)
            for _ in range(2))
    for n in XOR_LENGTHS:
        for oa, ob, oo in XOR_OFFSETS:
            x, y = a[oa:oa + n], b[ob:ob + n]
            want = ref.xor_words(x, y)
            out = torch.zeros(n + 32, dtype=torch.uint8, device=DEVICE)
            _build.launch("xor", x, y, out[oo:oo + n], n=n, nb=1)
            if not (torch.equal(out[oo:oo + n], want) and torch.equal(bitx_xor.xor(x, y, 1), want)
                    and not out[:oo].any() and not out[oo + n:].any()):
                raise AssertionError(f"xor of {n} bytes at offsets a {oa}, b {ob}, out {oo} "
                                     "differs from its plain version")
    log(f"kernel xor: byte-exact at lengths {list(XOR_LENGTHS)} bytes with (a, b, out) offsets "
        f"{[list(o) for o in XOR_OFFSETS]} bytes from a 16-byte boundary (tolerance: exact)")


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
    xor_offsets()

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
        r["plain_ms"] = cuda_ms(plain, hold=name != "hamming")  # hamming's reads its total back
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


# (B, Sq, Sk, H, D, causal, window): tests/test_flash_kernel.py:12-19 first,
# then ragged lengths, every head dim, bidirectional and windowed masks; then
# cases for the sm90 route (bf16 at D 64 and 128): ragged Sq and Sk, Sq != Sk
# causal and not, a window over ragged tiles, and fully masked rows at D 64
# (rows from 23 on see no key in the window)
FLASH_CASES = [
    (2, 256, 256, 4, 128, True, 0), (1, 512, 512, 2, 128, False, 0),
    (2, 256, 256, 4, 128, True, 64), (1, 1024, 1024, 1, 128, True, 0),
    (1, 256, 256, 2, 256, True, 0),
    (2, 33, 33, 3, 64, True, 0), (1, 1000, 1000, 2, 128, True, 0),
    (2, 300, 300, 4, 16, True, 0), (2, 300, 300, 4, 32, False, 0),
    (2, 300, 300, 4, 64, False, 64), (1, 200, 200, 2, 256, True, 64),
    (1, 70, 200, 2, 64, False, 0),
    (2, 77, 77, 3, 128, True, 0), (1, 300, 170, 2, 64, True, 0),
    (1, 170, 300, 2, 128, False, 0), (1, 260, 260, 2, 64, True, 64),
    (1, 128, 16, 2, 64, False, 8),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_flash_kernel.py:33
# (B, S) of the timed shapes, all bf16 causal at Qwen2-7B's 28 query heads of
# dim 128 (the 4 KV heads expanded). Phase 7's batcher left-pads each batch of
# 4 prompts to its longest, so its two prefills give the kernel S = 2032 (not a
# multiple of either tile) and S = 512; S = 2048 is the power of two beside
# them. The kernels line reports the first, the largest shape of the path.
FLASH_TIMED = ((4, 2032), (4, 512), (4, 2048))
FLASH_H, FLASH_D = 28, 128


def flash_route(dtype, D: int) -> str:
    """The route a new contiguous operand of this dtype and head dim takes."""
    return "sm90" if dtype == torch.bfloat16 and D in fa.SM90_HEAD_DIMS else "simt"


def held_to_plain(got, q, k, v, causal: bool, window: int = 0) -> float:
    """max |got - plain version| on the same inputs; raises past the
    reference tests' rtol and atol for the inputs' dtype."""
    tol = FLASH_TOL[q.dtype]
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"flash_attention q {tuple(q.shape)} k {tuple(k.shape)} "
                             f"causal={causal} window={window} {q.dtype}: max_abs_err {err}")
    return err


def flash_checked(q, k, v, causal: bool, window: int = 0, *, route: str) -> tuple:
    """(kernel output, max |kernel - plain version|) on the same inputs;
    raises past the reference tests' rtol and atol, or if the call did not
    launch exactly one kernel of ``route``."""
    taken = fa.route(q, k, v)
    before = fa.route_launches()[taken]
    got = flash_attention(q, k, v, causal=causal, window=window)
    if taken != route or fa.route_launches()[taken] != before + 1:
        raise AssertionError(f"flash_attention q {tuple(q.shape)} {q.dtype} took route {taken} "
                             f"({fa.route_launches()[taken] - before} launches), want {route}")
    return got, held_to_plain(got, q, k, v, causal, window)


def flash_bound(B: int, S: int, H: int, D: int) -> tuple:
    """(bound ms, what bounds it) of causal bf16 attention at these shapes:
    both products over the unmasked (q, k) pairs at the bf16 tensor-core rate,
    against each input read and the output written once at the memory rate."""
    pairs = B * H * S * (S + 1) // 2
    ops_ms = 4 * pairs * D / BF16_FLOP_PER_S * 1e3
    bytes_ms = 4 * B * S * H * D * 2 / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_flash(gen: torch.Generator) -> dict:
    """Both flash kernels against their plain version; their times at the
    serving path's shapes. Returns each route's report entry (the first timed
    shape's) and the simt route's launches in this phase."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    bf16 = torch.bfloat16
    fa.reset_route_launches()
    worst = {}
    for B, Sq, Sk, H, D, causal, window in FLASH_CASES:
        for dt in FLASH_TOL:
            q = torch.randn((B, Sq, H, D), generator=gen, device=DEVICE).to(dt)
            k, v = (torch.randn((B, Sk, H, D), generator=gen, device=DEVICE).to(dt)
                    for _ in range(2))
            key = (str(dt).split(".")[-1], flash_route(dt, D))
            worst[key] = max(worst.get(key, 0.0),
                             flash_checked(q, k, v, causal, window, route=key[1])[1])
    for D in fa.SM90_HEAD_DIMS:
        # slices of one fused (B, S, 3H, D) projection, read in place by TMA;
        # a slice 2 bytes off a 16-byte boundary, which no tensor map addresses
        qkv = torch.randn((2, 130, 12, D), generator=gen, device=DEVICE).to(bf16)
        err = flash_checked(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], True, route="sm90")[1]
        worst[("bfloat16", "sm90")] = max(worst[("bfloat16", "sm90")], err)
        buf = torch.randn((2, 130, 4, D + 8), generator=gen, device=DEVICE).to(bf16)
        q = buf[..., 1:1 + D]
        err = flash_checked(q, qkv[:, :, 4:8], qkv[:, :, 8:], True, route="simt")[1]
        worst[("bfloat16", "simt")] = max(worst[("bfloat16", "simt")], err)
    launches = fa.route_launches()
    log(f"kernel flash_attention: both routes equal to their plain version at "
        f"{len(FLASH_CASES)} shapes x 2 dtypes (D in {{16, 32, 64, 128, 256}}, ragged 33/77/1000, "
        f"causal, bidirectional, window 64, Sq != Sk both ways, fully masked rows) and on "
        f"fused-projection and misaligned slices; launches by route {launches}; max_abs_err "
        + ", ".join(f"{dt} {r} {e:.3e}" for (dt, r), e in sorted(worst.items()))
        + " (tolerance 2e-5 in float32, 2e-2 in bf16, as rtol and atol)")

    reports = {}
    H, D = FLASH_H, FLASH_D
    for B, S in FLASH_TIMED:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(bf16)
                   for _ in range(3))
        calls = {"sm90": lambda: flash_attention(q, k, v, causal=True),
                 "simt": lambda: fa._launch("simt", q, k, v, True, 0)}
        errs = {"sm90": flash_checked(q, k, v, True, route="sm90")[1],
                "simt": held_to_plain(calls["simt"](), q, k, v, True)}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, S, D), same storage
        shared = {"shape": [B, S, H, D],
                  "plain_ms": cuda_ms(lambda: ref.mha_reference(q, k, v, causal=True), iters=3),
                  "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                      qt, kt, vt, is_causal=True))}
        shared["bound_ms"], shared["bound_by"] = flash_bound(B, S, H, D)
        for route, fn in calls.items():
            r = {**shared, "max_abs_err": errs[route], "ms": cuda_ms(fn), "host_us": host_us(fn)}
            log(f"kernel {FLASH[route]['name']} ({route}): {r['ms']:.4f} ms at B={B} S={S} H={H} "
                f"D={D} bf16 causal (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
                f"{r['bound_ms'] / r['ms']:.1%} of it); host {r['host_us']:.1f} us per wrapper call "
                f"({'device' if r['ms'] * 1e3 >= r['host_us'] else 'host'} time sets the rate of "
                f"back-to-back calls); plain version {r['plain_ms']:.4f} ms; library: "
                f"{FLASH_LIBRARY} {r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.2f}x the "
                f"kernel's speed); max_abs_err {r['max_abs_err']:.3e} (tolerance 2e-2)")
            reports.setdefault(route, r)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    reports["simt"]["launches"] = launches["simt"]
    return reports


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def _kernel_name(mangled: str) -> str:
    """flash_fwd_sm90_kernel<128>, flash_fwd_kernel<bf16,128,32>, ... from a
    mangled flash kernel name; other names as they are."""
    m = re.search(r"(flash_fwd\w*?_kernel)I(.+?)EEv", mangled)
    if not m:
        return mangled
    args = ["bf16" if t.group(0).startswith("13") else "f32" if t.group(0) == "f" else t.group(1)
            for t in re.finditer(r"13__nv_bfloat16|Li(\d+)E|f", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "cuobjdump")
    return path if os.path.exists(path) else None


def flash_build_report() -> dict:
    """Per flash kernel instance: registers and spilled bytes (from the build's
    ``-Xptxas -v``) and HGMMA instructions in its SASS (``cuobjdump -sass``).
    Raises if the sm90 kernel holds no HGMMA."""
    info = {}
    for src, text in _build.build_log().items():
        if not src.startswith("flash_attention"):
            continue
        name = None
        for line in text.splitlines():
            if (m := _PTXAS_ENTRY.search(line)):
                name = _kernel_name(m.group(1))
                info[name] = {"registers": None, "spill_stores": None, "spill_loads": None,
                              "hgmma": None}
            elif name and (m := _PTXAS_SPILL.search(line)):
                info[name]["spill_stores"], info[name]["spill_loads"] = map(int, m.groups())
            elif name and (m := _PTXAS_REGS.search(line)):
                info[name]["registers"] = int(m.group(1))
    tool = _cuobjdump()
    sass = None
    if tool:
        sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                              text=True, check=True).stdout
        name = None
        for line in sass.splitlines():
            if (m := re.search(r"Function : (\S+)", line)):
                name = _kernel_name(m.group(1))
                if name.startswith("flash_fwd"):
                    info.setdefault(name, {"registers": None, "spill_stores": None,
                                           "spill_loads": None})["hgmma"] = 0
                else:
                    name = None
            elif name and "HGMMA" in line:
                info[name]["hgmma"] += 1
    for name, r in sorted(info.items()):
        regs = ("not captured (the library was built by an earlier process)"
                if r["registers"] is None else
                f"{r['registers']} registers, spills {r['spill_stores']} bytes stored, "
                f"{r['spill_loads']} bytes loaded")
        hg = "not available (no cuobjdump)" if r["hgmma"] is None else r["hgmma"]
        log(f"build: {name}: {regs}; HGMMA instructions in its SASS: {hg}")
    if sass is not None:
        sm90 = [r["hgmma"] for n, r in info.items() if n.startswith("flash_fwd_sm90")]
        if not sm90 or min(sm90) == 0:
            raise AssertionError(f"the sm90 flash kernel holds no HGMMA instruction: {info}")
    return info


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


# ---------------------------------------------------------------------------
# phase 7: serve the fine-tune from the compressed store
# ---------------------------------------------------------------------------

class _Timed:
    """Wraps a model entry point: device-synchronised wall time per call, the
    batch each call took and the logits it returned."""

    def __init__(self, fn):
        self.fn, self.seconds, self.batches, self.logits = fn, [], [], []

    def __call__(self, *args):
        self.batches.append(args[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = self.fn(*args)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.logits.append(logits)
        return logits, cache


def _serve(engine: ServeEngine, prompts) -> tuple:
    """Serve ``prompts`` through a RequestBatcher; returns (tokens per request,
    prefill timer, decode timer, wall seconds)."""
    model = engine.model
    prefill, decode = _Timed(model.prefill), _Timed(model.decode_step)
    model.prefill, model.decode_step = prefill, decode
    try:
        batcher = RequestBatcher(engine, batch_size=SERVE_BATCH, n_new=SERVE_NEW)
        ids = [batcher.submit(p) for p in prompts]
        t0 = time.perf_counter()
        done = []
        while len(done) < len(ids):
            done += batcher.run_once()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step  # the class's methods again
    return [batcher.result(i) for i in ids], prefill, decode, wall


def phase_serve(tmp: str, seed: int) -> tuple:
    """Cold-start a 4-layer Qwen2-7B-width fine-tune from the store and serve
    8 requests; returns the flash launches of the serving run and the kernel's
    largest difference from its plain version on the inputs the run gave it."""
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=SERVE_LAYERS)
    log(f"serve: {cfg.name} widths (d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, head dim {cfg.hd}, QKV bias, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}); depth cut from {qwen2_7b.CONFIG.n_layers} decoder layers to "
        f"{cfg.n_layers}, full-vocabulary embed and lm_head kept")
    hub = os.path.join(tmp, "hub")
    base_id, ft_id = "qwen/base-serve", "alice/ft-serve"
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    t0 = time.perf_counter()
    base = init_params(cfg, gen)
    ft = make_finetune(base, CorpusSpec(), gen)
    n_params = sum(t.numel() for t in base.values())
    write_repo(hub, base_id, {f"params/{k}": v for k, v in base.items()})
    write_repo(hub, ft_id, {f"params/{k}": v for k, v in ft.items()}, base_model=base_id)
    del base
    torch.cuda.empty_cache()
    size = os.path.getsize(os.path.join(hub, ft_id, "model.safetensors"))
    log(f"serve: wrote base and fine-tune, {n_params / 1e9:.3f} G params ({size / 1e9:.3f} GB) "
        f"each, in {time.perf_counter() - t0:.1f} s")

    store = ZLLMStore(os.path.join(tmp, "store"), workers=min(16, os.cpu_count() or 1),
                      entropy_procs=0)
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        store.ingest_repo(os.path.join(hub, base_id), base_id)
        res = store.ingest_repo(os.path.join(hub, ft_id), ft_id)[0]
        t_ingest = time.perf_counter() - t0
        if not (res.base_id == base_id and res.n_bitx > 0):
            raise AssertionError(f"serve: the fine-tune was not BitX-coded against its base: {res}")
        shutil.rmtree(hub)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = ServeEngine.from_store(store, ft_id, "model.safetensors", cfg, device=DEVICE)
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t0
        store_launches = _build.launch_counts()
    finally:
        store.close()
    for name, t in ft.items():
        got = engine.params[name]
        if got.shape != t.shape or not torch.equal(got.view(torch.int16), t.view(torch.int16)):
            raise AssertionError(f"serve: cold-started {name} is not bit-equal to the source")
    del ft
    torch.cuda.empty_cache()
    log(f"serve: ingest of base + fine-tune {t_ingest:.1f} s (fine-tune BitX-coded against "
        f"{res.base_id}, {res.n_bitx} BitX tensors); cold start (retrieve, verify sha256, "
        f"parse, load to the card) {t_cold:.2f} s; all {len(engine.params)} params bit-equal "
        f"to the source file's; store kernel launches in this phase "
        f"{ {k: v for k, v in store_launches.items() if v} }")

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in SERVE_PROMPTS]
    # the main path: counts from 0 just before, read just after
    _build.reset_launch_counts()
    fa.reset_route_launches()
    toks, prefill, decode, wall = _serve(engine, prompts)
    launches = _build.launch_counts()["flash_attention"]
    routes = fa.route_launches()
    peak = torch.cuda.max_memory_allocated()
    n_prefills = -(-len(prompts) // SERVE_BATCH)
    if launches != SERVE_LAYERS * n_prefills or routes != {"sm90": launches, "simt": 0}:
        raise AssertionError(f"serve: {launches} flash launches (by route {routes}), want "
                             f"{SERVE_LAYERS} layers x {n_prefills} prefills, all sm90")
    for t in toks:
        if t.shape != (SERVE_NEW,) or not ((0 <= t) & (t < cfg.vocab)).all():
            raise AssertionError(f"serve: bad generated tokens {t}")
    for lg in prefill.logits + decode.logits:
        if not torch.isfinite(lg).all():
            raise AssertionError("serve: non-finite logits")

    # the kernel on exactly the tensors the path gives it: the same requests
    # served again, each flash call of every prefill layer held against its
    # plain version on its own inputs (after the count above, so not counted)
    path_errs = []

    def checked(q, k, v, *, causal, window):
        got, err = flash_checked(q, k, v, causal, window, route="sm90")
        path_errs.append((tuple(q.shape), err))
        return got

    transformer.flash_attention = checked
    try:
        _serve(engine, prompts)
    finally:
        transformer.flash_attention = flash_attention
    if len(path_errs) != launches:
        raise AssertionError(f"serve: {len(path_errs)} flash calls checked, {launches} launched")
    path_err = max(e for _, e in path_errs)
    log(f"serve: each of the {len(path_errs)} flash calls of the serving run took the sm90 route "
        f"and equals its plain version on its own inputs (q shapes "
        f"{sorted(set(s for s, _ in path_errs))}, bf16, causal; max_abs_err {path_err:.3e}, "
        f"tolerance 2e-2 as rtol and atol)")

    plain = ServeEngine(cfg, engine.params, device=DEVICE, attn="plain")
    before = _build.launch_counts()["flash_attention"]
    plain_toks, plain_prefill, _, _ = _serve(plain, prompts)
    if _build.launch_counts()["flash_attention"] != before:
        raise AssertionError("serve: the plain engine launched the flash kernel")
    errs = [float((a - b).abs().max()) for a, b in zip(prefill.logits, plain_prefill.logits)]
    scale = max(float(b.abs().max()) for b in plain_prefill.logits)
    # the float32 model (plain attention, float32 products) on the same batches
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = get_model(dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32"),
                        attn="plain")
    params32 = {k: v.float() for k, v in engine.params.items()}
    drift = {"flash": [], "plain": []}
    for batch, lf, lp in zip(prefill.batches, prefill.logits, plain_prefill.logits):
        l32, _ = model32.prefill(params32, batch)
        drift["flash"].append(float((lf - l32).abs().max()))
        drift["plain"].append(float((lp - l32).abs().max()))
    del params32
    torch.cuda.empty_cache()
    if not max(drift["flash"]) <= SERVE_DRIFT * max(drift["plain"]):
        raise AssertionError(f"serve: flash engine {drift['flash']} from the float32 model's "
                             f"prefill logits, plain engine {drift['plain']} (allowed: "
                             f"{SERVE_DRIFT}x the plain engine's)")
    agree = sum(int((a == b).sum()) for a, b in zip(toks, plain_toks))
    n_tok = len(prompts) * SERVE_NEW
    pre_ms = [1e3 * x for x in prefill.seconds]
    dec_ms = 1e3 * sum(decode.seconds) / len(decode.seconds)
    log(f"serve: {len(prompts)} requests (prompts {list(SERVE_PROMPTS)} tokens, batches of "
        f"{SERVE_BATCH} left-padded to {[max(SERVE_PROMPTS[i:i + SERVE_BATCH]) for i in range(0, len(prompts), SERVE_BATCH)]}, "
        f"{SERVE_NEW} new tokens each) in {wall:.3f} s: {n_tok / wall:.1f} generated tokens/s; "
        f"prefill {', '.join(f'{x:.2f}' for x in pre_ms)} ms per batch; decode "
        f"{dec_ms:.3f} ms per step ({len(decode.seconds)} steps, one token for each of "
        f"{SERVE_BATCH} rows); peak device memory {peak / 2**30:.2f} GiB; flash launches "
        f"{launches} ({SERVE_LAYERS} layers x {n_prefills} prefills, none in decode; by route "
        f"{routes})")
    log(f"serve: prefill logits (max |logit| {scale:.3f}) against the float32 model's, max_abs_err "
        f"per batch: flash engine {', '.join(f'{e:.4e}' for e in drift['flash'])}, plain engine "
        f"{', '.join(f'{e:.4e}' for e in drift['plain'])} (allowed for flash: {SERVE_DRIFT}x the "
        f"plain engine's); flash against plain {', '.join(f'{e:.4e}' for e in errs)}; greedy "
        f"tokens agreeing between the engines {agree} of {n_tok}")
    return launches, path_err


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
    log(f"build: {', '.join(str(p.relative_to(Path(__file__).resolve().parent)) for p in _build.SOURCES)} "
        f"compiled and loaded in {_build.build_seconds():.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    build_info = flash_build_report()

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    report = phase_kernels(gen)
    flash_reports = phase_flash(gen)
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
    tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-serve-")
    try:
        launches["flash_attention"], path_err = phase_serve(tmp, SEED)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # no path of the JAX package calls xor_2d: its count is phase 3's
    launches["xor"] = report["xor"]["launches"]
    log(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    launched_by = {"hamming": "phases 4b and 6 (bit distance, calibration)",
                   "xor": "phase 3 (kernel checks): no path of the JAX package calls xor_2d",
                   "flash_attention": "phase 3 (kernel checks): every flash call of the serving "
                                      "run takes the sm90 route"}
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
    # the path's kernel instance of each route: D 128 in bf16
    instance = {"sm90": "flash_fwd_sm90_kernel<128>", "simt": "flash_fwd_kernel<bf16,128,32>"}
    for route, r in flash_reports.items():
        kernels.append({
            **{k: FLASH[route][k] for k in ("name", "source")}, "route": "cuda",
            "replaces": FLASH_REPLACES, "flash_route": route,
            "launches": launches["flash_attention"] if route == "sm90" else r["launches"],
            "launched_by": "phase 7 (serve)" if route == "sm90" else launched_by["flash_attention"],
            "matched": True,
            "max_abs_err": max(r["max_abs_err"], path_err) if route == "sm90" else r["max_abs_err"],
            "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "library": FLASH_LIBRARY,
            "host_us": r["host_us"], **build_info.get(instance[route], {}), "card": smi,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
