#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the zLLM store on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. card: require CUDA, print ``nvidia-smi`` name and power limit;
2. build: compile ``src/repro_torch/kernels/csrc/planes.cu``,
   ``flash_attention_sm90.cu``, ``flash_attention_sm90_tf32.cu`` and
   ``flash_attention_tf32.cu`` with nvcc (with ``-Xptxas -v``), one process
   per source, in parallel; print each flash kernel's registers and spills
   and the count of its tensor-core instructions in its SASS (``cuobjdump
   -sass``): ``HGMMA`` (wgmma), which every sm90 instance (D 16, 32, 64,
   80, 128, 256) and sm90_tf32 instance (D 64, 80, 128, 256) must hold with
   no spilled byte and no wgmma that ptxas serialised, and ``HMMA``
   (mma.sync), which every tf32 instance (each head dim in float32 and bf16)
   must hold; and each sm90_tf32 instance's shared memory (at D 256 a
   cluster of two blocks);
3. kernels: each of the six storage kernels against its plain PyTorch version
   on the card, byte for byte (bit counts exactly), at word widths 1/2/4/8 and
   awkward lengths (the word XOR also on operands off a 16-byte boundary and at
   odd byte lengths), then at the main path's largest shape (the Qwen2-7B
   embedding, 152064 x 3584 bf16), timed with CUDA events beside its memory
   bound and, where one PyTorch call computes the same function, that call;
   plus a hamming total past 2^32 bits, also checked with numpy;
4. store: the port's ``ZLLMStore`` (default torch backend, on the card)
   ingests one dense family at Qwen2-7B's published widths, depth cut from 28
   decoder layers to 1 (full-vocabulary embedding and lm_head kept) — a base
   (ZipNN lane), a fine-tune declaring its base (BitX lane), a fine-tune
   matched by bit distance and an exact re-upload (file dedup) — and
   retrieves every file (all four at once, a thread each), sha256-checked
   against its source; the kernel launch counts of this run show that the
   path went through all four kernels;
4b. bit distance, on the files phase 4 wrote: the full-scan bit distance
   (paper Eq. 1) of each fine-tune to the base, every tensor loaded to the
   card and counted by the hamming kernel, equal to the numpy host path tensor
   by tensor and file by file, beside the prefix distance the store's family
   matcher uses; two independent N(0, 0.02^2) bf16 embeddings lie above 4.5;
4c. the store's lifecycle, on phase 4's store reopened from its index: first
   the six shrunk churn sequences of tests/test_torch_compact.py (ingest,
   re-upload, delete, gc, compact and reload of 3-tensor files under four
   repo ids) through a store on the card, each live file held to its bytes,
   fsck and the reload required to pass; then, at full width, ``churn``
   takes C (the base with every tensor but the embedding and lm_head replaced
   by fresh N(0, 1) bf16 from a seeded generator: stored standalone and bound
   as a family base), the declared fine-tune is re-registered with every
   third of those tensors taken from C (pinned in C's generation) and the
   others moved from the base by N(0, 0.005^2) (BitX-coded against it), its
   vocabulary tables its own, ``churn`` takes the base's exact bytes (a whole-file
   dedup: C's generation is superseded, its binding stays), ``delete_repo``
   drops the matched fine-tune, ``gc()`` and ``compact()`` run (compaction
   moves the tensors of C the re-registration needs and retires C's
   generation), and ``churn`` takes C again: its binding now names hashes
   with no pool entry, and the store must code C standalone, never against
   itself. ``fsck(spot_check=0)`` (the reference graph and structure) must
   pass and, after ``save_index()`` and a reload, C and the re-registered
   fine-tune must retrieve (at once, a thread each) with their sources'
   sha256; all four store kernels must have launched. The retrieve of phase
   4's re-upload and fsck's spot decodes are left out to keep the smoke in
   its time limit. Printed: the bytes compaction moved and reclaimed, gc and compact seconds, ingest and
   retrieve MB/s and the phase's kernel launches, beside the card's name and
   power limit, and on a JSON line of their own (``lifecycle``);
5. byte identity: a one-layer family (no embeddings) ingested by a CUDA store
   and a numpy store of the port writes byte-identical containers;
6. calibration: the Monte-Carlo heatmap of E[D(w, w+delta)] (paper Fig. 11,
   N = 100,000, the reference's 6x6 grid) on the card, with the reference
   tests' band checks. The hamming launches of phases 4b and 6 show that bit
   distance went through its kernel;
7. serve: the paper's serving cold start at Qwen2-7B's published widths,
   depth cut from 28 decoder layers to 1 (full-vocabulary embed and lm_head
   kept). Base parameters drawn on the card with ``init_params``, a fine-tune
   from ``make_finetune``, both written as ``params/<name>`` BF16 safetensors
   and ingested into the port's store (the fine-tune BitX-coded against its
   declared base); ``ServeEngine.from_store`` cold-starts the fine-tune
   (params bit-equal to the source) and ``RequestBatcher(batch_size=4,
   n_new=16)`` serves 8 requests of 33-2032 prompt tokens. Prefill runs the
   flash kernel in every layer (exactly 1 layer x 2 prefills). The same
   requests are then served again with each flash call held against its plain
   version on its own inputs, and the prefill logits of the flash and plain
   attention engines are held to the float32 model's. Every flash call of the
   serving run takes the ``sm90`` route. That float32 model (the same
   parameters, plain attention) is then run through attn="flash" on the same
   batches: exactly 1 layer x 2 prefills of the float32 route at D 128
   (``sm90_tf32``; none on another), each call held against its plain
   version within 2e-5, the logits
   within 1e-4 of the plain float32 model's max |logit|, the greedy tokens
   equal, each prefill timed against plain attention;
8. hub server: phase 7's store (index saved, closed) served by
   ``python -m repro_torch.serve.store_server --root <store> --port 0`` as a
   process of its own, its store on the card. Ranged tensor GETs of the
   fine-tune (the embedding's last MiB, a q_proj slice, the whole k_proj) and
   of a base tensor (ZipNN lane), each its tensor's first decode and required
   to launch; eight concurrent ranged GETs over distinct tensors and four of
   one tensor (single-flight); 64 ranged GETs from the decoded cache; a second
   fine-tune of the same base (every tensor moved by N(0, 0.005^2)) PUT over
   HTTP, its ingest job polled to the end, its three BitX reads and a
   whole-file GET whose sha256 equals the upload's. Every byte is held against
   its source file. ``/stats`` must show ``cuda:0`` and launches of
   ``xor_split``, ``merge_xor`` and ``merge`` in the server; the server must
   load phase 2's kernel library without rebuilding it and exit 0 on SIGINT.
   PUT and GET MB/s, ranged-GET latency, the server's launches, bytes and
   device memory are printed beside the card's name and power limit, and on a
   JSON line of their own (``hub_server``);
9. families: the SSM and whisper families through ``ServeEngine.generate``
   with attn="flash", batches of 4, parameters drawn on the card from the
   seed. 9a whisper-medium at published widths and depth (24 + 24 layers;
   frames stub (4, 1500, 1024), 64-token prompts, 32 new tokens: 72 flash
   calls a prefill, encoder, causal self and cross attention, all ``sm90``);
   9b zamba2-2.7b at published widths and depth (54 Mamba-2 layers, the
   shared block 9 times at head dim 80: 9 flash calls a prefill, all
   ``sm90``; 1024-token prompts, 16 new); 9c falcon-mamba-7b at published
   widths, depth cut from 64 layers to 2 (full-vocabulary embed and lm_head
   kept): a base and a fine-tune written as BF16/F32 safetensors, ingested
   into a fresh store (the fine-tune BitX-coded against its declared base at
   2- and 4-byte words), the fine-tune cold-started bit-equal to its source
   and served (1024-token prompts, 16 new). For each model: flash launches
   counted by route in the served run; every flash call of a prefill held
   against its plain version; the flash and plain engines' prefill logits
   against a float32 copy of the model; that float32 copy through attn="flash"
   as in phase 7 (whisper's 72 and zamba2's 9 calls a prefill on the float32
   route of D 64 and 80, ``sm90_tf32``); prefill S + one decode step against
   prefill S + 1; ``_pad_cache`` growing exactly the attention caches
   (falcon-mamba's cache bytes the same at 128 and 1024 tokens); prefill ms
   (served and warm), decode ms per step, tokens/s and peak device memory,
   for 9c ingest MB/s and the cold start, beside the card's name and power
   limit. The flash kernel is timed at 9b's shape (D 80, causal, bf16) on
   ``sm90`` (the path's) and ``tf32`` (and 9b's warm prefill with its calls
   on each, in turns), and at 9a's encoder shape (sm90, D 64, bidirectional)
   beside its bound and ``scaled_dot_product_attention``. The results go on
   a JSON line of their own (``families``).
10. training: 10a trains Qwen2-7B's published widths, depth cut from 28
   decoder layers to 2 (full-vocabulary embed and lm_head kept; bf16
   parameters drawn on the card from the seed), the first 8 steps of AdamW
   (lr 3e-4, ``OptimizerConfig``'s 100 warmup steps) on
   ``SyntheticTokens`` (vocab 152064, 4 x 1024 tokens a step, read through
   ``PrefetchIterator``), ``make_train_step(microbatches=2,
   grad_dtype="float32")``, remat "nothing", attn "plain", float32 matmuls on
   TF32 tensor cores (the phase sets ``allow_tf32`` and restores it after).
   ``CheckpointManager`` over the port's store (compressed only, parameters
   only) writes behind after step 4 (the ZipNN lane, ``split``) and
   synchronously after step 8 (BitX against step 4, ``xor_split``); step 8 is
   restored from the store (``merge_xor`` and ``merge``), bit-equal to the
   live parameters, with the same eval loss. The loss must fall; one more
   step's loss and grad norm under remat "none" and "dots" must equal
   "nothing"'s within 1e-5. Printed: step ms and tokens/s (the median of
   steps 3-8, and apart that of steps 2-4, which run beside no save), the
   model-FLOP share (6·N·tokens over the step time at the bf16 peak, N the
   matmul weights: not the embedding, a gather), peak device memory
   per remat policy, step ms beside the write-behind save and without it, save
   MB/s (file write and ingest apart), restore MB/s, the second checkpoint's
   stored/raw ratio and the phase's storage-kernel launches. 10b runs
   ``python -m repro_torch.launch.train --arch qwen2-7b --smoke --steps 8
   --ckpt-every 3 --fail-at 5`` twice as child processes on the card: the
   first must exit 42 at its injected crash, the second resume from step 3,
   end at step 8 and exit 0, its checkpoints holding AdamW state and
   BitX-chained to the first in the store, the kernel library loaded from
   phase 2's build. The results go on a JSON line of their own (``train``).
11. mesh: 11a phase 10a's cell (Qwen2-7B widths, 2 layers, 4 x 1024 tokens
   in 2 microbatches, AdamW, float32 accumulators, TF32) trained 1 untimed and
   5 timed steps, in turns, by an unsharded ``Trainer`` and by
   ``Trainer(mesh_shape=(1, 1))`` (DTensor parameters, optimizer state and
   batches on a one-rank NCCL mesh), both from the seed: the loss, grad norm
   and every parameter after each step must be bit-equal, or within 1e-6
   relative; the median of the timed steps' ms of both (the difference is
   DTensor's host cost). Then a prefill of 4 x 1024
   tokens on that mesh with attn "flash": exactly 2 ``sm90`` launches
   (``route_launches``), logits within phase 3's bf16 tolerance of the
   unsharded prefill's. 11b the dry run at published width and depth,
   ``python -m repro_torch.launch.dryrun`` as child processes all at once
   on the card's host, started before phase 9 and collected after 11c (CPU
   only; a fake process group of 256 or 512 ranks): qwen2-7b ``train_4k`` on the single-pod mesh, mixtral-8x7b
   ``decode_32k`` and (phase 12's) zamba2-2.7b ``long_500k`` on the multi-pod
   mesh, each record's per-device FLOPs,
   bytes, collective bytes by kind, peak GiB, H100 roofline row and host
   seconds printed. 11c one more step of 11a's unsharded cell counted by
   ``repro_torch.launch.op_cost`` on the card's tensors (not timed): its dot
   FLOPs within 2% of the closed form (``op_cost.train_dot_flops``), the
   roofline bound from ``launch.mesh.HW`` against 11a's median step, and the
   top 5 hotspots by FLOPs and by bytes. The results go on a JSON line of
   their own (``mesh``).
12. mesh families: 12a whisper-medium and zamba2-2.7b at published widths
   and depth, from phase 9's seeds, parameters and prompts (B 4,
   attn="flash"), served in turn by the unsharded ``ServeEngine`` and by
   ``ServeEngine(mesh=...)`` on a one-rank NCCL (1, 1) mesh, 8 greedy tokens
   each: the mesh's prefill logits bit-equal to the unsharded ones or within
   phase 3's bf16 tolerance of max |logits|, the tokens equal, its counted
   run exactly 72 ``sm90`` launches at D 64 (whisper) and 9 at D 80
   (zamba2), none on ``tf32``, each call of a mesh prefill held against its
   plain version on its own inputs; prefill ms and decode ms per step of
   both engines. 12b falcon-mamba-7b (2 of 64 layers) and zamba2-2.7b (6 of
   54 layers: one group and the shared block) at published widths, trained
   1 untimed and 3 timed steps by an unsharded ``Trainer`` and by
   ``Trainer(mesh_shape=(1, 1))`` in turns (4 x 1024 tokens in 2
   microbatches, AdamW, attn "plain"): loss, grad norm and every parameter
   bit-equal or within 1e-6 relative; the step ms medians. 12c: zamba2-2.7b
   ``long_500k`` on the multi-pod mesh dry-run with 11b's cells. The results
   go on a JSON line of their own (``mesh_families``).

Phase 3 also holds the flash-attention kernels (routes ``sm90``, ``sm90_tf32`` and ``tf32``)
against their plain version (``ref.mha_reference``) at the reference tests'
cases, ragged lengths, every head dim (80 included), Sq != Sk, bidirectional
and windowed masks, fully masked rows, the edges of the sm90 kernel's 64-key
tiles and 128-row blocks (at D 16, 32 and 256 too), strided (fused-projection)
and misaligned operands (float32 and bf16 slices 2-8 bytes off a 16-byte
boundary) and heads broadcast with stride 0, asserting the route of each call
(bf16 with TMA-addressable operands takes ``sm90`` at every head dim, float32
at D 64, 80, 128 and 256 with such operands ``sm90_tf32``, every other call
``tf32``); ``tf32``'s instances for bf16 at D 16 and 32 and float32 at D 256,
whose aligned calls take a wgmma route, are also launched directly at every
case of their head dim. It times
each ``sm90`` instance at its path's shape: D 128 at the shapes phase 7's
prefills give the kernel (B 4, S 2032 and 512, H 28, causal), D 80 at zamba2-2.7b's (4, 1024, 32, causal), D 64 at whisper-medium's
encoder (4, 1500, 16, bidirectional); D 128 also at a 32k-token prompt (B 1,
S 32768, H 28, causal), its rows 0-2047 held to the plain version on the
first 2048 keys (exact by causality) and every row to SDPA's output; in bf16
at D 256, 16 and 32 (B 4, S 2048, H 16, causal) ``sm90`` and ``tf32``, and on
float32 inputs, at phase 7's, zamba2-2.7b's and whisper-medium's encoder
shapes and at D 256 (B 4, S 2048, H 16, causal), ``sm90_tf32`` and
``tf32``, each launched directly, in turns; ``tf32`` alone at B 4, S 2048, H
16, causal in float32 at D 16 and 32;
each beside its bound (the largest of the products at the dtype's
tensor-core rate, one exp2 a pair at 16 a cycle per SM, and the bytes;
float32 with the three passes' ceiling where wgmma is paired with it), the
plain version
and ``torch.nn.functional.scaled_dot_product_attention`` (on float32 inputs
with TF32 off, the backend it dispatched to named), with the wrapper's host
time per call.

Phases 1-8 run in this process, in order. Phases 9-12 run in a child process
(``python3 chip_smoke.py --phases-9-12 ...``, its own launch counts), started
after phase 3 and run beside phases 4-8 on the same card: phases 4-8 are
mostly host work, and one after the other the twelve phases took 1165-1286 s
of the 1200 s limit on slow hosts. The child's output follows phase 8's;
its results come back pickled; it is stopped, with its own children, if
this process fails or dies. So the device times of phases 7-12 and phase
8's card-memory rise share the card with the other process.

The last lines are the lifecycle line, the hub server's line, the families
line, the train line, the mesh line, the mesh families line, the card's name
and power limit, the kernels line (one JSON object) and the result line
``{"ok": true, "device": {...}}``. Model files and stores go to a temporary
directory outside the repository, removed at the end.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

import concurrent.futures  # noqa: E402
import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
import http.client  # noqa: E402
import json  # noqa: E402
import pickle  # noqa: E402
import queue  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import (falcon_mamba_7b, get_config, qwen2_7b, whisper_medium,  # noqa: E402
                                 zamba2_2_7b)
from repro_torch.core import bitx  # noqa: E402
from repro_torch.core.bitdistance import (bit_distance_files, calibration_heatmap,  # noqa: E402
                                          hamming_total_arrays, shape_signature)
from repro_torch.core.bitx import TorchBackend  # noqa: E402
from repro_torch.core.pipeline import ZLLMStore  # noqa: E402
from repro_torch.corpus import CorpusSpec, make_base_tensors, make_finetune, write_repo  # noqa: E402
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens  # noqa: E402
from repro_torch.formats.safetensors import SafetensorsFile, save_file  # noqa: E402
from repro_torch.kernels import _build, bitx_xor, byte_planes, hamming, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import base as model_base  # noqa: E402
from repro_torch.models.api import get_model, init_params  # noqa: E402
from repro_torch.optim.optimizers import AdamW, OptimizerConfig, make_optimizer  # noqa: E402
from repro_torch.serve.engine import RequestBatcher, ServeEngine  # noqa: E402
from repro_torch.train.step import make_eval_step, make_train_step  # noqa: E402

DEVICE = "cuda"
SEED = 0  # every weight and input of the run is drawn from generators seeded from it
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate (used for every bound below)
BF16_FLOP_PER_S = 989e12   # H100 SXM published dense bf16 tensor-core rate
TF32_FLOP_PER_S = 495e12   # H100 SXM published dense TF32 tensor-core rate
# exp2 a second: the MUFU's 16 a cycle per SM (CUDA's throughput table for
# compute capability 9.0), 132 SMs, at the SM's highest clock, 1.98 GHz
# (nvidia-smi's clocks.max.sm; tools/exp2_peak.py's softmax mix stays below)
EXP2_PER_S = 16 * 132 * 1.98e9

# Qwen2-7B's published widths (src/repro/configs/qwen2_7b.py:5-12)
QWEN2_7B = dict(d_model=3584, d_ff=18944, vocab=152064, n_heads=28, n_kv_heads=4, qkv_bias=True)
QWEN2_7B_LAYERS = 28
# of 28 in phases 4-4c: cut from 2 to 1 when, at 2 here and 1 in phases 7-8,
# the whole smoke ran 1269 s on an H100 (700 W) whose host was slow
SMOKE_LAYERS = 1

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
# the routes of the flash-attention wrapper (kernels/flash_attention.py::route
# picks sm90, sm90_tf32 or tf32)
FLASH = {
    "sm90": {"name": "flash_attention_sm90",
             "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"},
    "sm90_tf32": {"name": "flash_attention_sm90_tf32",
                  "source": "src/repro_torch/kernels/csrc/flash_attention_sm90_tf32.cu"},
    "tf32": {"name": "flash_attention_tf32",
             "source": "src/repro_torch/kernels/csrc/flash_attention_tf32.cu"},
}
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:99"
FLASH_LIBRARY = "torch.nn.functional.scaled_dot_product_attention"

# the serving run of phase 7 (its store is phase 8's)
SERVE_REPOS = ("qwen/base-serve", "alice/ft-serve")  # base, fine-tune declaring it
# of 28 in phases 7-8: cut from 4 to 2, then to 1 when the whole smoke at 2
# layers here as in phases 4-4c ran 1207 s on an H100 (700 W), past its limit
SERVE_LAYERS = 1
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
# cases for the sm90 route (bf16 at D 64, 80 and 128): ragged Sq and Sk, Sq != Sk
# causal and not, a window over ragged tiles, fully masked rows at D 64
# (rows from 23 on see no key in the window), and the edges of its 64-key
# tiles and 64-row warpgroups
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
    # head dim 80 (zamba2-2.7b; sm90 in bf16, tf32 in float32): ragged, Sq !=
    # Sk, a window; and whisper's cross attention, 64 decoder tokens to 1500 frames
    (2, 333, 333, 4, 80, True, 0), (1, 64, 300, 2, 80, False, 0), (1, 200, 200, 2, 80, True, 64),
    (2, 64, 1500, 16, 64, False, 0),
    # Sk one short of, at and one past a 64-key tile (and of two); windows of
    # 63, 64 and 65; a 64-row causal diagonal; rows from 47 on fully masked;
    (1, 100, 63, 2, 64, False, 0), (1, 100, 64, 2, 80, False, 0), (1, 100, 65, 2, 128, False, 0),
    (1, 127, 127, 2, 128, True, 0), (1, 129, 129, 2, 64, True, 0),
    (1, 200, 200, 2, 64, True, 63), (1, 200, 200, 2, 80, False, 64), (1, 200, 200, 2, 128, True, 65),
    (2, 64, 64, 3, 128, True, 0), (1, 192, 40, 2, 64, False, 8),
    # and of the 128-key tiles of D 64
    (1, 150, 128, 2, 64, False, 0), (1, 255, 255, 2, 64, True, 0), (1, 150, 257, 2, 64, False, 0),
    # head dim 256 (sm90 in bf16, tf32 in float32): ragged over three 128-row
    # blocks, Sk one short of and one past the sm90 kernel's 80-key tile and
    # one past two, Sq one past a block, Sq != Sk both ways, windows of 63 and
    # 81 over ragged tiles, rows from 47 on fully masked
    (2, 333, 333, 3, 256, True, 0), (1, 100, 79, 2, 256, False, 0), (1, 100, 81, 2, 256, False, 0),
    (1, 170, 161, 2, 256, False, 0), (1, 129, 129, 2, 256, True, 0), (1, 300, 170, 2, 256, True, 0),
    (1, 170, 300, 2, 256, False, 0), (1, 260, 260, 2, 256, True, 63), (1, 200, 200, 2, 256, True, 81),
    (1, 192, 40, 2, 256, False, 8),
    # head dims 16 and 32 (the sm90 kernel's 64-key tiles there): Sk one short
    # of, one past a tile and one past two, a 64-row causal diagonal, Sq !=
    # Sk, windows of 63 and 65, rows from 47 on fully masked
    (1, 100, 63, 2, 16, False, 0), (1, 100, 65, 2, 32, False, 0), (1, 170, 129, 2, 16, False, 0),
    (2, 64, 64, 3, 32, True, 0), (1, 300, 170, 2, 16, True, 0), (1, 200, 200, 2, 32, True, 63),
    (1, 200, 200, 2, 16, False, 65), (1, 192, 40, 2, 32, False, 8),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_flash_kernel.py:33
# (B, S) of the timed shapes, all bf16 causal at Qwen2-7B's 28 query heads of
# dim 128 (the 4 KV heads expanded). Phase 7's batcher left-pads each batch of
# 4 prompts to its longest, so its two prefills give the kernel S = 2032 (not a
# multiple of either tile) and S = 512. The kernels line reports the first,
# the largest shape of the path.
FLASH_TIMED = ((4, 2032), (4, 512))
FLASH_H, FLASH_D = 28, 128
# float32 shapes the tf32 route is timed at (B, S, H, D, causal), each beside
# the plain version and SDPA on float32 inputs:
# phase 7's larger prefill, zamba2-2.7b's shared attention (phase 9b) and
# whisper-medium's encoder (phase 9a). The first is the kernels line's.
FLASH_TIMED_F32 = {"phase 7": (4, 2032, 28, 128, True), "zamba2": (4, 1024, 32, 80, True),
                   "whisper encoder": (4, 1500, 16, 64, False)}
# bf16 at head dims 256, 16 and 32, which no path gives: sm90 and the tf32
# route's one pass, in turns
FLASH_TIMED_BF16 = {D: (4, 2048, 16, D, True) for D in (256, 16, 32)}
# float32 at head dim 256, which no path gives: sm90_tf32 (a cluster of two
# blocks) and the tf32 route's three passes, in turns
FLASH_TIMED_F32_D256 = (4, 2048, 16, 256, True)
# the tf32 route's instances that no path and no timing above takes, each at
# B 4, S 2048, H 16, causal: (dtype, head dim)
FLASH_TIMED_TF32 = ((torch.float32, 16), (torch.float32, 32))
FLASH_TIMED_TF32_SHAPE = (4, 2048, 16, True)  # B, S, H, causal
# the other sm90 instances at their paths' shapes (B, S, H, D, causal):
# zamba2-2.7b's shared attention (phase 9b) and whisper-medium's encoder (9a)
FLASH_TIMED_SM90 = {80: (4, 1024, 32, 80, True), 64: (4, 1500, 16, 64, False)}
# a 32k-token prompt at Qwen2-7B's heads (the dry run's prefill_32k length):
# the plain version of every row would not fit on the card, so rows below
# FLASH_LONG_CHECKED are held to it on that many keys, every row to SDPA
FLASH_LONG = (1, 32768, 28, 128, True)
FLASH_LONG_CHECKED = 2048
# the tf32 route's instances whose aligned calls all take a wgmma route,
# launched directly at each FLASH_CASES case of their head dim so that they
# stay held to the plain version for the calls TMA cannot address: (dtype, D)
FLASH_TF32_DIRECT = ((torch.bfloat16, 16), (torch.bfloat16, 32), (torch.float32, 256))
# operand offsets (in elements from a 16-byte boundary) of the misaligned
# slices the tf32 route reads: its copies are 16, 8, 4 or 2 bytes wide
FLASH_OFFSETS = ((torch.float32, 1), (torch.float32, 2), (torch.bfloat16, 1),
                 (torch.bfloat16, 2), (torch.bfloat16, 4))


def flash_route(dtype, D: int) -> str:
    """The route a new contiguous operand of this dtype and head dim takes."""
    t = torch.empty((1, 1, 1, D), dtype=dtype, device=DEVICE)
    return fa.route(t, t, t)


def only(route: str, n: int) -> dict:
    """Launches by route: ``n`` on ``route``, none on another."""
    return {r: n if r == route else 0 for r in fa.ROUTE_LAUNCHES}


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


def flash_bound(B: int, S: int, H: int, D: int, causal: bool = True,
                dtype=torch.bfloat16, passes: int = 1) -> tuple:
    """(bound ms, the term that sets it) of self attention at these shapes:
    the largest of "products", both products over the unmasked (q, k) pairs
    at the tensor-core rate of the dtype (bf16; TF32 for float32), ``passes``
    times over; "exponentials", one exp2 a pair at EXP2_PER_S (in bf16 it
    passes the products only below D 60); "bytes", each input read and the
    output written once at the memory rate. ``passes`` 3 gives the ceiling of
    the tf32 kernel's three-pass float32 products."""
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else TF32_FLOP_PER_S
    terms = {"products": passes * 4 * pairs * D / rate * 1e3, "exponentials": pairs / EXP2_PER_S * 1e3,
             "bytes": 4 * B * S * H * D * torch.finfo(dtype).bits // 8 / HBM_BYTES_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], term


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend scaled_dot_product_attention dispatches these (B, H, S, D)
    inputs to: the first of its priority order that runs them alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    by_value = {b.value: b for b in SDPBackend.__members__.values()}
    for value in torch._C._get_sdp_priority_order():
        backend = by_value.get(value)
        if backend is None or backend == SDPBackend.ERROR:
            continue
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)
        except RuntimeError:
            continue
        return backend.name
    raise AssertionError("no backend of scaled_dot_product_attention runs these inputs")


def time_flash_pair(label: str, B: int, S: int, H: int, D: int, causal: bool,
                    gen: torch.Generator, dtype=torch.float32) -> dict:
    """The wgmma kernel of the dtype (sm90_tf32 for float32, sm90 for bf16)
    and the tf32 kernel (mma.sync) at one shape, each launched directly (so
    the one the route does not pick is timed too) and held to the plain
    version, in turns, beside the plain version and SDPA on the same inputs
    (float32 with TF32 off), the bound (:func:`flash_bound`, its term named)
    and, in float32, the three passes' ceiling."""
    f32 = dtype == torch.float32
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(dtype) for _ in range(3))
    wgmma = fa._WGMMA_ROUTE[dtype]
    calls = {route: (lambda route=route: fa._launch(route, q, k, v, causal, 0))
             for route in (wgmma, "tf32")}
    r = {"shape": [B, S, H, D], "causal": causal, "dtype": str(dtype).split(".")[-1],
         "route": flash_route(dtype, D)}
    for route, fn in calls.items():
        r[route] = {"max_abs_err": held_to_plain(fn(), q, k, v, causal), "ms": []}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's (B, H, S, D), same storage
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal)
    r["library_backend"] = sdpa_backend(qt, kt, vt, causal)
    for route in (wgmma, "tf32", "tf32", wgmma):  # in turns
        r[route]["ms"].append(cuda_ms(calls[route]))
    for route, fn in calls.items():
        r[route]["ms"] = min(r[route]["ms"])
        r[route]["host_us"] = host_us(fn)
    r["plain_ms"] = cuda_ms(lambda: ref.mha_reference(q, k, v, causal=causal), iters=3)
    r["library_ms"] = cuda_ms(sdpa)
    r["bound_ms"], r["bound_by"] = flash_bound(B, S, H, D, causal, dtype)
    if f32:
        r["passes_bound_ms"], _ = flash_bound(B, S, H, D, causal, torch.float32, passes=3)
    rate = {"products": "495 TFLOP/s TF32" if f32 else "989 TFLOP/s bf16",
            "exponentials": "16 exp2 a cycle per SM, 132 SMs, 1.98 GHz",
            "bytes": "3.35 TB/s"}[r["bound_by"]]
    mode = "causal" if causal else "bidirectional"
    for route in calls:
        t = r[route]
        ceiling = (f"; three passes' ceiling {r['passes_bound_ms']:.4f} ms, "
                   f"{r['passes_bound_ms'] / t['ms']:.1%} of it" if f32 else "")
        log(f"kernel {FLASH[route]['name']} ({route}{', routed' if route == r['route'] else ''}): "
            f"{t['ms']:.4f} ms at {label} B={B} S={S} H={H} D={D} {r['dtype']} {mode} (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} at {rate}, "
            f"{r['bound_ms'] / t['ms']:.1%} of it{ceiling}); host "
            f"{t['host_us']:.1f} us per call; plain version {r['plain_ms']:.4f} ms; library: "
            f"{FLASH_LIBRARY} {r['dtype']} ({r['library_backend']}"
            f"{', allow_tf32 off' if f32 else ''}) "
            f"{r['library_ms']:.4f} ms ({r['library_ms'] / t['ms']:.2f}x the kernel's speed); "
            f"max_abs_err {t['max_abs_err']:.3e} (tolerance {'2e-5' if f32 else '2e-2'})")
    log(f"kernel flash_attention at {label} {r['dtype']}: {wgmma} {r[wgmma]['ms']:.4f} ms, "
        f"tf32 {r['tf32']['ms']:.4f} ms ({r['tf32']['ms'] / r[wgmma]['ms']:.2f}x); the route "
        f"takes {r['route']}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return r


def time_flash_long(gen: torch.Generator) -> dict:
    """sm90 at FLASH_LONG beside SDPA: rows below FLASH_LONG_CHECKED held to
    the plain version on that many keys (exact by causality: no later key
    reaches them), every row within the bf16 tolerance of SDPA's output."""
    B, S, H, D, causal = FLASH_LONG
    n = FLASH_LONG_CHECKED
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(torch.bfloat16)
               for _ in range(3))
    if fa.route(q, k, v) != "sm90":
        raise AssertionError(f"flash_attention at {FLASH_LONG} takes route {fa.route(q, k, v)}")
    fn = lambda: flash_attention(q, k, v, causal=causal)  # noqa: E731
    got = fn()
    err = held_to_plain(got[:, :n], q[:, :n], k[:, :n], v[:, :n], causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal)
    want = sdpa().transpose(1, 2).float()
    diff = (got.float() - want).abs()
    tol = FLASH_TOL[torch.bfloat16]
    if not bool((diff <= tol + tol * want.abs()).all()):
        raise AssertionError(f"flash_attention at {FLASH_LONG}: max |kernel - SDPA| "
                             f"{float(diff.max())} past the bf16 tolerance")
    r = {"shape": [B, S, H, D], "causal": causal, "max_abs_err": err,
         "sdpa_abs_err": float(diff.max()), "plain_rows": n, "ms": cuda_ms(fn),
         "host_us": host_us(fn, iters=5), "library_ms": cuda_ms(sdpa)}
    r["bound_ms"], r["bound_by"] = flash_bound(B, S, H, D, causal)
    del q, k, v, qt, kt, vt, got, want, diff
    log(f"kernel {FLASH['sm90']['name']} (sm90): {r['ms']:.4f} ms at B={B} S={S} H={H} D={D} "
        f"bf16 causal (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
        f"{r['bound_ms'] / r['ms']:.1%} of it); library: {FLASH_LIBRARY} {r['library_ms']:.4f} ms "
        f"({r['library_ms'] / r['ms']:.2f}x the kernel's speed); rows 0-{n - 1} held to the plain "
        f"version on keys 0-{n - 1}: max_abs_err {err:.3e}; every row against SDPA's output: "
        f"max_abs_err {r['sdpa_abs_err']:.3e} (tolerance 2e-2)")
    torch.cuda.empty_cache()
    return r


def phase_flash(gen: torch.Generator) -> dict:
    """The flash kernels against their plain version; their times at the
    serving path's shapes. Returns sm90's report entry (phase 7's bf16 S 2032
    shape) and, under "sm90_80", "sm90_64", "sm90_long", "f32", "bf16",
    "f32_256" and "tf32_only", the other sm90 instances, the 32k row, the
    float32 timings of sm90_tf32 and tf32 at the paths' shapes, the bf16
    timings of sm90 and tf32 in turns at D 256, 16 and 32 (by head dim), the
    float32 timing of sm90_tf32 and tf32 in turns at D 256, and the tf32
    instances timed alone."""
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
            if (dt, D) in FLASH_TF32_DIRECT:
                # the tf32 route's instance here keeps the calls TMA cannot
                # address (below): launched directly at these cases
                got = fa._launch("tf32", q, k, v, causal, window)
                worst[(key[0], "tf32")] = max(worst.get((key[0], "tf32"), 0.0),
                                              held_to_plain(got, q, k, v, causal, window))
    if flash_route(bf16, 256) != "sm90" or worst.get(("bfloat16", "sm90")) is None:
        raise AssertionError("bf16 at D 256 does not take the sm90 route")
    if flash_route(torch.float32, 256) != "sm90_tf32":
        raise AssertionError("float32 at D 256 does not take the sm90_tf32 route")
    for D in fa.WGMMA_HEAD_DIMS[bf16]:
        # slices of one fused (B, S, 3H, D) projection, read in place by TMA;
        # a slice 2 bytes off a 16-byte boundary, which no tensor map addresses
        qkv = torch.randn((2, 130, 12, D), generator=gen, device=DEVICE).to(bf16)
        err = flash_checked(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], True, route="sm90")[1]
        worst[("bfloat16", "sm90")] = max(worst[("bfloat16", "sm90")], err)
        buf = torch.randn((2, 130, 4, D + 8), generator=gen, device=DEVICE).to(bf16)
        q = buf[..., 1:1 + D]
        err = flash_checked(q, qkv[:, :, 4:8], qkv[:, :, 8:], True, route="tf32")[1]
        worst[("bfloat16", "tf32")] = max(worst[("bfloat16", "tf32")], err)
    for D in fa.WGMMA_HEAD_DIMS[torch.float32]:
        # float32 slices of one fused projection, read in place by TMA
        qkv = torch.randn((2, 130, 12, D), generator=gen, device=DEVICE)
        err = flash_checked(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], True, route="sm90_tf32")[1]
        worst[("float32", "sm90_tf32")] = max(worst[("float32", "sm90_tf32")], err)
    for dt, off in FLASH_OFFSETS:
        for D in (16, 80, 128, 256):
            # q a slice `off` elements into wider rows, k's heads broadcast
            # with stride 0: the tf32 kernel's copies at 4, 8 (or 2) bytes
            buf = torch.randn((2, 130, 4, D + 8), generator=gen, device=DEVICE).to(dt)
            k = torch.randn((2, 130, 1, D), generator=gen, device=DEVICE).to(dt).expand(2, 130, 4, D)
            v = torch.randn((2, 130, 4, D), generator=gen, device=DEVICE).to(dt)
            key = (str(dt).split(".")[-1], "tf32")
            worst[key] = max(worst[key], flash_checked(buf[..., off:off + D], k, v, True,
                                                       route="tf32")[1])
    launches = fa.route_launches()
    log(f"kernel flash_attention: every route equal to its plain version at "
        f"{len(FLASH_CASES)} shapes x 2 dtypes (D in {{16, 32, 64, 80, 128, 256}}, ragged 33/77/1000, "
        f"causal, bidirectional, windows 63-65, Sq != Sk both ways, fully masked rows, Sk at "
        f"63-65, 127-129 and 255-257), on "
        f"fused-projection and misaligned slices (offsets {[(str(d)[6:], o) for d, o in FLASH_OFFSETS]} "
        f"elements, heads broadcast with stride 0); each call's route asserted; launches by route "
        f"{launches}; max_abs_err "
        + ", ".join(f"{dt} {r} {e:.3e}" for (dt, r), e in sorted(worst.items()))
        + " (tolerance 2e-5 in float32, 2e-2 in bf16, as rtol and atol)")

    reports = {"worst": {f"{dt} {r}": e for (dt, r), e in worst.items()}}
    H, D = FLASH_H, FLASH_D
    for B, S in FLASH_TIMED:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(bf16)
                   for _ in range(3))
        calls = {"sm90": lambda: flash_attention(q, k, v, causal=True)}
        errs = {"sm90": flash_checked(q, k, v, True, route="sm90")[1]}
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
            reports.setdefault(f"{route}_bf16", r)
        del q, k, v, qt, kt, vt
    reports["sm90"] = reports.pop("sm90_bf16")
    for D_, shape in FLASH_TIMED_SM90.items():
        reports[f"sm90_{D_}"] = _time_flash(*shape, "sm90", gen)
    reports["sm90_long"] = time_flash_long(gen)

    # bf16 at D 256, 16 and 32: sm90 and the tf32 route's one pass, in turns
    pairs = {D: time_flash_pair(f"D {D}", *shape, gen, dtype=bf16)
             for D, shape in FLASH_TIMED_BF16.items()}
    if any(r["route"] != "sm90" for r in pairs.values()):
        raise AssertionError(f"bf16 at D 256, 16 or 32 leaves the sm90 route: "
                             f"{[(r['shape'], r['route']) for r in pairs.values()]}")
    # float32 at the families' shapes: sm90_tf32 and tf32 beside the plain
    # version and SDPA
    f32 = {label: time_flash_pair(label, *shape, gen)
           for label, shape in FLASH_TIMED_F32.items()}
    reports["f32"], reports["bf16"] = f32, pairs
    # float32 at D 256: sm90_tf32's cluster and tf32, in turns
    f32_256 = reports["f32_256"] = time_flash_pair("D 256", *FLASH_TIMED_F32_D256, gen)
    if f32_256["route"] != "sm90_tf32":
        raise AssertionError(f"float32 at {FLASH_TIMED_F32_D256} takes {f32_256['route']}")
    if any(flash_route(dt, D) != "tf32" for dt, D in FLASH_TIMED_TF32):
        raise AssertionError(f"a call of {FLASH_TIMED_TF32} leaves the tf32 route")
    B, S, H, causal = FLASH_TIMED_TF32_SHAPE
    reports["tf32_only"] = {tf32_instance(dt, D): _time_flash(B, S, H, D, causal, "tf32", gen, dt)
                            for dt, D in FLASH_TIMED_TF32}
    torch.cuda.empty_cache()
    return reports


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SERIAL = re.compile(r"wgmma.mma_async instructions are serialized.*function '(\w+)'")


def _kernel_name(mangled: str) -> str:
    """flash_fwd_sm90_kernel<128>, flash_fwd_tf32_kernel<f32,128,32,3>, ...
    from a mangled flash kernel name; other names as they are."""
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
    """Per flash kernel instance: registers, spilled bytes and whether ptxas
    serialised its wgmma (from the build's ``-Xptxas -v``) and its tensor-core
    instructions in its SASS (``cuobjdump -sass``): HGMMA (wgmma) and HMMA
    (mma.sync); each sm90_tf32 instance's dynamic shared memory and blocks a
    cluster. Raises if an sm90 or sm90_tf32 instance (one per head dim of
    the kernel) is missing, holds no HGMMA, spills or had its wgmma
    serialised, or a tf32 instance (one per head dim and dtype) is missing or
    holds no HMMA."""
    info = {}
    blank = {"registers": None, "spill_stores": None, "spill_loads": None,
             "wgmma_serialized": None, "hgmma": None, "hmma": None}
    serialized = set()
    for src, text in _build.build_log().items():
        if not src.startswith("flash_attention"):
            continue
        name = None
        for line in text.splitlines():
            if (m := _PTXAS_SERIAL.search(line)):
                serialized.add(_kernel_name(m.group(1)))
            elif (m := _PTXAS_ENTRY.search(line)):
                name = _kernel_name(m.group(1))
                info[name] = dict(blank)
            elif name and (m := _PTXAS_SPILL.search(line)):
                info[name]["spill_stores"], info[name]["spill_loads"] = map(int, m.groups())
            elif name and (m := _PTXAS_REGS.search(line)):
                info[name]["registers"] = int(m.group(1))
                info[name]["wgmma_serialized"] = name in serialized
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
                    info.setdefault(name, dict(blank)).update(hgmma=0, hmma=0)
                else:
                    name = None
            elif name and "HGMMA" in line:
                info[name]["hgmma"] += 1
            elif name and "HMMA" in line:
                info[name]["hmma"] += 1
    # each sm90_tf32 instance's shared memory as its launcher asks for it
    layout = _build.library().zllm_flash_attention_sm90_tf32_layout
    layout.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    layout.restype = ctypes.c_int
    for D in fa.WGMMA_HEAD_DIMS[torch.float32]:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        if layout(D, ctypes.byref(smem), ctypes.byref(blocks)) != 0:
            raise AssertionError(f"flash_fwd_sm90_tf32_kernel<{D}> has no layout")
        info.setdefault(f"flash_fwd_sm90_tf32_kernel<{D}>", dict(blank)).update(
            smem_bytes=smem.value, cluster_blocks=blocks.value)
    for name, r in sorted(info.items()):
        regs = ("not captured (the library was built by an earlier process)"
                if r["registers"] is None else
                f"{r['registers']} registers, spills {r['spill_stores']} bytes stored, "
                f"{r['spill_loads']} bytes loaded"
                + ("; ptxas serialised its wgmma" if r["wgmma_serialized"] else ""))
        mma = ("not available (no cuobjdump)" if r["hgmma"] is None else
               f"HGMMA {r['hgmma']}, HMMA {r['hmma']}")
        smem = ("" if "smem_bytes" not in r else
                f"; dynamic shared memory {r['smem_bytes']} bytes a block, {r['cluster_blocks']} "
                f"block(s) a cluster: {r['smem_bytes'] * r['cluster_blocks']} bytes a cluster")
        log(f"build: {name}: {regs}; tensor-core instructions in its SASS: {mma}{smem}")
    wgmma_instances = ([f"flash_fwd_sm90_kernel<{D}>" for D in fa.WGMMA_HEAD_DIMS[torch.bfloat16]]
                       + [f"flash_fwd_sm90_tf32_kernel<{D}>"
                          for D in fa.WGMMA_HEAD_DIMS[torch.float32]])
    for name in wgmma_instances:
        r = info.get(name, blank)
        if r["registers"] is not None and (r["spill_stores"] or r["spill_loads"]
                                           or r["wgmma_serialized"]):
            raise AssertionError(f"{name} spills or has its wgmma serialised: {r}")
    if sass is not None:
        hgmma = {name: info.get(name, {}).get("hgmma") for name in wgmma_instances}
        if not all(hgmma.values()):
            raise AssertionError(f"an sm90 or sm90_tf32 flash kernel instance is missing or holds "
                                 f"no HGMMA instruction: {hgmma}; {info}")
        tf32 = {n: r["hmma"] for n, r in info.items() if n.startswith("flash_fwd_tf32_kernel")}
        if len(tf32) != 2 * len(fa.HEAD_DIMS) or not all(tf32.values()):
            raise AssertionError(f"a tf32 flash kernel instance is missing or holds no HMMA "
                                 f"instruction: {tf32}")
    return info


def tf32_instance(dtype, D: int) -> str:
    """The name flash_build_report gives the tf32 kernel's instance for this
    dtype and head dim (its KV tile and passes as the launcher picks them)."""
    f32 = dtype == torch.float32
    bkv = 32 if D == 256 or (D >= 64 and f32) else 64
    return f"flash_fwd_tf32_kernel<{'f32' if f32 else 'bf16'},{D},{bkv},{3 if f32 else 1}>"


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

        def retrieve(rid):
            got = hashlib.sha256(store.retrieve_file(rid, "model.safetensors")).hexdigest()
            if got != want_sha[rid]:
                raise AssertionError(f"retrieved {rid} has sha256 {got}, source {want_sha[rid]}")

        # every file at once, a thread each, as a hub's readers fetch them: a
        # file's largest tensors decode on one thread each, so one file at a
        # time leaves most of the store's workers idle (the whole smoke ran
        # 1211-1286 s on slow hosts with the files one after another)
        with concurrent.futures.ThreadPoolExecutor(len(uploads)) as pool:
            list(pool.map(retrieve, uploads))
        t_retrieve = time.perf_counter() - t0
        launches = _build.launch_counts()
        c_all = backend.counters()
        peak = torch.cuda.max_memory_allocated()
        summary = store.summary()
        store.save_index()  # phase 4c reopens this store
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
    for label, wall, c in (("ingest", t_ingest, c_ingest),
                           ("retrieve (the four files at once)", t_retrieve, c_ret)):
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
# phase 4c: the store's lifecycle at Qwen2-7B width, on phase 4's store
# ---------------------------------------------------------------------------

CHURN_REPO = "churn"
# shrunk sequences of tests/test_compact.py's churn harness that re-upload a
# file after gc or compaction retired its family base (tests/test_torch_compact.py)
CHURN_SEQUENCES = ((0, 1, 8, 112, 0), (0, 0, 1, 8, 112, 0), (0, 0, 1, 8, 116, 0),
                   (0, 0, 74, 115570, 160, 74), (0, 0, 362811, 3, 112, 362811),
                   (0, 0, 688394, 938982, 68, 688394))
CHURN_TENSORS, CHURN_ELEMS = 3, 64  # the harness's file: 3 float32 tensors of 64
# C keeps the base's vocabulary tables (82% of the file at 1 layer): the
# ZipNN lane codes each of them in one single-threaded entropy job, about 40 s
# a table on the card's host, twice in the phase, which the smoke's time cannot
# hold; the re-registration keeps the fine-tune's own tables for the same reason
VOCAB_TABLES = ("model.embed_tokens.weight", "lm_head.weight")
# fsck after the churn checks the reference graph and structure only: its
# default spot check decodes each container's first 4 payload records, the
# full-width vocabulary tables among them, which takes about as long as a
# retrieve; the two retrieves after the reload decode every record the churn
# wrote or compaction moved
LIFECYCLE_SPOT_CHECK = 0


def churn_sequence(ops, root: str) -> None:
    """One op sequence of the churn harness (``_churn``, tests/test_compact.py)
    through a store on the card: each op ingests fresh or partly re-drawn
    content under one of four repo ids, uploads another live repo's exact
    bytes, deletes a repo, or runs gc or compact; every live file must then
    retrieve byte for byte, fsck must pass, and so must a reload."""
    rids = ["r0", "r1", "r2", "r3"]
    store = ZLLMStore(os.path.join(root, "store"))
    oracle, content, seq = {}, {}, 0

    def draw(seed):
        return np.random.RandomState(seed).randn(CHURN_ELEMS).astype(np.float32)

    def upload(rid, data):
        nonlocal seq
        seq += 1
        p = os.path.join(root, "hub", f"u{seq}", "model.safetensors")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
        store.ingest_file(p, rid)
        oracle[rid] = data

    def check(rid):
        if store.retrieve_file(rid, "model.safetensors") != oracle[rid]:
            raise AssertionError(f"churn {list(ops)}: {rid} does not retrieve its bytes")

    try:
        for op in ops:
            rid = rids[op % len(rids)]
            kind = (op // len(rids)) % 6
            if kind == 0 or (kind == 1 and rid not in content):
                tensors = {f"t{i}": draw(op * 7 + i) for i in range(CHURN_TENSORS)}
            elif kind == 1:
                tensors = dict(content[rid])
                for i in range(CHURN_TENSORS):
                    if (op >> (4 + i)) & 1:
                        tensors[f"t{i}"] = draw(op * 13 + i)
            elif kind == 2:
                src = next((r for r in rids if r in oracle and r != rid), None)
                if src is not None:
                    upload(rid, oracle[src])
                    content[rid] = dict(content[src])
                continue
            elif kind == 3:
                if rid in oracle:
                    store.delete_repo(rid)
                    del oracle[rid], content[rid]
                continue
            elif kind == 4:
                if op % 2:
                    store.gc()
                else:
                    store.gc(incremental=True, max_pause_ms=0.5, persist=False)
                continue
            else:
                store.compact(persist=False)
                continue
            p = os.path.join(root, "staged.safetensors")
            save_file(tensors, p)
            with open(p, "rb") as f:
                upload(rid, f.read())
            content[rid] = tensors
            check(sorted(oracle)[op % len(oracle)])
        for rid in oracle:
            check(rid)
        report = store.fsck(spot_check=None)
        if not report.ok:
            raise AssertionError(f"churn {list(ops)}: fsck {report.dangling} {report.corrupt}")
        store.save_index()
    finally:
        store.close()
    store = ZLLMStore(os.path.join(root, "store"))
    try:
        if not store.load_index():
            raise AssertionError(f"churn {list(ops)}: the index did not reload")
        for rid in oracle:
            check(rid)
        if not store.fsck(spot_check=None).ok:
            raise AssertionError(f"churn {list(ops)}: fsck after the reload")
    finally:
        store.close()


def random_copy(src_dir: str, dst_dir: str, replace: dict) -> str:
    """The ``chain_copy`` recipe (benchmarks/common.py:22) on the port: a copy
    of the repo at ``src_dir``, model card and config included, whose
    ``model.safetensors`` has the tensors named in ``replace`` swapped for the
    given uint16 bit views of bf16 tensors of the same shape."""
    shutil.copytree(src_dir, dst_dir, ignore=shutil.ignore_patterns("model.safetensors"))
    with SafetensorsFile(os.path.join(src_dir, "model.safetensors")) as sf:
        save_file({ti.name: replace.get(ti.name, sf.tensor(ti.name)) for ti in sf.infos},
                  os.path.join(dst_dir, "model.safetensors"),
                  dtype_tags={ti.name: ti.dtype_str for ti in sf.infos})
    return dst_dir


def random_bf16(shape, gen: torch.Generator) -> np.ndarray:
    """Fresh N(0, 1) bf16 of ``shape``, drawn on the card, as a host bit view."""
    t = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def perturbed_bf16(bits: np.ndarray, sigma: float, gen: torch.Generator) -> np.ndarray:
    """The bf16 tensor of host bit view ``bits`` moved by N(0, sigma^2) in
    float32 on the card and rounded back, as ``make_finetune`` moves a tensor."""
    t = torch.from_numpy(np.array(bits).view(np.int16)).to(DEVICE).view(torch.bfloat16)
    noise = torch.randn(t.shape, generator=gen, device=DEVICE) * sigma
    return (t.float() + noise).to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)


def phase_lifecycle(tmp: str, seed: int, smi: str) -> dict:
    """Re-registration, whole-file re-upload, delete_repo, gc, compact, fsck and
    a reload on phase 4's store, with a repo re-uploaded after compaction
    retired the generation its family base was bound to. Returns the numbers
    and the kernel launches of the full-width steps."""
    hub = os.path.join(tmp, "hub")
    base_id, ft_a, ft_b, reup = UPLOADS
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for n, ops in enumerate(CHURN_SEQUENCES):
        churn_sequence(ops, os.path.join(tmp, "churn-sequences", str(n)))
    seq_launches = _build.launch_counts()
    shutil.rmtree(os.path.join(tmp, "churn-sequences"), ignore_errors=True)
    log(f"lifecycle: the {len(CHURN_SEQUENCES)} shrunk churn sequences of tests/test_torch_compact.py "
        f"ran on a store on the card in {time.perf_counter() - t0:.1f} s: every live file "
        f"retrieved byte for byte, fsck ok, reload ok; kernel launches {seq_launches}")

    # C: the base with every tensor but the vocabulary tables replaced (far
    # from it in bit distance); the declared fine-tune re-registered with every
    # third of those tensors taken from C and the others moved from the base by
    # N(0, sigma_delta^2), as make_finetune moves them (BitX-coded against it)
    spec = CorpusSpec(n_layers=SMOKE_LAYERS, **QWEN2_7B)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 4)
    t0 = time.perf_counter()
    with SafetensorsFile(os.path.join(hub, base_id, "model.safetensors")) as sf:
        infos = list(sf.infos)
        layers = [ti.name for ti in infos if ti.name not in VOCAB_TABLES]
        fresh = {name: random_bf16(sf.info(name).shape, gen) for name in layers}
        taken = layers[::3]
        moved_from_base = {name: perturbed_bf16(sf.tensor(name), spec.sigma_delta, gen)
                           for name in layers if name not in taken}
        n_bitx = sum(not np.array_equal(v, sf.tensor(name)) for name, v in moved_from_base.items())
    c_dir = random_copy(os.path.join(hub, base_id), os.path.join(hub, "churn-c"), fresh)
    ft2_dir = random_copy(os.path.join(hub, ft_a), os.path.join(hub, "ft-declared-v2"),
                          {**{name: fresh[name] for name in taken}, **moved_from_base})
    del fresh, moved_from_base
    kept, moved = len(infos) - len(layers), len(taken)
    file_bytes = os.path.getsize(os.path.join(c_dir, "model.safetensors"))
    want = {CHURN_REPO: sha256_file(os.path.join(c_dir, "model.safetensors")),
            ft_a: sha256_file(os.path.join(ft2_dir, "model.safetensors"))}
    log(f"lifecycle: wrote C ({len(infos)} tensors, {file_bytes / 1e9:.3f} GB: {len(layers)} "
        f"fresh N(0, 1) bf16, the base's {' and '.join(VOCAB_TABLES)} kept) and a "
        f"re-registration of {ft_a} ({moved} tensors from C, {len(layers) - moved} moved from "
        f"the base by N(0, {spec.sigma_delta}^2), its own vocabulary tables) in "
        f"{time.perf_counter() - t0:.1f} s")

    store = ZLLMStore(os.path.join(tmp, "store"), workers=min(16, os.cpu_count() or 1),
                      entropy_procs=0)
    seconds = {}

    def timed(label, fn):
        t = time.perf_counter()
        r = fn()
        seconds[label] = time.perf_counter() - t
        return r

    try:
        if not store.load_index():
            raise AssertionError("phase 4's store has no index to reload")
        backend = store.backend
        if backend.name != "torch" or backend.device.type != DEVICE:
            raise AssertionError(f"reopened store backend is {backend.name} on {backend.device}")
        base_key = f"{CHURN_REPO}/model.safetensors"
        # the main path: counts from 0 just before, read just after
        _build.reset_launch_counts()
        backend.reset_counters()
        r1 = timed("ingest C", lambda: store.ingest_repo(c_dir, CHURN_REPO)[0])
        if not (r1.base_id is None and r1.n_zipnn == len(layers) and r1.n_dedup == kept
                and CHURN_REPO in store.base_paths):
            raise AssertionError(f"C was not stored standalone and bound as a family base: {r1}")
        r2 = timed("re-register", lambda: store.ingest_repo(ft2_dir, ft_a)[0])
        if not (r2.base_id == base_id and r2.n_bitx == n_bitx
                and r2.n_dedup == len(infos) - n_bitx
                and store.file_index[f"{ft_a}/model.safetensors"]["gen"] == 1):
            raise AssertionError(f"{ft_a} re-registered as {r2}, not a new generation of "
                                 f"{n_bitx} BitX records against {base_id} and dedups")
        r3 = timed("whole-file re-upload", lambda: store.ingest_repo(
            os.path.join(hub, base_id), CHURN_REPO)[0])
        if not r3.file_dedup_hit or base_key not in store.base_key_of.values():
            raise AssertionError(f"{CHURN_REPO} taking {base_id}'s bytes: {r3}")
        store.delete_repo(ft_b)
        gc = timed("gc", store.gc)
        compact = timed("compact", store.compact)
        if not (gc["collected"] == 1 and compact["retired_versions"] == 1
                and compact["moved_records"] == moved):
            raise AssertionError(f"gc {gc}, compact {compact}: C's generation was not compacted")
        if not any(h not in store.tensor_locations
                   for *_, h in store._base_tensor_map(CHURN_REPO).values()):
            raise AssertionError("the binding of C outlived none of C's pool entries")
        # the fault of the reference: C again, with the binding to C stale
        r5 = timed("ingest C again", lambda: store.ingest_repo(c_dir, CHURN_REPO)[0])
        if not (r5.base_id is None and r5.n_bitx == 0 and r5.n_dedup == moved + kept):
            raise AssertionError(f"C re-uploaded after compaction as {r5}")
        report = timed("fsck", lambda: store.fsck(spot_check=LIFECYCLE_SPOT_CHECK))
        if not report.ok:
            raise AssertionError(f"fsck: dangling {report.dangling}, corrupt {report.corrupt}")
        store.save_index()
        c_ingest = backend.counters()
    finally:
        store.close()
    store = ZLLMStore(os.path.join(tmp, "store"), workers=min(16, os.cpu_count() or 1),
                      backend=TorchBackend(device=DEVICE), entropy_procs=0)

    both = "retrieve C and the fine-tune after the reload"

    def retrieve(rid):
        t = time.perf_counter()
        got = hashlib.sha256(store.retrieve_file(rid, "model.safetensors")).hexdigest()
        return got, time.perf_counter() - t

    try:
        if not store.load_index():
            raise AssertionError("the lifecycle's index did not reload")
        # C and the re-registered fine-tune (its BitX records, and the records
        # of C that compaction moved) retrieved at once, each by its own thread
        with concurrent.futures.ThreadPoolExecutor(len(want)) as pool:
            got = timed(both,
                        lambda: dict(zip(want, pool.map(retrieve, want))))
        for rid, (sha, sec) in got.items():
            if sha != want[rid]:
                raise AssertionError(f"{rid} retrieved with sha256 {sha}, source {want[rid]}")
            seconds[f"retrieve {rid}"] = sec
        c_reload = store.backend.counters()
    finally:
        store.close()
    launches = _build.launch_counts()
    for name in TorchBackend.KERNELS:
        if not launches.get(name):
            raise AssertionError(f"lifecycle: the {name} kernel was not launched ({launches})")
    mbs = {k: (2 if k == both else 1) * file_bytes / seconds[k] / 1e6
           for k in seconds if k not in ("gc", "compact", "fsck")}
    out = {"card": smi, "file_bytes": file_bytes, "seconds": {k: round(v, 3) for k, v in seconds.items()},
           "mb_per_s": {k: round(v, 1) for k, v in mbs.items()},
           "gc": gc, "compact": compact, "launches": launches, "sequence_launches": seq_launches,
           "kernel_calls": {"before reload": c_ingest["kernel_calls"],
                            "after reload": c_reload["kernel_calls"]}}
    log(f"lifecycle: C stored standalone; {ft_a} re-registered as generation 1 ({r2.n_bitx} BitX "
        f"records against {base_id}, {r2.n_dedup} dedups); {CHURN_REPO} took {base_id}'s bytes "
        f"(file dedup); {ft_b} deleted; gc collected {gc['collected']} versions "
        f"({gc['reclaimed_bytes']} B); compact moved {compact['moved_records']} records "
        f"({compact['moved_bytes']} B), retired {compact['retired_versions']} versions, reclaimed "
        f"{compact['reclaimed_bytes']} B ({compact['net_reclaimed_bytes']} B net); C re-uploaded "
        f"with its binding stale: standalone, {r5.n_dedup} dedups, no BitX record against "
        f"itself; fsck ok (reference graph and structure; no spot decodes); C and {ft_a} "
        f"retrieved with their sources' sha256 after save_index and a reload. Left out to keep "
        f"the smoke in its time limit: the retrieve of {reup} (phase 4 retrieved it, and its "
        f"generation is anchored, so compaction never moves it) and fsck's spot decodes (the "
        f"two retrieves decode every record the churn wrote or compaction moved)")
    log("lifecycle: " + "; ".join(f"{k} {seconds[k]:.2f} s" + (f" ({mbs[k]:.1f} MB/s)" if k in mbs else "")
                                  for k in seconds)
        + f"; kernel launches {launches}; phase {time.perf_counter() - t_phase:.1f} s; card: {smi}")
    return out


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
    """Cold-start a 1-layer Qwen2-7B-width fine-tune from the store and serve
    8 requests; returns the flash launches of the serving run, the kernel's
    largest difference from its plain version on the inputs the run gave it,
    and the float32 model's flash prefills (:func:`float32_flash`)."""
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=SERVE_LAYERS)
    log(f"serve: {cfg.name} widths (d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, head dim {cfg.hd}, QKV bias, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}); depth cut from {qwen2_7b.CONFIG.n_layers} decoder layers to "
        f"{cfg.n_layers}, full-vocabulary embed and lm_head kept")
    hub = os.path.join(tmp, "hub")
    base_id, ft_id = SERVE_REPOS
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
        store.save_index()  # phase 8's server opens this store from its index
        # the cold start reads the store alone: the sources leave the paths the
        # store recorded (phase 8 puts them back, to compare its reads with)
        os.rename(hub, hub + "-sources")
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
    if launches != SERVE_LAYERS * n_prefills or routes != only("sm90", launches):
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

    model_base.flash_attention = checked
    try:
        _serve(engine, prompts)
    finally:
        model_base.flash_attention = flash_attention
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
    logits32 = []
    for batch, lf, lp in zip(prefill.batches, prefill.logits, plain_prefill.logits):
        l32, _ = model32.prefill(params32, batch)
        logits32.append(l32)
        drift["flash"].append(float((lf - l32).abs().max()))
        drift["plain"].append(float((lp - l32).abs().max()))
    # the same float32 parameters and batches through attn="flash": sm90_tf32 at D 128
    f32 = float32_flash("serve", dataclasses.replace(cfg, param_dtype="float32",
                                                     act_dtype="float32"),
                        params32, prefill.batches, model32, logits32, SERVE_LAYERS)
    del params32, logits32
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
    return launches, path_err, f32


F32_LOGIT_TOL = 1e-4  # of the float32 plain model's max |logit|: float32 flash against plain


def float32_flash(name: str, cfg32, params32: dict, batches: list, plain32, logits32: list,
                  n_calls: int) -> dict:
    """The float32 model's prefills through attn="flash" on the batches its
    attn="plain" twin ``plain32`` gave ``logits32``: a run counted from 0
    (exactly ``n_calls`` launches a prefill on the float32 route of the
    model's head dim, sm90_tf32 or tf32, none on another route), each flash
    call held against its plain version on its own inputs, the logits within
    F32_LOGIT_TOL of the plain model's max |logit| and the greedy tokens
    equal; each prefill timed, flash (the counted run) and then plain (both
    warm: ``plain32`` ran these batches already, and the two models run the
    same GEMMs)."""
    def timed(m, b):  # (logits, ms) of one prefill
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = m.prefill(params32, b)
        torch.cuda.synchronize()
        return lg, 1e3 * (time.perf_counter() - t0)

    model = get_model(cfg32, attn="flash")
    route = flash_route(torch.float32, cfg32.hd)
    fa.reset_route_launches()
    _build.reset_launch_counts()
    logits, flash_ms = zip(*(timed(model, b) for b in batches))
    routes, launched = fa.route_launches(), _build.launch_counts()["flash_attention"]
    want = only(route, n_calls * len(batches))
    if routes != want or launched != want[route]:
        raise AssertionError(f"{name} float32 flash: launches by route {routes} ({launched} "
                             f"flash), want {want}")
    errs = []

    def checked(q, k, v, *, causal, window=0):
        got, err = flash_checked(q, k, v, causal, window, route=route)
        errs.append(err)
        return got

    model_base.flash_attention = checked
    try:
        for b in batches:
            model.prefill(params32, b)
    finally:
        model_base.flash_attention = flash_attention
    if len(errs) != want[route]:
        raise AssertionError(f"{name} float32 flash: {len(errs)} calls checked, {want[route]} "
                             f"launched")
    scale = max(float(l.abs().max()) for l in logits32)
    logit_err = max(float((a - b).abs().max()) for a, b in zip(logits, logits32))
    same = all(torch.equal(a.argmax(dim=-1), b.argmax(dim=-1)) for a, b in zip(logits, logits32))
    if not (logit_err <= F32_LOGIT_TOL * scale and same):
        raise AssertionError(f"{name} float32 flash: logits {logit_err} from the plain model's "
                             f"(allowed {F32_LOGIT_TOL} x {scale}), greedy tokens equal: {same}")
    per = {"flash": list(flash_ms), "plain": [timed(plain32, b)[1] for b in batches]}
    r = {"route": route, "launches": want[route], "flash_err": max(errs),
         "logit_err": logit_err,
         "logit_scale": scale, "tokens_equal": same, "prefill_ms": per}
    log(f"{name}: float32 model with attn=flash: {want[route]} {route} launches ({n_calls} a "
        f"prefill x {len(batches)}, none on another route), each held to its plain version "
        f"(max_abs_err {r['flash_err']:.3e}, tolerance 2e-5); logits against the float32 plain "
        f"model's {logit_err:.4e} (allowed {F32_LOGIT_TOL} x max |logit| {scale:.4f}), greedy "
        f"tokens equal; prefill ms flash / plain "
        + ", ".join(f"{f:.2f} / {p:.2f}" for f, p in zip(per["flash"], per["plain"])))
    return r


# ---------------------------------------------------------------------------
# phase 8: the HTTP hub server, a process of its own, over phase 7's store
# ---------------------------------------------------------------------------

HUB_SERVER = ("-m", "repro_torch.serve.store_server")  # the entry point a hub operator runs
HUB_DEVICE = "cuda:0"           # where its store's backend must run
HUB_FT2 = "carol/ft-serve-put"  # the second fine-tune of phase 7's base, PUT over HTTP
HUB_STARTUP_S = 180             # the server must print its address within this
HUB_JOB_S = 900                 # ... and finish the PUT's ingest job within this
HUB_DISTINCT = 8                # concurrent ranged GETs over distinct tensors
HUB_SAME = 4                    # concurrent GETs of one tensor (single-flight)
HUB_WARM = 64                   # ranged GETs of one cached tensor
MIB = 1 << 20
_SERVING = re.compile(r"serving .* on http://([0-9.]+):(\d+)")
# the three BitX reads of each fine-tune, (tensor, window as _window takes
# it): the embedding's last MiB, a slice of q_proj, the whole k_proj (all four
# layers, stacked)
HUB_BITX_READS = (("params/embed", "last MiB"), ("params/blocks.wq", "slice"),
                  ("params/blocks.wk", None))
HUB_BASE_READ = "params/blocks.w_up"  # a base tensor: the ZipNN lane
HUB_DISTINCT_READS = ("params/blocks.wo", "params/blocks.wv", "params/blocks.w_gate",
                      "params/blocks.w_down", "params/lm_head", "params/blocks.bq",
                      "params/blocks.attn_norm", "params/final_norm")
HUB_SAME_READ = "params/blocks.w_up"


class HubServer:
    """``python -m repro_torch.serve.store_server`` as a child process: its
    standard output is read for the address it binds, its standard error goes
    to a file whose tail is part of every failure."""

    def __init__(self, root: str, workers: int, log_path: str):
        here = Path(__file__).resolve().parent
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(here / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self.log_path = log_path
        self._log = open(log_path, "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *HUB_SERVER, "--root", root, "--port", "0",
             "--store-workers", str(workers)],
            stdout=subprocess.PIPE, stderr=self._log, text=True, env=env, cwd=str(here))
        self._lines: "queue.Queue" = queue.Queue()
        self.stdout: list = []
        threading.Thread(target=self._pump, daemon=True).start()
        deadline = t0 + HUB_STARTUP_S
        try:
            while True:
                try:
                    line = self._lines.get(timeout=max(0.1, deadline - time.perf_counter()))
                except queue.Empty:
                    self.fail(f"printed no address within {HUB_STARTUP_S} s")
                if line is None:
                    self.fail("exited before serving")
                m = _SERVING.search(line)
                if m:
                    break
        except BaseException:
            self.kill()
            raise
        self.startup_s = time.perf_counter() - t0
        self.host, self.port = m.group(1), int(m.group(2))

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.stdout.append(line)
            self._lines.put(line)
        self._lines.put(None)

    def fail(self, what: str):
        if not self._log.closed:
            self._log.flush()
        with open(self.log_path) as f:
            err = f.read()[-6000:]
        raise AssertionError(f"hub server (pid {self.proc.pid}, exit code {self.proc.poll()}): "
                             f"{what}\n--- its stdout ---\n{''.join(self.stdout)}"
                             f"--- its stderr (tail) ---\n{err}")

    def alive(self) -> None:
        if self.proc.poll() is not None:
            self.fail("died")

    def stop(self) -> int:
        """SIGINT, as an operator's Ctrl-C; returns the exit code."""
        self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.fail("still running 120 s after SIGINT")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


def _http(server: HubServer, method: str, path: str, headers=None, body=None, sink=None):
    """One request on a fresh connection: (status, headers, body, seconds).
    With ``sink``, the body streams into ``sink(chunk)`` and comes back empty."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=900, blocksize=8 * MIB)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        if sink is None:
            data = r.read()
        else:
            data = b""
            for chunk in iter(lambda: r.read(8 * MIB), b""):
                sink(chunk)
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data, time.perf_counter() - t0
    except (OSError, http.client.HTTPException) as e:
        server.fail(f"{method} {path} failed: {e!r}")
    finally:
        conn.close()


def _stats(server: HubServer) -> dict:
    status, _, body, _ = _http(server, "GET", "/stats")
    if status != 200:
        server.fail(f"/stats answered {status}")
    return json.loads(body)


def _calls(stats: dict) -> dict:
    return stats["store"]["backend_counters"]["kernel_calls"]


def _window(nbytes: int, how) -> tuple:
    """[lo, hi) of a tensor's bytes: None is the whole tensor, "last MiB" its
    last MiB, "slice" 4 MiB from a third of the way in, a fraction f the MiB
    from f of the way in."""
    if how is None:
        return 0, nbytes
    if how == "last MiB":
        return nbytes - min(MIB, nbytes), nbytes
    if how == "slice":
        lo = nbytes // 3
        return lo, min(nbytes, lo + 4 * MIB)
    lo = int(nbytes * how)
    return lo, min(nbytes, lo + MIB)


def _ranged(server: HubServer, sources: dict, repo: str, name: str, how) -> dict:
    """GET one tensor's window of ``repo`` and hold it against the source
    file's bytes; returns the read's codec, size and latency."""
    src = sources[repo]
    want_all = src.tensor_bytes(name)
    lo, hi = _window(len(want_all), how)
    whole = (lo, hi) == (0, len(want_all))
    status, h, body, secs = _http(server, "GET", f"/repo/{repo}/tensor/{name}",
                                  None if whole else {"Range": f"bytes={lo}-{hi - 1}"})
    if status != (200 if whole else 206) or body != bytes(want_all[lo:hi]):
        server.fail(f"GET {repo} {name} [{lo}:{hi}] gave {status} and {len(body)} bytes that "
                    f"are not the source file's")
    return {"repo": repo, "name": name, "bytes": hi - lo, "codec": h.get("x-tensor-codec"),
            "seconds": secs}


def _due(server: HubServer, before: dict, after: dict, kernels, what: str) -> None:
    """A read or write that had to decode or encode on the card launched."""
    for k in kernels:
        if after[k] <= before[k]:
            server.fail(f"{what} ran without a {k} launch (kernel calls {before} -> {after})")


def _gpu_used_mib() -> int:
    """Device memory in use on card 0, all processes, in MiB (``nvidia-smi``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return int(out.split()[0])


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def phase_hub(tmp: str, seed: int, smi: str) -> dict:
    """Serve phase 7's store from ``python -m repro_torch.serve.store_server``
    in a process of its own: ranged tensor GETs (BitX and ZipNN lanes,
    concurrent over distinct tensors and single-flighted over one), a PUT of a
    second 1-layer Qwen2-7B-width fine-tune and a whole-file GET of it, every
    byte held against its source. Returns the server's counts."""
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=SERVE_LAYERS)
    base_id, ft_id = SERVE_REPOS
    hub, root = os.path.join(tmp, "hub"), os.path.join(tmp, "store")
    os.rename(hub + "-sources", hub)  # back where the store recorded its base
    path = lambda rid: os.path.join(hub, rid, "model.safetensors")  # noqa: E731
    lib = _build.library_path()
    lib_before = os.stat(lib)

    # the second fine-tune: phase 7's base drawn again from its seed, every
    # tensor moved by N(0, 0.005^2), declaring that base
    t0 = time.perf_counter()
    base = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed + 3))
    with SafetensorsFile(path(base_id)) as sf:
        for name in ("params/final_norm", "params/blocks.bk", "params/blocks.wk"):
            got = base[name.removeprefix("params/")].view(torch.int16).cpu().numpy().view(np.uint16)
            if not np.array_equal(got, sf.tensor(name)):
                raise AssertionError(f"hub: {name} drawn again differs from phase 7's base")
    ft2 = make_finetune(base, CorpusSpec(untouched_prob=0.0),
                        torch.Generator(device=DEVICE).manual_seed(seed + 4))
    write_repo(hub, HUB_FT2, {f"params/{k}": v for k, v in ft2.items()}, base_model=base_id)
    del base, ft2
    torch.cuda.empty_cache()
    size2 = os.path.getsize(path(HUB_FT2))
    want_sha2 = sha256_file(path(HUB_FT2))
    log(f"hub: wrote the second fine-tune {HUB_FT2} of {base_id} ({size2 / 1e9:.3f} GB, every "
        f"tensor moved by N(0, 0.005^2)) in {time.perf_counter() - t0:.1f} s")

    sources = {rid: SafetensorsFile(path(rid)) for rid in (base_id, ft_id, HUB_FT2)}
    workers = min(16, os.cpu_count() or 1)
    used_before = _gpu_used_mib()
    server = HubServer(root, workers, os.path.join(tmp, "hub-server.stderr"))
    cold, warm = [], []
    try:
        stats = _stats(server)
        c = stats["store"]["backend_counters"]
        if c.get("device") != HUB_DEVICE or stats["store"]["n_files"] != 2 or any(_calls(stats).values()):
            server.fail(f"started on {c.get('device')} with {stats['store']['n_files']} files and "
                        f"kernel calls {_calls(stats)}; want {HUB_DEVICE}, phase 7's 2 files, none yet")
        log(f"hub: server pid {server.proc.pid} serving {root} on http://{server.host}:"
            f"{server.port} after {server.startup_s:.2f} s (process start, imports, index load; "
            f"store workers {workers}); backend {c['device']}")

        # cold ranged reads of the phase-7 fine-tune, then of a base tensor:
        # each is its tensor's first decode in this process, so it must launch
        for name, how in HUB_BITX_READS:
            before = _calls(_stats(server))
            r = _ranged(server, sources, ft_id, name, how)
            after = _calls(_stats(server))
            _due(server, before, after, ["merge_xor"] if r["codec"] == "bitx" else ["merge"],
                 f"GET {ft_id} {name} ({r['codec']})")
            cold.append(r)
        before = _calls(_stats(server))
        r = _ranged(server, sources, base_id, HUB_BASE_READ, 0.5)
        _due(server, before, _calls(_stats(server)), ["merge"], f"GET {base_id} {HUB_BASE_READ}")
        if r["codec"] != "zipnn":
            server.fail(f"{base_id} {HUB_BASE_READ} served from codec {r['codec']}, not zipnn")
        cold.append(r)

        # warm: 1 MiB windows of the k_proj read whole above, from the decoded cache
        before = _calls(_stats(server))
        rng = np.random.default_rng(seed)
        for f in rng.random(HUB_WARM):
            warm.append(_ranged(server, sources, ft_id, "params/blocks.wk", float(f) * 0.9)["seconds"])
        warm_calls = sum(_calls(_stats(server)).values()) - sum(before.values())

        # concurrent: distinct tensors, then one tensor (single-flight)
        before = _stats(server)
        with concurrent.futures.ThreadPoolExecutor(HUB_DISTINCT) as pool:
            rs = list(pool.map(lambda n: _ranged(server, sources, ft_id, n, 0.5),
                               HUB_DISTINCT_READS))
        mid = _stats(server)
        _due(server, _calls(before), _calls(mid),
             ["merge_xor"] if any(r["codec"] == "bitx" for r in rs) else ["merge"],
             f"{HUB_DISTINCT} concurrent GETs of distinct tensors")
        cold += rs
        with concurrent.futures.ThreadPoolExecutor(HUB_SAME) as pool:
            same = list(pool.map(lambda f: _ranged(server, sources, ft_id, HUB_SAME_READ, f),
                                 [i / HUB_SAME for i in range(HUB_SAME)]))
        after = _stats(server)
        sf0, sf1 = mid["server"]["singleflight"], after["server"]["singleflight"]
        leaders, joined = sf1["leaders"] - sf0["leaders"], sf1["joined"] - sf0["joined"]
        if joined < 1:
            server.fail(f"{HUB_SAME} concurrent GETs of {HUB_SAME_READ} decoded {leaders} times "
                        f"and shared no flight")
        cold += same
        log(f"hub: {len(rs)} concurrent ranged GETs over distinct tensors and {HUB_SAME} of "
            f"{HUB_SAME_READ} (single-flight: {leaders} decode, {joined} joined) equal the source")

        # remote write: PUT the second fine-tune, poll its ingest job
        before = _calls(_stats(server))
        t0 = time.perf_counter()
        with open(path(HUB_FT2), "rb") as body:
            status, _, out, t_upload = _http(
                server, "PUT", f"/repo/{HUB_FT2}/file/model.safetensors?base={base_id}",
                headers={"content-length": str(size2)}, body=body)
        if status != 202:
            server.fail(f"PUT answered {status}: {out[:2000]!r}")
        job_id = json.loads(out)["job_id"]
        while True:
            server.alive()
            _, _, out, _ = _http(server, "GET", f"/admin/jobs?job={job_id}")
            job = json.loads(out)
            if job["state"] in ("done", "failed"):
                break
            if time.perf_counter() - t0 > HUB_JOB_S:
                server.fail(f"ingest job {job_id} not done after {HUB_JOB_S} s: {job}")
            time.sleep(0.5)
        t_put = time.perf_counter() - t0
        res = (job.get("results") or [{}])[0]
        n_tensors = len(sources[HUB_FT2].names())
        if job["state"] != "done" or res.get("base_id") != base_id or res.get("n_bitx") != n_tensors:
            server.fail(f"the PUT's ingest job ended {job}; want done, BitX-coded against "
                        f"{base_id}, all {n_tensors} tensors")
        _due(server, before, _calls(_stats(server)), ["xor_split"], "the PUT's ingest")
        log(f"hub: PUT {HUB_FT2} ({size2} bytes; upload {t_upload:.2f} s) and its ingest job "
            f"{t_put:.2f} s: {size2 / t_put / 1e6:.1f} MB/s, all {n_tensors} tensors BitX-coded "
            f"against {base_id}, stored {res.get('stored_bytes')} bytes; card: {smi}")

        # the three BitX reads of the new fine-tune, then the whole file
        before = _calls(_stats(server))
        for name, how in HUB_BITX_READS:
            r = _ranged(server, sources, HUB_FT2, name, how)
            if r["codec"] != "bitx":
                server.fail(f"{HUB_FT2} {name} served from codec {r['codec']}, not bitx")
            cold.append(r)
        _due(server, before, _calls(_stats(server)), ["merge_xor"], f"the BitX GETs of {HUB_FT2}")
        h = hashlib.sha256()
        status, hdr, _, t_get = _http(server, "GET", f"/repo/{HUB_FT2}/file/model.safetensors",
                                      sink=h.update)
        if status != 200 or h.hexdigest() != want_sha2:
            server.fail(f"whole-file GET of {HUB_FT2} gave {status}, sha256 {h.hexdigest()}; "
                        f"the uploaded file's is {want_sha2}")
        log(f"hub: GET of the whole {HUB_FT2} ({size2} bytes) in {t_get:.2f} s: "
            f"{size2 / t_get / 1e6:.1f} MB/s, sha256 equal to the uploaded file's; card: {smi}")

        stats = _stats(server)
        c = stats["store"]["backend_counters"]
        if c["device"] != HUB_DEVICE or any(c["kernel_calls"][k] == 0
                                          for k in ("xor_split", "merge_xor", "merge")):
            server.fail(f"the server's counters show {c}")
        q = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                            "--format=csv,noheader"], capture_output=True, text=True)
        apps = [a.split(",") for a in q.stdout.strip().splitlines() if "," in a]
        mine = [m.strip() for pid, m in apps if pid.strip() == str(server.proc.pid)]
        smi_mem = (mine[0] if mine else
                   f"not listed (exit code {q.returncode}; it lists {q.stdout.strip()!r} "
                   f"{q.stderr.strip()!r})")
        used_delta = _gpu_used_mib() - used_before
        rc = server.stop()
        if rc != 0:
            server.fail(f"exited with code {rc} after SIGINT")
    finally:
        server.kill()
        for sf in sources.values():
            sf.close()
    lib_after = os.stat(lib)
    if (lib_after.st_ino, lib_after.st_mtime_ns) != (lib_before.st_ino, lib_before.st_mtime_ns):
        raise AssertionError(f"hub: the server rebuilt {lib} instead of loading phase 2's build")

    lat = [r["seconds"] * 1e3 for r in cold]
    out = {
        "card": smi, "startup_s": server.startup_s,
        "put_ingest_MBps": size2 / t_put / 1e6, "put_ingest_s": t_put, "upload_s": t_upload,
        "get_file_MBps": size2 / t_get / 1e6, "get_file_s": t_get, "file_bytes": size2,
        "ranged_cold_ms": {"n": len(lat), "p50": _pct(lat, 50), "p99": _pct(lat, 99)},
        "ranged_warm_ms": {"n": len(warm), "p50": _pct([w * 1e3 for w in warm], 50),
                           "p99": _pct([w * 1e3 for w in warm], 99), "kernel_calls": warm_calls},
        "singleflight": {"leaders": leaders, "joined": joined},
        "kernel_calls": c["kernel_calls"], "h2d_bytes": c["h2d_bytes"],
        "d2h_bytes": c["d2h_bytes"], "peak_allocated_bytes": c["peak_allocated_bytes"],
        "nvidia_smi_used_memory": smi_mem, "card_used_delta_mib": used_delta,
        "device": c["device"], "exit_code": rc,
        "reads": [[r["repo"], r["name"], r["codec"], r["bytes"], r["seconds"] * 1e3] for r in cold],
    }
    log(f"hub: ranged GET latency, first decode of each tensor: p50 {out['ranged_cold_ms']['p50']:.2f}"
        f" ms, p99 {out['ranged_cold_ms']['p99']:.2f} ms over {len(lat)} reads (codecs "
        f"{sorted(set(r['codec'] for r in cold))}); from the decoded cache (1 MiB of k_proj): p50 "
        f"{out['ranged_warm_ms']['p50']:.3f} ms, p99 {out['ranged_warm_ms']['p99']:.3f} ms over "
        f"{len(warm)} reads ({warm_calls} kernel calls); card: {smi}")
    log(f"hub: server kernel launches {c['kernel_calls']}, H2D {c['h2d_bytes']} B, D2H "
        f"{c['d2h_bytes']} B on {c['device']}; card: {smi}")
    log(f"hub: server device memory: nvidia-smi by pid: {smi_mem}; the card's memory in use rose "
        f"{used_delta} MiB from before the server started to its last request (phases 9-12 run "
        f"beside it in another process, so this counts theirs too); peak PyTorch "
        f"allocation {c['peak_allocated_bytes'] / 2**30:.2f} GiB; exited {rc} on SIGINT; kernel library "
        f"loaded from phase 2's build, not rebuilt; card: {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the SSM and whisper families served on the card
# ---------------------------------------------------------------------------

FAMILY_BATCH = 4
WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_NEW = 1500, 64, 32  # 30 s of audio after the conv stub
LM_PROMPT, LM_NEW = 1024, 16    # zamba2 and falcon-mamba: multiples of the scan chunk 128
MAMBA_LAYERS = 2                # falcon-mamba's depth cut (of 64)
MAMBA_REPOS = ("tiiuae/falcon-mamba-base", "alice/falcon-mamba-ft")  # base, fine-tune declaring it
# The bf16 engines' prefill logits are held to a float32 copy of the model on
# the same parameters and inputs. bf16 keeps 8 significant bits (a relative
# rounding of 2^-9, about 0.2%); each layer rounds its residual stream and its
# block outputs to bf16 a handful of times, and if those errors add like a
# random walk the logits stray by about 0.002 * sqrt(10 * layers) of their
# scale: 0.02-0.03 at whisper's 48 layers and zamba2's 63 blocks. FAMILY_DRIFT
# allows 0.1 of the float32 model's largest |logit|, so a fault (a wrong mask,
# cache or scan) that moves the logits by their own scale fails, and the
# flash engine must stray no more than SERVE_DRIFT times as far as the plain
# engine, as in phase 7.
FAMILY_DRIFT = 0.1
# Prefill of S tokens plus one decode step against prefill of S + 1. The
# float32 copy of each model is held to tests/test_models_smoke.py:106's 2e-2
# (as rtol and atol; float32 rounding over sums of up to 10240 terms and 48-63
# blocks stays far below it): it shows that decode computes what prefill does.
# The bf16 engines round at other points in a one-token decode than in a
# prefill (GEMMs of 4 rows against 4 x S rows sum in another order); at
# whisper-medium's 48 layers that alone moves logits by about 0.025 of a 2.6
# scale on an H100, past 2e-2 as rtol and atol. So the bf16 engines are held
# to the bf16 allowance of the prefill logits, FAMILY_DRIFT of the float32
# model's scale, and the flash engine (prefill through the kernel, decode
# through layers.attention) also to SERVE_DRIFT times the larger of the plain
# engine's figure and of the flash and plain engines' difference at S + 1.
CONSISTENCY_S = 128
CONSISTENCY_TOL = 2e-2
# the cache entries the engine must grow before decode, per family
FAMILY_GROWS = {"encdec": {"self_k", "self_v"}, "hybrid": {"attn_k", "attn_v"}, "ssm": set()}


def _generate(engine: ServeEngine, prompts: np.ndarray, n_new: int, extra=None) -> dict:
    """``engine.generate`` once, timed: the result, the prefill and decode
    timers, the wall time and the cache shapes before and after ``_pad_cache``."""
    model = engine.model
    prefill, decode = _Timed(model.prefill), _Timed(model.decode_step)
    model.prefill, model.decode_step = prefill, decode
    pads = []
    pad = engine._pad_cache

    def recorded(cache, extra_len):
        out = pad(cache, extra_len)
        pads.append(({k: tuple(v.shape) for k, v in cache.items() if k != "len"},
                     {k: tuple(v.shape) for k, v in out.items() if k != "len"},
                     {k: out[k] is v for k, v in cache.items() if k != "len"}))
        return out

    engine._pad_cache = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(prompts, n_new, extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step, engine._pad_cache
    return {"res": res, "prefill": prefill, "decode": decode, "wall": wall, "pads": pads}


def _check_growth(name: str, family: str, pads, n_new: int) -> None:
    """``_pad_cache`` grew exactly the family's growing entries, by n_new
    along axis 2, and handed every other entry on as it was."""
    (before, after, same), = pads
    want = FAMILY_GROWS[family]
    grew = {k for k in before if after[k] != before[k]}
    if grew != want:
        raise AssertionError(f"{name}: _pad_cache grew {sorted(grew)}, want {sorted(want)}")
    for k in before:
        if k in want:
            exp = before[k][:2] + (before[k][2] + n_new,) + before[k][3:]
            if after[k] != exp:
                raise AssertionError(f"{name}: {k} grew {before[k]} -> {after[k]}, want {exp}")
        elif not same[k]:
            raise AssertionError(f"{name}: _pad_cache copied {k}, which does not grow")


def _cache_bytes(cache: dict) -> int:
    return sum(v.numel() * v.element_size() for k, v in cache.items() if k != "len")


def _family_checks(name: str, cfg, engine: ServeEngine, batch: dict, route, module,
                   n_calls: int = 0) -> dict:
    """On the served prefill's batch: every flash call held against its plain
    version (route asserted), the flash and plain engines' logits against the
    float32 model's, the float32 model through attn="flash" (``n_calls``
    launches a prefill on its float32 route; :func:`float32_flash`) where the
    family attends, and
    prefill S + decode one against prefill S + 1."""
    out = {}
    model, params = engine.model, engine.params
    # the same prefill again, warm (the served one was the process's first
    # call of these shapes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch)
    torch.cuda.synchronize()
    out["warm_prefill_ms"] = 1e3 * (time.perf_counter() - t0)
    log(f"families {name}: prefill again, warm: {out['warm_prefill_ms']:.2f} ms")
    # the kernel on exactly the tensors the path gives it, after the counted
    # run (these launches are not counted)
    errs = []
    if route is not None:
        def checked(q, k, v, *, causal, window=0):
            got, err = flash_checked(q, k, v, causal, window, route=route)
            errs.append((tuple(q.shape), tuple(k.shape), causal, err))
            return got

        module.flash_attention = checked
        try:
            lf, _ = model.prefill(params, batch)
        finally:
            module.flash_attention = flash_attention
        out["flash_calls"] = len(errs)
        out["flash_err"] = max(e for *_, e in errs)
        log(f"families {name}: each of the {len(errs)} flash calls of a prefill took the {route} "
            f"route and equals its plain version on its own inputs (q/k shapes, causal: "
            f"{sorted(set(e[:3] for e in errs))}; max_abs_err {out['flash_err']:.3e}, tolerance "
            f"2e-2 as rtol and atol)")
    else:
        lf, _ = model.prefill(params, batch)
    plain = ServeEngine(cfg, params, device=DEVICE, attn="plain")
    before = _build.launch_counts()["flash_attention"]
    lp, _ = plain.model.prefill(params, batch)
    if _build.launch_counts()["flash_attention"] != before:
        raise AssertionError(f"families {name}: the plain engine launched the flash kernel")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")
    model32 = get_model(cfg32, attn="plain")
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    params32 = {k: v.float() for k, v in params.items()}
    l32, _ = model32.prefill(params32, batch32)
    if route is not None:
        out["float32_flash"] = float32_flash(f"families {name}", cfg32, params32, [batch32],
                                             model32, [l32], n_calls)
    scale = float(l32.abs().max())
    drift = {"flash": float((lf - l32).abs().max()), "plain": float((lp - l32).abs().max())}
    if not (max(drift.values()) <= FAMILY_DRIFT * scale
            and drift["flash"] <= SERVE_DRIFT * drift["plain"]):
        raise AssertionError(f"families {name}: prefill logits stray {drift} from the float32 "
                             f"model's (max |logit| {scale}); allowed {FAMILY_DRIFT} of it, and "
                             f"flash at most {SERVE_DRIFT}x plain")
    out.update(logit_scale=scale, drift_flash=drift["flash"], drift_plain=drift["plain"],
               flash_vs_plain=float((lf - lp).abs().max()))
    log(f"families {name}: prefill logits (float32 model's max |logit| {scale:.4f}) against the "
        f"float32 model's: flash engine {drift['flash']:.4e}, plain engine {drift['plain']:.4e} "
        f"(allowed {FAMILY_DRIFT} x {scale:.4f}, and flash at most {SERVE_DRIFT}x plain); "
        f"flash against plain {out['flash_vs_plain']:.4e}")

    # prefill S + one decode step against prefill S + 1, on the float32
    # model, the plain engine and the flash engine (decode always attends
    # through layers.attention)
    S = min(CONSISTENCY_S, batch["tokens"].shape[1])
    errs = {}
    fulls = {}
    for which, m, p, b in (("float32", model32, params32, batch32), ("plain", plain.model, params,
                                                                       batch),
                           ("flash", model, params, batch)):
        short = dict(b, tokens=b["tokens"][:, :S])
        lg, cache = m.prefill(p, short)
        nxt = lg.argmax(dim=-1).to(torch.int32)[:, None]
        ld, _ = m.decode_step(p, {"tokens": nxt}, engine._pad_cache(cache, 1))
        lfull, _ = m.prefill(p, dict(short, tokens=torch.cat([short["tokens"], nxt], dim=1)))
        diff = (ld - lfull).abs()
        ok = (bool((diff <= CONSISTENCY_TOL + CONSISTENCY_TOL * lfull.abs()).all())
              if which == "float32" else float(diff.max()) <= FAMILY_DRIFT * scale)
        errs[which] = (float(diff.max()), ok)
        fulls[which] = lfull
    del params32
    torch.cuda.empty_cache()
    noise = float((fulls["flash"] - fulls["plain"]).abs().max())
    if not (all(ok for _, ok in errs.values())
            and errs["flash"][0] <= SERVE_DRIFT * max(noise, errs["plain"][0])):
        raise AssertionError(f"families {name}: prefill {S} + decode against prefill {S + 1}: "
                             f"{errs} (flash engine against plain at {S + 1}: {noise})")
    out.update(consistency_err={k: e for k, (e, _) in errs.items()}, consistency_noise=noise)
    log(f"families {name}: prefill of {S} tokens + one decode step against prefill of {S + 1}, "
        f"max_abs_err: float32 model {errs['float32'][0]:.4e} (tolerance {CONSISTENCY_TOL} as rtol "
        f"and atol), plain engine {errs['plain'][0]:.4e} (allowed {FAMILY_DRIFT} x {scale:.4f}), "
        f"flash engine {errs['flash'][0]:.4e} (allowed that too, and {SERVE_DRIFT}x the larger of "
        f"the plain engine's and of the flash and plain engines' difference at {S + 1}, "
        f"{noise:.4e})")
    return out


def _family_serve(name: str, cfg, engine: ServeEngine, prompts, n_new: int, extra, route,
                  per_prefill: int, smi: str) -> tuple:
    """The counted serving run: counts from 0 just before, read just after.
    Returns (report, flash launches by route)."""
    _build.reset_launch_counts()
    fa.reset_route_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _generate(engine, prompts, n_new, extra)
    launches = _build.launch_counts()["flash_attention"]
    routes = fa.route_launches()
    peak = torch.cuda.max_memory_allocated()
    want = {r: per_prefill if r == route else 0 for r in routes}
    if launches != per_prefill or routes != want:
        raise AssertionError(f"families {name}: {launches} flash launches by route {routes}, "
                             f"want {want}")
    toks = run["res"].tokens
    B, S = prompts.shape
    if toks.shape != (B, S + n_new) or not ((0 <= toks) & (toks < cfg.vocab)).all():
        raise AssertionError(f"families {name}: bad generated tokens {toks[:, S:]}")
    for lg in run["prefill"].logits + run["decode"].logits:
        if not torch.isfinite(lg).all() or lg.shape != (B, cfg.vocab):
            raise AssertionError(f"families {name}: non-finite or misshapen logits")
    _check_growth(name, cfg.family, run["pads"], n_new)
    pre_ms = 1e3 * run["prefill"].seconds[0]
    dec_ms = 1e3 * sum(run["decode"].seconds) / len(run["decode"].seconds)
    r = {"prefill_ms": pre_ms, "decode_ms": dec_ms, "tok_per_s": B * n_new / run["wall"],
         "wall_s": run["wall"], "peak_bytes": peak, "flash_launches": routes,
         "grown": sorted(k for k in run["pads"][0][0]
                         if run["pads"][0][1][k] != run["pads"][0][0][k]), "card": smi}
    log(f"families {name}: {B} prompts of {S} tokens, {n_new} new each, in {run['wall']:.3f} s: "
        f"{r['tok_per_s']:.1f} generated tokens/s; prefill {pre_ms:.2f} ms; decode {dec_ms:.3f} ms "
        f"per step ({len(run['decode'].seconds)} steps); peak device memory {peak / 2**30:.2f} GiB; "
        f"flash launches by route {routes}; _pad_cache grew {r['grown']}; card: {smi}")
    return r, routes


def _time_flash(B: int, S: int, H: int, D: int, causal: bool, route: str,
                gen: torch.Generator, dtype=torch.bfloat16) -> dict:
    """One flash shape timed on ``route`` beside its bound, its plain version
    and scaled_dot_product_attention (its backend named; float32 with TF32
    off, as phase 3 sets it). The route's kernel is launched directly, as
    phase 3 does, so a route the wrapper does not pick at this shape is timed
    too."""
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=DEVICE).to(dtype)
               for _ in range(3))
    fn = lambda: fa._launch(route, q, k, v, causal, 0)  # noqa: E731
    err = held_to_plain(fn(), q, k, v, causal)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    r = {"shape": [B, S, H, D], "causal": causal, "dtype": str(dtype).split(".")[-1],
         "route": route, "max_abs_err": err, "ms": cuda_ms(fn), "host_us": host_us(fn),
         "plain_ms": cuda_ms(lambda: ref.mha_reference(q, k, v, causal=causal), iters=3),
         "library_backend": sdpa_backend(qt, kt, vt, causal),
         "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
             qt, kt, vt, is_causal=causal))}
    r["bound_ms"], r["bound_by"] = flash_bound(B, S, H, D, causal, dtype)
    log(f"kernel {FLASH[route]['name']} ({route}): {r['ms']:.4f} ms at B={B} S={S} H={H} D={D} "
        f"{r['dtype']} {'causal' if causal else 'bidirectional'} (bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it); host {r['host_us']:.1f} us per "
        f"call; plain version {r['plain_ms']:.4f} ms; library: {FLASH_LIBRARY} "
        f"({r['library_backend']}) {r['library_ms']:.4f} ms ({r['library_ms'] / r['ms']:.2f}x the "
        f"kernel's speed); max_abs_err {err:.3e} (tolerance {'2e-5' if dtype == torch.float32 else '2e-2'})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return r


def phase_whisper(seed: int, smi: str) -> tuple:
    """9a: whisper-medium at published widths and depth."""
    cfg = whisper_medium.CONFIG
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in params.values())
    log(f"families whisper: {cfg.name} ({cfg.n_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.param_dtype}): {n_params / 1e9:.3f} G params drawn on the card; frames "
        f"stub ({FAMILY_BATCH}, {WHISPER_FRAMES}, {cfg.d_model}), prompts {FAMILY_BATCH} x "
        f"{WHISPER_PROMPT}, {WHISPER_NEW} new tokens")
    frames = (torch.randn((FAMILY_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                          device=DEVICE) * 0.02).to(torch.bfloat16)
    prompts = np.random.default_rng(seed + 5).integers(
        1, cfg.vocab, (FAMILY_BATCH, WHISPER_PROMPT)).astype(np.int32)
    engine = ServeEngine(cfg, params, device=DEVICE)
    del params
    report, routes = _family_serve("whisper", cfg, engine, prompts, WHISPER_NEW,
                                   {"frames": frames}, "sm90", 3 * cfg.n_layers, smi)
    batch = {"tokens": torch.as_tensor(prompts, device=DEVICE), "frames": frames}
    report.update(_family_checks("whisper", cfg, engine, batch, "sm90", model_base,
                                 3 * cfg.n_layers))
    report["seconds"] = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    return report, routes


ZAMBA2_ROUTE_PAIRS = 4  # warm prefills per route in the comparison below


def _prefill_by_route(name: str, engine: ServeEngine, batch: dict, module, n_calls: int) -> dict:
    """Warm prefill ms with the path's flash calls on sm90, as served, and
    with the same calls sent to the tf32 kernel (which takes bf16 operands
    that TMA cannot address), in turns (sm90, tf32, tf32, sm90, ...): what
    the route is worth end to end. The tf32 launches of these rerouted
    prefills are off the path: they are summed from the route counts under
    their own name."""
    def tf32(q, k, v, *, causal, window=0):
        return fa._launch("tf32", q, k, v, causal, window)

    ms = {"sm90": [], "tf32": []}
    rerouted = 0
    for i in range(ZAMBA2_ROUTE_PAIRS):
        for r in (("sm90", "tf32") if i % 2 == 0 else ("tf32", "sm90")):
            module.flash_attention = tf32 if r == "tf32" else flash_attention
            fa.reset_route_launches()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.model.prefill(engine.params, batch)
                torch.cuda.synchronize()
            finally:
                module.flash_attention = flash_attention
            ms[r].append(1e3 * (time.perf_counter() - t0))
            launched = fa.route_launches()
            if launched != only(r, n_calls):
                raise AssertionError(f"families {name}: a prefill sent to {r} launched "
                                     f"{launched}, want {n_calls} on {r}")
            rerouted += launched["tf32"]
    med = {r: float(np.median(v)) for r, v in ms.items()}
    log(f"families {name}: warm prefill with its {n_calls} flash calls on sm90 / on tf32, in "
        f"turns: medians {med['sm90']:.2f} / {med['tf32']:.2f} ms (difference "
        f"{med['tf32'] - med['sm90']:.2f} ms; runs sm90 {[round(x, 2) for x in ms['sm90']]}, tf32 "
        f"{[round(x, 2) for x in ms['tf32']]})")
    return {"ms": ms, "median_ms": med, "rerouted_tf32_launches": rerouted}


def phase_zamba2(seed: int, smi: str) -> tuple:
    """9b: zamba2-2.7b at published widths and depth."""
    cfg = zamba2_2_7b.CONFIG
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 6)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in params.values())
    n_groups = cfg.n_layers // cfg.attn_every
    log(f"families zamba2: {cfg.name} ({cfg.n_layers} Mamba-2 layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.d_inner}, state {cfg.ssm.d_state}, one shared block of {cfg.n_heads} heads "
        f"of dim {cfg.hd} invoked {n_groups} times, vocab {cfg.vocab}, {cfg.param_dtype}): "
        f"{n_params / 1e9:.3f} G params drawn on the card; prompts {FAMILY_BATCH} x {LM_PROMPT}, "
        f"{LM_NEW} new tokens")
    prompts = np.random.default_rng(seed + 6).integers(
        1, cfg.vocab, (FAMILY_BATCH, LM_PROMPT)).astype(np.int32)
    engine = ServeEngine(cfg, params, device=DEVICE)
    del params
    report, routes = _family_serve("zamba2", cfg, engine, prompts, LM_NEW, None, "sm90",
                                   n_groups, smi)
    log(f"families zamba2: prefill {report['prefill_ms']:.2f} ms on the sm90 route")
    batch = {"tokens": torch.as_tensor(prompts, device=DEVICE)}
    report.update(_family_checks("zamba2", cfg, engine, batch, "sm90", model_base, n_groups))
    report["prefill_by_route"] = _prefill_by_route("zamba2", engine, batch, model_base, n_groups)
    report["seconds"] = time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    return report, routes


class _Widths:
    """Records the word width of every BitX launch the store's backend makes."""

    def __init__(self):
        self.seen = {"xor_split": set(), "merge_xor": set()}
        self._orig = (bitx.xor_split, bitx.merge_xor)

    def __enter__(self):
        xs, mx = self._orig

        def xor_split(a, b, nb):
            self.seen["xor_split"].add(nb)
            return xs(a, b, nb)

        def merge_xor(planes, base):
            self.seen["merge_xor"].add(planes.shape[0])
            return mx(planes, base)

        bitx.xor_split, bitx.merge_xor = xor_split, merge_xor
        return self

    def __exit__(self, *exc):
        bitx.xor_split, bitx.merge_xor = self._orig


def phase_mamba(tmp: str, seed: int, smi: str) -> tuple:
    """9c: falcon-mamba-7b at published widths, depth cut to 2, stored and
    cold-started from the port's store, then served."""
    cfg = dataclasses.replace(falcon_mamba_7b.CONFIG, n_layers=MAMBA_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    base = init_params(cfg, gen)
    ft = make_finetune(base, CorpusSpec(untouched_prob=0.0), gen)
    n_params = sum(t.numel() for t in base.values())
    hub = os.path.join(tmp, "hub-mamba")
    base_id, ft_id = MAMBA_REPOS
    write_repo(hub, base_id, {f"params/{k}": v for k, v in base.items()})
    write_repo(hub, ft_id, {f"params/{k}": v for k, v in ft.items()}, base_model=base_id)
    del base
    torch.cuda.empty_cache()
    size = os.path.getsize(os.path.join(hub, ft_id, "model.safetensors"))
    f32 = sorted(k for k, v in ft.items() if v.dtype == torch.float32)
    log(f"families mamba: {cfg.name} widths (d_model {cfg.d_model}, d_inner {cfg.d_inner}, state "
        f"{cfg.ssm.d_state}, conv {cfg.ssm.d_conv}, vocab {cfg.vocab}, {cfg.param_dtype} with "
        f"float32 {f32}); depth cut from {falcon_mamba_7b.CONFIG.n_layers} layers to "
        f"{cfg.n_layers}, full-vocabulary embed and lm_head kept; base and fine-tune "
        f"({n_params / 1e9:.3f} G params, {size / 1e9:.3f} GB each) written in "
        f"{time.perf_counter() - t0:.1f} s")

    store = ZLLMStore(os.path.join(tmp, "store-mamba"), workers=min(16, os.cpu_count() or 1),
                      entropy_procs=0)
    try:
        _build.reset_launch_counts()
        with _Widths() as widths:
            t1 = time.perf_counter()
            store.ingest_repo(os.path.join(hub, base_id), base_id)
            res = store.ingest_repo(os.path.join(hub, ft_id), ft_id)[0]
            t_ingest = time.perf_counter() - t1
            if not (res.base_id == base_id and res.n_bitx == len(ft)):
                raise AssertionError(f"families mamba: the fine-tune was not BitX-coded against "
                                     f"its base in every tensor: {res}")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            engine = ServeEngine.from_store(store, ft_id, "model.safetensors", cfg, device=DEVICE)
            torch.cuda.synchronize()
            t_cold = time.perf_counter() - t1
        store_launches = _build.launch_counts()
    finally:
        store.close()
    if not ({2, 4} <= widths.seen["xor_split"] and {2, 4} <= widths.seen["merge_xor"]):
        raise AssertionError(f"families mamba: BitX word widths {widths.seen}; the float32 "
                             f"tensors must take 4-byte words, the bf16 ones 2-byte")
    for k, t in ft.items():
        got = engine.params[k]
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        if got.dtype != t.dtype or got.shape != t.shape or not torch.equal(got.view(bits),
                                                                           t.view(bits)):
            raise AssertionError(f"families mamba: cold-started {k} is not bit-equal to the source")
    del ft
    torch.cuda.empty_cache()
    raw = 2 * size
    log(f"families mamba: ingest of base + fine-tune {t_ingest:.2f} s ({raw / t_ingest / 1e6:.1f} "
        f"MB/s; every fine-tune tensor BitX-coded against {base_id}, word widths {widths.seen}); "
        f"cold start (retrieve, verify sha256, parse, load to the card) {t_cold:.2f} s; all "
        f"{len(engine.params)} params bit-equal to the source; store kernel launches "
        f"{ {k: v for k, v in store_launches.items() if v} }; card: {smi}")

    prompts = np.random.default_rng(seed + 7).integers(
        1, cfg.vocab, (FAMILY_BATCH, LM_PROMPT)).astype(np.int32)
    report, routes = _family_serve("mamba", cfg, engine, prompts, LM_NEW, None, None, 0, smi)
    batch = {"tokens": torch.as_tensor(prompts, device=DEVICE)}
    sizes = {}
    for S in (CONSISTENCY_S, LM_PROMPT):
        _, cache = engine.model.prefill(engine.params, {"tokens": batch["tokens"][:, :S]})
        sizes[S] = _cache_bytes(engine._pad_cache(cache, LM_NEW))
    if len(set(sizes.values())) != 1:
        raise AssertionError(f"families mamba: cache bytes by prompt length {sizes}")
    log(f"families mamba: cache bytes after _pad_cache {sizes} by prompt length: O(1)")
    report.update(_family_checks("mamba", cfg, engine, batch, None, None))
    report.update(ingest_MBps=raw / t_ingest, ingest_s=t_ingest, cold_start_s=t_cold,
                  cache_bytes=sizes[LM_PROMPT], seconds=time.perf_counter() - t0,
                  bitx_widths={k: sorted(v) for k, v in widths.seen.items()})
    del engine
    torch.cuda.empty_cache()
    return report, routes


def phase_families(tmp: str, seed: int, smi: str) -> dict:
    """Phase 9: the three families through ``ServeEngine.generate`` with
    attn="flash", and the flash kernel timed at their shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False        # and the SSMs' float32 depthwise conv
    t0 = time.perf_counter()
    out = {}
    out["whisper"], r_w = phase_whisper(seed, smi)
    out["zamba2"], r_z = phase_zamba2(seed, smi)
    out["mamba"], _ = phase_mamba(tmp, seed, smi)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 8)
    # zamba2's shared attention on tf32 in bf16 (phase 3 times it on sm90)
    zamba2 = (FAMILY_BATCH, LM_PROMPT, zamba2_2_7b.CONFIG.n_heads, zamba2_2_7b.CONFIG.hd, True)
    out["timed"] = {"tf32_zamba2": _time_flash(*zamba2, "tf32", gen)}
    out["launches"] = {r: r_w[r] + r_z[r] for r in r_w}
    out["seconds"] = time.perf_counter() - t0
    log(f"families: phase 9 took {out['seconds']:.1f} s (whisper {out['whisper']['seconds']:.1f}, "
        f"zamba2 {out['zamba2']['seconds']:.1f}, mamba {out['mamba']['seconds']:.1f}); flash "
        f"launches on its paths by route {out['launches']}; card: {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 10: training on the card, checkpoints BitX-chained through the store
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 2                # Qwen2-7B's depth cut (of 28), as in phase 4
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 1024, 4, 2
TRAIN_STEPS = 8
TRAIN_ASYNC_AT = 4              # save_async after this step (overlaps the next); save at the last
TRAIN_LR = 3e-4                 # the training CLI's default; warmup and schedule are
                                # OptimizerConfig's (100 warmup steps of 10,000): the
                                # first steps of a real run
TRAIN_RUN = "qwen2-7b-train"
TRAIN_REMAT_TOL = 1e-5          # relative: loss and grad norm under "none" and "dots" vs "nothing"
TRAIN_EVAL_TOL = 1e-6           # relative: eval loss on the restored params vs the live ones
# the training entry point a user runs, and its crash-and-resume demo
TRAIN_CLI = ("-m", "repro_torch.launch.train", "--arch", "qwen2-7b", "--smoke", "--steps", "8",
             "--ckpt-every", "3", "--fail-at", "5")
TRAIN_CLI_RUN = "qwen2-7b-smoke-run"
TRAIN_CLI_S = 300               # each CLI run must end within this
_CKPT_LINE = re.compile(r"\[train\] checkpoint (\S+): base (\S+) \((\w+)\), (\d+) BitX / (\d+) ZipNN")


class _TimedManager(CheckpointManager):
    """The checkpoint manager, with the start and end of each save recorded."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spans = {}

    def _write(self, step, flat, path):
        t0 = time.perf_counter()
        try:
            return super()._write(step, flat, path)
        finally:
            self.spans[step] = (t0, time.perf_counter())


class _NoUpdate:
    """An optimizer that leaves parameters and state as they are: a train step
    under it gives the loss and gradient norm at the parameters it is given."""

    def update(self, grads, state, params):
        return params, state


def _train_full_width(tmp: str, seed: int, smi: str) -> dict:
    """10a: the 2-layer Qwen2-7B-width model trained 8 steps on the card, a
    write-behind checkpoint and a synchronous one through the store
    (compressed only), a restore checked bit for bit, and the remat policies."""
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=TRAIN_LAYERS)
    log(f"train: {cfg.name} widths (d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, QKV bias, vocab {cfg.vocab}, {cfg.param_dtype} params); depth "
        f"cut from {qwen2_7b.CONFIG.n_layers} decoder layers to {cfg.n_layers}; {cfg.optimizer} "
        f"(lr {TRAIN_LR}, warmup {OptimizerConfig.warmup_steps}, cosine to step "
        f"{OptimizerConfig.total_steps}); global batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, float32 gradient accumulation, "
        f"remat 'nothing', attn 'plain'; float32 matmuls on TF32 tensor cores "
        f"(torch.backends.cuda.matmul.allow_tf32 = True, set by this phase)")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 10)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    n_params = sum(v.numel() for v in params.values())
    model = get_model(cfg, attn="plain", remat_policy="nothing")
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=TRAIN_MICRO, grad_dtype="float32")
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=seed))
    torch.cuda.synchronize()
    log(f"train: {n_params / 1e9:.3f} G params drawn on the card and AdamW state made in "
        f"{time.perf_counter() - t0:.1f} s")

    def to_card(batch):
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}

    store = ZLLMStore(os.path.join(tmp, "train-store"), workers=min(16, os.cpu_count() or 1),
                      entropy_procs=0)
    mgr = _TimedManager(os.path.join(tmp, "train-run"), store=store, run_id=TRAIN_RUN,
                        keep_plain=False, save_optimizer=False)
    hist = []
    it = PrefetchIterator(iter(data), prefetch=2)
    try:
        # the main path: counts from 0 just before, read just after
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        for step in range(1, TRAIN_STEPS + 1):
            batch = to_card(next(it))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            t1 = time.perf_counter()
            hist.append({"step": step, "loss": loss, "grad_norm": gnorm, "ms": (t1 - t0) * 1e3,
                         "span": (t0, t1)})
            if step == TRAIN_ASYNC_AT:
                t0 = time.perf_counter()
                mgr.save_async(step, params, opt_state)
                snapshot_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        mgr.wait()
        waited_s = time.perf_counter() - t0
        mgr.save(TRAIN_STEPS, params, opt_state)
    finally:
        it.close()
        mgr.wait()
    path_launches = _build.launch_counts()
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"train: non-finite loss or grad norm: {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"train: the loss did not fall: {[h['loss'] for h in hist]}")
    r1, r2 = store.results
    if not (r1.base_id is None and r1.n_zipnn > 0):
        raise AssertionError(f"train: the first checkpoint did not take the ZipNN lane: {r1}")
    if not (r2.base_source == "declared" and r2.n_bitx > 0):
        raise AssertionError(f"train: the second checkpoint was not BitX-coded against the "
                             f"first: {r2}")
    for k in ("split", "xor_split"):
        if path_launches[k] == 0:
            raise AssertionError(f"train: {k} never launched by the checkpoints: {path_launches}")

    # restore of the last checkpoint from compressed-only storage
    c0 = _build.launch_counts()
    t0 = time.perf_counter()
    step, restored, _ = mgr.restore(TRAIN_STEPS)
    restore_s = time.perf_counter() - t0
    restore_launches = {k: v - c0[k] for k, v in _build.launch_counts().items()}
    for k, v in restore_launches.items():
        path_launches[k] += v
    if step != TRAIN_STEPS or os.path.exists(mgr.ckpt_path(TRAIN_STEPS)):
        raise AssertionError(f"train: restored step {step}; the plain file must be gone")
    if restore_launches["merge_xor"] == 0 or restore_launches["merge"] == 0:
        raise AssertionError(f"train: the restore did not launch merge_xor and merge: "
                             f"{restore_launches}")
    for k, v in params.items():
        if not torch.equal(restored[k], v.cpu()):
            raise AssertionError(f"train: restored {k} is not bit-equal to the live tensor")
    ev = make_eval_step(model)
    eb = to_card(data.batch_at(TRAIN_STEPS))
    live = float(ev(params, eb)["loss"])
    restored = {k: v.to(DEVICE) for k, v in restored.items()}
    again = float(ev(restored, eb)["loss"])
    del restored
    torch.cuda.empty_cache()
    if not abs(again - live) <= TRAIN_EVAL_TOL * abs(live):
        raise AssertionError(f"train: eval loss {again} on the restored params, {live} live")

    # one more step's loss and grad norm under each remat policy, at the same
    # params and batch (the update is skipped, so all three start alike)
    remat = {}
    for policy in ("nothing", "none", "dots"):
        f = make_train_step(get_model(cfg, attn="plain", remat_policy=policy), _NoUpdate(),
                            microbatches=TRAIN_MICRO, grad_dtype="float32")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, m = f(params, opt_state, eb)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        remat[policy] = {"loss": loss, "grad_norm": gnorm,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
                         "above_resident_GiB": (torch.cuda.max_memory_allocated() - resident) / 2**30}
    for policy in ("none", "dots"):
        for key in ("loss", "grad_norm"):
            a, b = remat[policy][key], remat["nothing"][key]
            if not abs(a - b) <= TRAIN_REMAT_TOL * abs(b):
                raise AssertionError(f"train: {key} under remat {policy!r} is {a}, under "
                                     f"'nothing' {b}")

    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = float(np.median([h["ms"] for h in hist[2:]]))
    a0, a1 = mgr.spans[TRAIN_ASYNC_AT]
    during = [h["ms"] for h in hist if h["step"] > TRAIN_ASYNC_AT and h["span"][0] < a1]
    without = [h["ms"] for h in hist[1:TRAIN_ASYNC_AT]]
    quiet_ms = float(np.median(without))
    # N counts the matmul weights only: the embedding table is a gather, norms
    # and biases are elementwise; attention's score and value products are not
    # in 6 N either
    n_matmul = sum(v.numel() for k, v in params.items()
                   if k == "lm_head" or k.startswith("blocks.w"))

    def flop_share(ms):
        return 6 * n_matmul * tokens / (ms / 1e3 * BF16_FLOP_PER_S)

    saves = {}
    for st, (s0, s1) in sorted(mgr.spans.items()):
        r = r1 if st == TRAIN_ASYNC_AT else r2
        raw, ingest = r.raw_bytes, r.ingest_seconds
        saves[st] = {"raw_bytes": raw, "seconds": s1 - s0, "MBps": raw / (s1 - s0) / 1e6,
                     "write_s": s1 - s0 - ingest, "write_MBps": raw / (s1 - s0 - ingest) / 1e6,
                     "ingest_s": ingest, "ingest_MBps": raw / ingest / 1e6}
    out = {
        "card": smi, "n_params": n_params, "n_matmul_params": n_matmul, "layers": TRAIN_LAYERS,
        "seq": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO, "matmul_precision": "tf32",
        "losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
        "step_ms": [h["ms"] for h in hist], "step_ms_median_3_8": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "model_flop_share": flop_share(step_ms),
        "model_flop_share_formula": (f"6 * {n_matmul} matmul params (lm_head and the blocks' "
                                     f"weight matrices; not the {params['embed'].numel()} of the "
                                     f"embedding gather) * {tokens} tokens / "
                                     f"({step_ms / 1e3:.4f} s * {BF16_FLOP_PER_S:.3e} FLOP/s)"),
        "step_ms_median_2_4_no_save": quiet_ms, "tokens_per_s_no_save": tokens / (quiet_ms / 1e3),
        "model_flop_share_no_save": flop_share(quiet_ms),
        "train_peak_GiB": train_peak / 2**30,
        "step_ms_during_async_save": during, "step_ms_without_save": without,
        "async_snapshot_s": snapshot_s, "async_save_s": a1 - a0, "waited_for_async_s": waited_s,
        "saves": saves, "restore_s": restore_s, "restore_MBps": r2.raw_bytes / restore_s / 1e6,
        "second_ckpt": {"stored_bytes": r2.stored_bytes, "raw_bytes": r2.raw_bytes,
                        "ratio": r2.stored_bytes / r2.raw_bytes, "n_bitx": r2.n_bitx,
                        "n_zipnn": r2.n_zipnn, "n_raw": r2.n_raw, "n_dedup": r2.n_dedup},
        "first_ckpt": {"stored_bytes": r1.stored_bytes, "raw_bytes": r1.raw_bytes,
                       "n_zipnn": r1.n_zipnn},
        "eval_loss_live": live, "eval_loss_restored": again, "remat": remat,
        "launches": path_launches, "restore_launches": restore_launches,
    }
    store.close()
    log(f"train: losses {', '.join(f'{x:.4f}' for x in out['losses'])}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in out['grad_norms'])}")
    log(f"train: step ms {', '.join(f'{x:.1f}' for x in out['step_ms'])}; median of steps 3-8 "
        f"{step_ms:.1f} ms, {out['tokens_per_s']:.0f} tokens/s; model-FLOP share "
        f"{out['model_flop_share']:.4f} = {out['model_flop_share_formula']} (aside, steps "
        f"2-{TRAIN_ASYNC_AT} with no save running: median {quiet_ms:.1f} ms, "
        f"{out['tokens_per_s_no_save']:.0f} tokens/s, share {out['model_flop_share_no_save']:.4f}); "
        f"peak device memory {train_peak / 2**30:.2f} GiB; card: {smi}")
    log(f"train: write-behind checkpoint at step {TRAIN_ASYNC_AT}: snapshot to the host "
        f"{snapshot_s:.2f} s, save {a1 - a0:.1f} s in the background; steps overlapping it "
        f"{', '.join(f'{x:.1f}' for x in during)} ms, steps 2-{TRAIN_ASYNC_AT} without a save "
        f"{', '.join(f'{x:.1f}' for x in without)} ms; step {TRAIN_STEPS} waited {waited_s:.1f} s "
        f"for it")
    for st, sv in saves.items():
        log(f"train: checkpoint {st} ({sv['raw_bytes'] / 1e9:.3f} GB): save {sv['MBps']:.1f} MB/s "
            f"({sv['seconds']:.1f} s) = file write, hash and manifest {sv['write_s']:.1f} s "
            f"({sv['write_MBps']:.1f} MB/s) + store ingest {sv['ingest_s']:.1f} s "
            f"({sv['ingest_MBps']:.1f} MB/s); card: {smi}")
    log(f"train: checkpoint {TRAIN_STEPS} BitX-coded against checkpoint {TRAIN_ASYNC_AT} "
        f"({r2.n_bitx} BitX, {r2.n_zipnn} ZipNN, {r2.n_raw} raw, {r2.n_dedup} dedup tensors), "
        f"stored/raw {out['second_ckpt']['ratio']:.4f}; checkpoint {TRAIN_ASYNC_AT} (ZipNN) "
        f"{r1.stored_bytes / r1.raw_bytes:.4f}; restore from compressed-only storage "
        f"{out['restore_MBps']:.1f} MB/s ({restore_s:.1f} s), bit-equal to the live params, "
        f"eval loss {again:.6f} restored vs {live:.6f} live")
    log(f"train: remat policies at step {TRAIN_STEPS}'s params and batch {TRAIN_STEPS}: " + "; ".join(
        f"{p}: loss {r['loss']:.6f}, grad norm {r['grad_norm']:.6f}, {r['ms']:.0f} ms, peak "
        f"{r['peak_GiB']:.2f} GiB ({r['above_resident_GiB']:.2f} GiB above the resident state)"
        for p, r in remat.items()) + f"; card: {smi}")
    log(f"train: storage kernel launches in phase 10a {path_launches} (the restore's "
        f"{restore_launches})")
    return out


def _train_cli(tmp: str, smi: str) -> dict:
    """10b: ``python -m repro_torch.launch.train`` on the card, killed by its
    injected crash (exit 42), then the same command resumes and ends."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    run_dir = os.path.join(tmp, "cli-run")
    cmd = [sys.executable, *TRAIN_CLI, "--store", os.path.join(tmp, "cli-store"),
           "--run-dir", run_dir]
    lib = _build.library_path()
    lib_before = os.stat(lib)
    runs = []
    for want in (42, 0):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(here),
                              timeout=TRAIN_CLI_S)
        runs.append({"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                     "stdout": proc.stdout})
        if proc.returncode != want or f"[train] device {DEVICE}" not in proc.stdout:
            raise AssertionError(f"train CLI: {' '.join(cmd)} exited {proc.returncode}, want "
                                 f"{want} on {DEVICE}\n--- stdout ---\n{proc.stdout}"
                                 f"--- stderr (tail) ---\n{proc.stderr[-6000:]}")
    first, second = runs
    ckpts = [_CKPT_LINE.search(ln).groups() for r in runs for ln in r["stdout"].splitlines()
             if _CKPT_LINE.search(ln)]
    checks = {
        "the first run crashed at step 5": "injected failure at step 5" in first["stdout"],
        "the second resumed from step 3": "[train] resumed from step 3" in second["stdout"],
        "and ended at step 8": "[train] done: 5 steps" in second["stdout"],
        "checkpoint 3 took the ZipNN lane": len(ckpts) == 3 and ckpts[0][1] == "-"
        and int(ckpts[0][4]) > 0,
        "checkpoints 6 and 8 declared it as their base and took the BitX lane":
            len(ckpts) == 3 and all(c[2] == "declared" and c[1].endswith("checkpoint-00000003"
                                                                         ".safetensors")
                                    and int(c[3]) > 0 for c in ckpts[1:]),
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"train CLI: {what} failed\n--- first run ---\n{first['stdout']}"
                                 f"--- second run ---\n{second['stdout']}")
    arch = get_config("qwen2-7b", smoke=True)
    tmpl = AdamW(OptimizerConfig()).state_templates(get_model(arch).param_templates())
    step, cli_params, cli_opt = CheckpointManager(run_dir, run_id=TRAIN_CLI_RUN).restore(
        opt_template=tmpl)
    if step != 8 or int(cli_opt["step"]) != 8 or cli_opt["m"].keys() != cli_params.keys():
        raise AssertionError(f"train CLI: checkpoint {step} holds no AdamW state of step 8")
    lib_after = os.stat(lib)
    if (lib_after.st_ino, lib_after.st_mtime_ns) != (lib_before.st_ino, lib_before.st_mtime_ns):
        raise AssertionError(f"train CLI: the run rebuilt {lib} instead of loading phase 2's build")
    log("train CLI: " + "; ".join(checks) + f"; checkpoint 8 holds AdamW state at step "
        f"{int(cli_opt['step'])}; runs took {first['seconds']:.1f} s and "
        f"{second['seconds']:.1f} s; kernel library loaded from phase 2's build, not rebuilt")
    return {"rc": [r["rc"] for r in runs], "seconds": [r["seconds"] for r in runs],
            "checkpoints": [{"file": c[0], "base": c[1], "source": c[2], "n_bitx": int(c[3]),
                             "n_zipnn": int(c[4])} for c in ckpts]}


def phase_train(tmp: str, seed: int, smi: str) -> dict:
    """Phase 10: 10a (full width) and 10b (the CLI), under the matmul
    precision this phase sets (TF32 for float32 matmuls), restored after."""
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = _train_full_width(tmp, seed, smi)
        out["cli"] = _train_cli(tmp, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t0
    log(f"train: phase 10 took {out['seconds']:.1f} s; card: {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the device mesh on the card, the dry run and its counter
# ---------------------------------------------------------------------------

MESH_WARMUP = 1                  # 11a: untimed first steps (first dispatch, NCCL set-up)
MESH_STEPS = 5                   # 11a: timed steps of the unsharded and the (1, 1)-mesh trainer
MESH_TOL = 1e-6                  # relative: loss and parameters, when not bit-equal
MESH_PREFILL_B, MESH_PREFILL_S = 4, 1024
MESH_PREFILL_TOL = FLASH_TOL[torch.bfloat16]   # of max |logits|: the flash calls' own tolerance
COUNT_TOL = 0.02                 # 11c: counted dot FLOPs against their closed form
# 11b: the dry run at published width and depth, as child processes on the
# card's host (CPU only: they see no card), all at once, after 11a and 11c;
# for phase 12, zamba2-2.7b's long_500k decode on the multi-pod mesh (9
# shared-block caches of 524,288 positions, sequence-sharded). falcon-mamba's
# train_4k is left to the dry run's --all sweep: its scan loops dispatch every
# chunk of 64 layers x 8 microbatches, many minutes of host time
DRYRUN_CELLS = (("qwen2-7b", "train_4k", "single"), ("mixtral-8x7b", "decode_32k", "multi"),
                ("zamba2-2.7b", "long_500k", "multi"))
DRYRUN_S = 300                   # each must end within this


def start_dryruns() -> dict:
    """Start 11b's cells of ``DRYRUN_CELLS``, each dry-run by ``python -m
    repro_torch.launch.dryrun`` in a process of its own on the host's CPU, all
    at once; ``phase_dryruns`` collects them and ``stop_dryruns`` ends them."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(here / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    runs = {"out_dir": tempfile.mkdtemp(prefix="zllm-chip-smoke-dryrun-"), "procs": [],
            "waiters": [], "ended": {}, "t0": time.perf_counter(),
            "names": [f"{arch}__{shape}__{mesh}" for arch, shape, mesh in DRYRUN_CELLS]}

    def wait(n: int, proc: subprocess.Popen) -> None:
        proc.wait()
        runs["ended"][n] = time.perf_counter() - runs["t0"]

    try:
        for n, ((arch, shape, mesh), name) in enumerate(zip(DRYRUN_CELLS, runs["names"])):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--mesh", mesh, "--out", runs["out_dir"]]
            with open(os.path.join(runs["out_dir"], f"{name}.log"), "w") as log_file:
                proc = subprocess.Popen(cmd, env=env, cwd=str(here), stdout=log_file,
                                        stderr=subprocess.STDOUT)
            runs["procs"].append(proc)
            waiter = threading.Thread(target=wait, args=(n, proc), daemon=True)
            waiter.start()
            runs["waiters"].append(waiter)
    except BaseException:
        stop_dryruns(runs)
        raise
    return runs


def stop_dryruns(runs: dict) -> None:
    """Kill any dry run still running and remove their output."""
    for proc in runs["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(runs["out_dir"], ignore_errors=True)


def phase_dryruns(smi: str, runs: dict | None = None) -> list:
    """11b: wait for the dry runs that ``start_dryruns`` started (started here
    when ``runs`` is None); each record and its H100 roofline row."""
    from repro_torch.launch.roofline import roofline_row

    if runs is None:
        runs = start_dryruns()
    procs, names, ended, out_dir = runs["procs"], runs["names"], runs["ended"], runs["out_dir"]
    try:
        for waiter in runs["waiters"]:
            waiter.join(max(0.0, runs["t0"] + DRYRUN_S - time.perf_counter()))
        late = [names[n] for n in range(len(procs)) if n not in ended]
        if late:
            raise AssertionError(f"mesh: the dry runs {late} outlived {DRYRUN_S} s")
        out = []
        for n, ((arch, shape, mesh), name) in enumerate(zip(DRYRUN_CELLS, names)):
            if procs[n].returncode != 0:
                output = Path(out_dir, f"{name}.log").read_text()
                raise AssertionError(f"mesh: the dry run of {arch} {shape} {mesh} exited "
                                     f"{procs[n].returncode}\n{output[-4000:]}")
            rec = json.loads(Path(out_dir, f"{name}.json").read_text())
            row = roofline_row(rec)
            out.append({k: rec[k] for k in ("arch", "shape", "mesh", "chips", "flops_per_device",
                                            "dot_flops_per_device", "bytes_per_device",
                                            "model_flops_global", "wall_s")}
                       | {"collectives": rec["collectives"],
                          "peak_GiB": rec["memory_analysis"]["peak_size_in_bytes"] / 2**30,
                          "roofline": {k: row[k] for k in ("compute_s", "memory_s",
                                                           "collective_s", "dominant",
                                                           "roofline_fraction", "rf_compute",
                                                           "useful_ratio")},
                          "process_s": ended[n]})
            c = rec["collectives"]
            log(f"mesh 11b: dry run {arch} {shape} on the {mesh} mesh ({rec['chips']} ranks of a "
                f"fake group, on this host's CPU): per device {rec['flops_per_device']:.4e} FLOPs "
                f"({rec['dot_flops_per_device']:.4e} in dots), {rec['bytes_per_device']:.4e} "
                f"bytes, collectives {c['collective_total_bytes']:.4e} B {c['by_op']} "
                f"({c['counts']}), peak {out[-1]['peak_GiB']:.2f} GiB; H100 roofline: compute "
                f"{row['compute_s']:.4f} s, memory {row['memory_s']:.4f} s, collective "
                f"{row['collective_s']:.4f} s, {row['dominant']}-bound, RF "
                f"{row['roofline_fraction']:.3f}; the step ran {rec['wall_s']:.1f} s, the "
                f"process {ended[n]:.1f} s on the host; card: {smi}")
        return out
    finally:
        stop_dryruns(runs)


def _mesh_trainers(tmp: str, seed: int):
    """11a's two trainers: one device, no process group; and a (1, 1) mesh
    (NCCL, one rank). Same config, same seed, no checkpoints."""
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=TRAIN_LAYERS)
    out = []
    for name, shape in (("one", None), ("mesh", (1, 1))):
        tc = TrainConfig(arch=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                         microbatches=TRAIN_MICRO, steps=MESH_WARMUP + MESH_STEPS,
                         ckpt_every=10**9,
                         run_dir=os.path.join(tmp, f"mesh-{name}"), resume=False,
                         mesh_shape=shape, seed=seed,
                         optimizer=OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR),
                         device=DEVICE)
        out.append(Trainer(tc, run_id=f"mesh-{name}"))
    return cfg, out


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = max(float(b.float().abs().max()), 1e-30)
    return float((a.float() - b.float()).abs().max()) / scale


def phase_mesh(tmp: str, seed: int, smi: str, dryruns: dict | None = None) -> dict:
    """Phase 11: 11a the trainer on a (1, 1) mesh against the unsharded one,
    step for step, and a prefill on that mesh through the flash kernel; 11b
    the dry-run cells (those ``dryruns`` started, else started here); 11c one step of the unsharded cell counted by
    ``op_cost`` against its closed form and the clock."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import hotspots
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.op_cost import OpCost, train_dot_flops
    from repro_torch.sharding.rules import named_sharding

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True   # as phase 10: the cell is phase 10a's
    try:
        cfg, (one, mesh) = _mesh_trainers(tmp, seed)
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"mesh: the (1, 1) mesh runs on {dist.get_backend()} with "
                                 f"{dist.get_world_size()} ranks, not one NCCL rank")
        log(f"mesh 11a: phase 10a's cell ({cfg.name} widths, {cfg.n_layers} layers, "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches, AdamW lr "
            f"{TRAIN_LR}, float32 accumulators, TF32) trained {MESH_WARMUP} untimed + "
            f"{MESH_STEPS} timed steps by an unsharded Trainer and by "
            f"Trainer(mesh_shape=(1, 1)) on NCCL with one rank, from seed {seed}, in turns")
        steps, bit_equal, worst = [], True, 0.0
        for i in range(MESH_WARMUP + MESH_STEPS):
            hb = one.data.batch_at(i)
            torch.cuda.synchronize()
            r1 = one.train_step(hb)
            torch.cuda.synchronize()
            r2 = mesh.train_step(hb)
            torch.cuda.synchronize()
            same = r1["loss"] == r2["loss"] and r1["grad_norm"] == r2["grad_norm"]
            for k, v in one.params.items():
                w = mesh.params[k]
                if not isinstance(w, DTensor):
                    raise AssertionError(f"mesh: {k} is not a DTensor on the mesh")
                w = w.to_local()
                if not torch.equal(v, w):
                    same = False
                    worst = max(worst, _rel_err(w, v))
            worst = max(worst, abs(r2["loss"] - r1["loss"]) / abs(r1["loss"]),
                        abs(r2["grad_norm"] - r1["grad_norm"]) / abs(r1["grad_norm"]))
            bit_equal &= same
            steps.append({"step": i + 1, "timed": i >= MESH_WARMUP,
                          "loss": r1["loss"], "loss_mesh": r2["loss"],
                          "grad_norm": r1["grad_norm"], "grad_norm_mesh": r2["grad_norm"],
                          "ms": r1["sec"] * 1e3, "ms_mesh": r2["sec"] * 1e3, "bit_equal": same})
        if not bit_equal and not worst <= MESH_TOL:
            raise AssertionError(f"mesh: the (1, 1) mesh strays {worst:.3e} (relative) from the "
                                 f"unsharded trainer, above {MESH_TOL}: {steps}")
        ms_one = float(np.median([s["ms"] for s in steps if s["timed"]]))
        ms_mesh = float(np.median([s["ms_mesh"] for s in steps if s["timed"]]))
        log(f"mesh 11a: losses {[round(s['loss'], 6) for s in steps]} (mesh "
            f"{[round(s['loss_mesh'], 6) for s in steps]}); loss, grad norm and every parameter "
            f"after each step {'bit-equal' if bit_equal else f'within {worst:.3e} relative'}; "
            f"step ms unsharded {[round(s['ms'], 1) for s in steps]}, mesh "
            f"{[round(s['ms_mesh'], 1) for s in steps]} (the first {MESH_WARMUP} untimed); median "
            f"of the {MESH_STEPS} timed {ms_one:.1f} vs {ms_mesh:.1f} ms (DTensor's host cost "
            f"on the card {ms_mesh - ms_one:+.1f} ms); card: {smi}")

        # a prefill on the mesh through the flash kernel, against the unsharded one
        prompts = torch.from_numpy(one.data.batch_at(MESH_WARMUP + MESH_STEPS)["tokens"][
            :MESH_PREFILL_B, :MESH_PREFILL_S]).to(DEVICE)
        sharded = get_model(cfg, attn="flash", mesh=mesh.mesh, rules=mesh.rules)
        tok = named_sharding(mesh.mesh, ("batch", None), mesh.rules, prompts.shape).distribute(
            prompts)
        fa.reset_route_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_mesh, cache = sharded.prefill(mesh.params, {"tokens": tok})
        logits_mesh = logits_mesh.full_tensor()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        routes = fa.route_launches()
        local = {k: v.to_local() for k, v in mesh.params.items()}
        logits_one, _ = get_model(cfg, attn="flash").prefill(local, {"tokens": prompts})
        del cache
        prefill_err = _rel_err(logits_mesh, logits_one)
        if routes != only("sm90", cfg.n_layers):
            raise AssertionError(f"mesh: the mesh prefill launched {routes}, want "
                                 f"{cfg.n_layers} sm90 launches")
        if not prefill_err <= MESH_PREFILL_TOL:
            raise AssertionError(f"mesh: prefill logits stray {prefill_err:.3e} of max |logits| "
                                 f"from the unsharded prefill's (limit {MESH_PREFILL_TOL})")
        log(f"mesh 11a: prefill of {MESH_PREFILL_B} x {MESH_PREFILL_S} tokens on the mesh, "
            f"attn 'flash': launches by route {routes}, {prefill_ms:.1f} ms, logits "
            f"{prefill_err:.3e} of max |logits| from the unsharded prefill's "
            f"(limit {MESH_PREFILL_TOL}); card: {smi}")
        del local, logits_one, logits_mesh, sharded
        mesh_params_bytes = sum(v.to_local().numel() * v.to_local().element_size()
                                for v in mesh.params.values())
        del mesh
        torch.cuda.empty_cache()

        # 11c: one more step of the unsharded cell, counted op by op
        hb = one.data.batch_at(MESH_WARMUP + MESH_STEPS)
        with OpCost(attribute=True) as cost:
            one.train_step(hb)
        torch.cuda.synchronize()
        closed = train_dot_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
        c = cost.total
        if not abs(c.dot_flops - closed) <= COUNT_TOL * closed:
            raise AssertionError(f"mesh: counted {c.dot_flops:.6e} dot FLOPs, the closed form "
                                 f"{closed:.6e} (tolerance {COUNT_TOL})")
        compute_ms = c.dot_flops / HW.PEAK_FLOPS_BF16 * 1e3
        memory_ms = c.bytes / HW.HBM_BW * 1e3
        bound_ms = max(compute_ms, memory_ms)
        tops = {m: hotspots.levels(cost, m) for m in ("flops", "bytes")}
        top5 = {m: [(n, v) for n, v in (lv[-1][2])[:5]] for m, lv in tops.items()}
        log(f"mesh 11c: one step of the unsharded cell counted: {c.flops:.6e} FLOPs, "
            f"{c.dot_flops:.6e} in dots (closed form {closed:.6e}, "
            f"{c.dot_flops / closed - 1:+.2e}), {c.bytes:.6e} bytes moved by its ops; roofline "
            f"bound from HW (H100 SXM datasheet) {bound_ms:.2f} ms (compute {compute_ms:.2f}, "
            f"memory {memory_ms:.2f}); measured median step {ms_one:.1f} ms reaches "
            f"{bound_ms / ms_one:.3f} of the bound; card: {smi}")
        for m, rows in top5.items():
            log(f"mesh 11c: top 5 hotspots by {m} ({tops[m][-1][0]}): " + "; ".join(
                f"{n} {v:.4e}" for n, v in rows))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    dry = phase_dryruns(smi, dryruns)
    out = {"card": smi, "steps": steps, "bit_equal": bit_equal, "max_rel_err": worst,
           "step_ms_median": ms_one, "step_ms_median_mesh": ms_mesh,
           "mesh_param_bytes": mesh_params_bytes,
           "prefill": {"launches": routes, "ms": prefill_ms, "rel_err": prefill_err},
           "count": {"flops": c.flops, "dot_flops": c.dot_flops, "dot_flops_closed_form": closed,
                     "bytes": c.bytes, "collective_bytes": c.collective_total,
                     "compute_ms": compute_ms, "memory_ms": memory_ms, "bound_ms": bound_ms,
                     "fraction_of_bound": bound_ms / ms_one, "top5": top5},
           "dryrun": dry, "seconds": time.perf_counter() - t_phase}
    log(f"mesh: phase 11 took {out['seconds']:.1f} s; card: {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the SSM and Whisper families on a (1, 1) mesh
# ---------------------------------------------------------------------------

MESH_FAMILY_NEW = 8              # 12a: greedy tokens each engine serves
# 12b: depth cuts at published widths: falcon-mamba's 2 of 64 layers, and
# zamba2's first group of 6 Mamba-2 layers (of 54) with the shared block
MESH_TRAIN_LAYERS = {"falcon-mamba-7b": 2, "zamba2-2.7b": 6}
MESH_TRAIN_WARMUP, MESH_TRAIN_STEPS = 1, 3


def _mesh_family_serve(name: str, cfg, engines, prompts, extra, head_dim: int, n_calls: int,
                       smi: str) -> dict:
    """12a for one model: the unsharded engine and the (1, 1)-mesh engine
    generate in turn, the mesh's run counted from 0; its prefill logits and
    tokens against the unsharded ones; then each flash call of a mesh prefill
    held against its plain version on its own inputs."""
    runs = {}
    for which in ("unsharded", "mesh"):
        _build.reset_launch_counts()
        fa.reset_route_launches()
        runs[which] = _generate(engines[which], prompts, MESH_FAMILY_NEW, extra)
        runs[which]["launches"] = _build.launch_counts()["flash_attention"]
        runs[which]["routes"] = fa.route_launches()
    routes = runs["mesh"]["routes"]
    if runs["mesh"]["launches"] != n_calls or routes != only("sm90", n_calls):
        raise AssertionError(f"mesh families {name}: the mesh engine's prefill launched "
                             f"{runs['mesh']['launches']} flash calls by route {routes}, want "
                             f"{n_calls} on sm90")
    want = runs["unsharded"]["prefill"].logits[0]
    got = runs["mesh"]["prefill"].logits[0].full_tensor()
    err = float((got - want).abs().max()) / float(want.abs().max())
    bit_equal = torch.equal(got, want)
    if not (bit_equal or err <= MESH_PREFILL_TOL):
        raise AssertionError(f"mesh families {name}: prefill logits stray {err:.3e} of max "
                             f"|logits| from the unsharded engine's (limit {MESH_PREFILL_TOL})")
    toks = {w: r["res"].tokens for w, r in runs.items()}
    if not np.array_equal(toks["mesh"], toks["unsharded"]):
        raise AssertionError(f"mesh families {name}: greedy tokens differ: {toks}")
    # each flash call of a mesh prefill on its own inputs (not counted above)
    errs = []

    def checked(q, k, v, *, causal, window=0):
        out, e = flash_checked(q, k, v, causal, window, route="sm90")
        errs.append((tuple(q.shape), e))
        return out

    eng = engines["mesh"]
    batch = {"tokens": eng._place(torch.as_tensor(prompts))}
    batch.update({k: eng._place(v) for k, v in (extra or {}).items()})
    model_base.flash_attention = checked
    try:
        eng.model.prefill(eng.params, batch)
    finally:
        model_base.flash_attention = flash_attention
    dims = sorted({s[-1] for s, _ in errs})
    if len(errs) != n_calls or dims != [head_dim]:
        raise AssertionError(f"mesh families {name}: {len(errs)} flash calls at head dims "
                             f"{dims}, want {n_calls} at {head_dim}")
    ms = {w: {"prefill_ms": 1e3 * r["prefill"].seconds[0],
              "decode_ms": 1e3 * float(np.mean(r["decode"].seconds))} for w, r in runs.items()}
    out = {"launches": routes, "head_dim": head_dim, "logits_bit_equal": bit_equal,
           "logits_rel_err": err, "tokens_equal": True, "flash_err": max(e for _, e in errs),
           "ms": ms, "card": smi}
    log(f"mesh families 12a {name}: {prompts.shape[0]} prompts of {prompts.shape[1]} tokens, "
        f"{MESH_FAMILY_NEW} new: the (1, 1)-mesh engine's prefill launched {routes} (head dim "
        f"{head_dim}), logits {'bit-equal to' if bit_equal else f'{err:.3e} of max |logits| from'} "
        f"the unsharded engine's, the {MESH_FAMILY_NEW} greedy tokens equal; each flash call "
        f"within {out['flash_err']:.3e} of its plain version (tolerance 2e-2); prefill "
        f"{ms['unsharded']['prefill_ms']:.2f} ms unsharded, {ms['mesh']['prefill_ms']:.2f} ms on "
        f"the mesh; decode {ms['unsharded']['decode_ms']:.3f} vs {ms['mesh']['decode_ms']:.3f} ms "
        f"per step (the difference is DTensor's host cost); card: {smi}")
    return out


def _mesh_family_train(tmp: str, seed: int, arch: str, cfg, smi: str) -> dict:
    """12b for one model: an unsharded Trainer and Trainer(mesh_shape=(1, 1))
    from the seed, step for step in turns; loss, grad norm and every
    parameter compared after each step."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.trainer import TrainConfig, Trainer

    trainers = []
    for which, shape in (("one", None), ("mesh", (1, 1))):
        tc = TrainConfig(arch=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                         microbatches=TRAIN_MICRO, steps=MESH_TRAIN_WARMUP + MESH_TRAIN_STEPS,
                         ckpt_every=10**9, run_dir=os.path.join(tmp, f"{arch}-{which}"),
                         resume=False, mesh_shape=shape, seed=seed,
                         optimizer=OptimizerConfig(name=cfg.optimizer, lr=TRAIN_LR),
                         device=DEVICE)
        trainers.append(Trainer(tc, run_id=f"{arch}-{which}"))
    one, mesh = trainers
    steps, bit_equal, worst = [], True, 0.0
    for i in range(MESH_TRAIN_WARMUP + MESH_TRAIN_STEPS):
        hb = one.data.batch_at(i)
        torch.cuda.synchronize()
        r1 = one.train_step(hb)
        torch.cuda.synchronize()
        r2 = mesh.train_step(hb)
        torch.cuda.synchronize()
        same = r1["loss"] == r2["loss"] and r1["grad_norm"] == r2["grad_norm"]
        for k, v in one.params.items():
            w = mesh.params[k]
            if not isinstance(w, DTensor):
                raise AssertionError(f"mesh families {arch}: {k} is not a DTensor on the mesh")
            w = w.to_local()
            if not torch.equal(v, w):
                same = False
                worst = max(worst, _rel_err(w, v))
        worst = max(worst, abs(r2["loss"] - r1["loss"]) / abs(r1["loss"]),
                    abs(r2["grad_norm"] - r1["grad_norm"]) / abs(r1["grad_norm"]))
        bit_equal &= same
        steps.append({"step": i + 1, "timed": i >= MESH_TRAIN_WARMUP, "loss": r1["loss"],
                      "loss_mesh": r2["loss"], "ms": r1["sec"] * 1e3,
                      "ms_mesh": r2["sec"] * 1e3, "bit_equal": same})
    if not (bit_equal or worst <= MESH_TOL):
        raise AssertionError(f"mesh families {arch}: the (1, 1) mesh strays {worst:.3e} "
                             f"(relative) from the unsharded trainer, above {MESH_TOL}: {steps}")
    med = {w: float(np.median([s[k] for s in steps if s["timed"]]))
           for w, k in (("unsharded", "ms"), ("mesh", "ms_mesh"))}
    n_params = sum(v.numel() for v in one.params.values())
    log(f"mesh families 12b {arch}: {cfg.n_layers} layers at published widths "
        f"({n_params / 1e9:.3f} G params), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in "
        f"{TRAIN_MICRO} microbatches, AdamW lr {TRAIN_LR}, attn 'plain': losses "
        f"{[round(s['loss'], 6) for s in steps]}; loss, grad norm and every parameter after each "
        f"step {'bit-equal' if bit_equal else f'within {worst:.3e} relative'}; step ms unsharded "
        f"{[round(s['ms'], 1) for s in steps]}, mesh {[round(s['ms_mesh'], 1) for s in steps]} "
        f"(the first {MESH_TRAIN_WARMUP} untimed); medians {med['unsharded']:.1f} vs "
        f"{med['mesh']:.1f} ms; card: {smi}")
    del trainers, one, mesh
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "params": n_params, "steps": steps, "bit_equal": bit_equal,
            "max_rel_err": worst, "step_ms_median": med, "card": smi}


def phase_mesh_families(tmp: str, seed: int, smi: str) -> dict:
    """Phase 12: 12a zamba2-2.7b and whisper-medium at published widths and
    depth served by the unsharded engine and on a (1, 1) NCCL mesh, from
    phase 9's parameters and prompts; 12b falcon-mamba-7b and zamba2-2.7b
    (depth cut) trained unsharded and on that mesh. 12c, the dry runs, ran
    with phase 11's."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import ShardingRules

    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1, device_type="cuda")
    rules = ShardingRules.for_mesh(mesh)
    out = {"serve": {}, "train": {}}
    # 12a: phase 9's draws, in phase 9's order
    cfg = whisper_medium.CONFIG
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    params = init_params(cfg, gen)
    frames = (torch.randn((FAMILY_BATCH, WHISPER_FRAMES, cfg.d_model), generator=gen,
                          device=DEVICE) * 0.02).to(torch.bfloat16)
    prompts = np.random.default_rng(seed + 5).integers(
        1, cfg.vocab, (FAMILY_BATCH, WHISPER_PROMPT)).astype(np.int32)
    engines = {"unsharded": ServeEngine(cfg, params, device=DEVICE),
               "mesh": ServeEngine(cfg, params, device=DEVICE, mesh=mesh, rules=rules)}
    del params
    out["serve"]["whisper"] = _mesh_family_serve("whisper", cfg, engines, prompts,
                                                 {"frames": frames}, cfg.hd, 3 * cfg.n_layers, smi)
    del engines, frames
    torch.cuda.empty_cache()
    cfg = zamba2_2_7b.CONFIG
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed + 6))
    prompts = np.random.default_rng(seed + 6).integers(
        1, cfg.vocab, (FAMILY_BATCH, LM_PROMPT)).astype(np.int32)
    engines = {"unsharded": ServeEngine(cfg, params, device=DEVICE),
               "mesh": ServeEngine(cfg, params, device=DEVICE, mesh=mesh, rules=rules)}
    del params
    out["serve"]["zamba2"] = _mesh_family_serve("zamba2", cfg, engines, prompts, None, cfg.hd,
                                                cfg.n_layers // cfg.attn_every, smi)
    del engines
    torch.cuda.empty_cache()
    # 12b
    for arch, module in (("falcon-mamba-7b", falcon_mamba_7b), ("zamba2-2.7b", zamba2_2_7b)):
        cfg = dataclasses.replace(module.CONFIG, n_layers=MESH_TRAIN_LAYERS[arch])
        out["train"][arch] = _mesh_family_train(tmp, seed, arch, cfg, smi)
    out["launches"] = {name: r["launches"] for name, r in out["serve"].items()}
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh families: phase 12 took {out['seconds']:.1f} s; card: {smi}")
    return out


# ---------------------------------------------------------------------------
# phases 9-12 in a child process, beside phases 4-8
# ---------------------------------------------------------------------------

# Phases 4-8 spend most of their time on the host (hashing, entropy coding
# and I/O of the store, each big tensor on one worker), so the card and most
# of the host's cores sit idle; run one after the other, the twelve phases
# ran 1165-1286 s, past the 1200 s limit on slow hosts. Phases 9-12 share no
# state with them, so a child process runs them meanwhile, on the same card,
# with its own launch counts (each phase still resets and reads its own).
LATER_FLAG = "--phases-9-12"
LATER_STOP_S = 30  # the child's grace to end its own children after SIGTERM


def _exit_on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def later_phases_main(result_path: str, parent_pid: str, smi: str) -> int:
    """Phases 9-12 (11b's dry runs beside 9 and 10), run by the child process
    that :class:`LaterPhases` starts; their results are pickled to
    ``result_path``. SIGTERM, sent by the parent on its way out or by the
    kernel when the parent dies, ends the dry runs and the CLI runs first."""

    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    if os.getppid() != int(parent_pid):
        return 1  # the parent ended before the signal was armed
    _build.library()  # phase 2's build, loaded, not rebuilt
    dryruns = start_dryruns()
    try:
        tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-families-")
        try:
            families = phase_families(tmp, SEED, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-train-")
        try:
            train = phase_train(tmp, SEED, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-mesh-")
        try:
            mesh = phase_mesh(tmp, SEED, smi, dryruns)
            mesh_families = phase_mesh_families(tmp, SEED, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        stop_dryruns(dryruns)
    with open(result_path + ".part", "wb") as f:
        pickle.dump((families, train, mesh, mesh_families), f)
    os.replace(result_path + ".part", result_path)
    return 0


class LaterPhases:
    """The child process of phases 9-12: ``python3 chip_smoke.py
    --phases-9-12``, started after phase 3 so that phase 3's timings have the
    card to themselves. Its output goes to files that :meth:`stop` copies to
    this process's stdout and stderr, so its lines follow phase 8's whole."""

    def __init__(self, smi: str):
        self.dir = tempfile.mkdtemp(prefix="zllm-chip-smoke-later-")
        self.result = os.path.join(self.dir, "result.pickle")
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), LATER_FLAG, self.result,
             str(os.getpid()), smi],
            stdout=self.out, stderr=self.err, cwd=os.path.dirname(os.path.abspath(__file__)))

    def check(self) -> None:
        """Raise at once if the child has already failed."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            raise AssertionError(f"phases 9-12 (the child process) exited {rc}")

    def wait(self) -> tuple:
        """Wait for the child; its four phases' results, or raise."""
        rc = self.proc.wait()
        self._echo()
        if rc != 0:
            raise AssertionError(f"phases 9-12 (the child process) exited {rc}")
        with open(self.result, "rb") as f:
            return pickle.load(f)

    def _echo(self) -> None:
        for src, dst in ((self.out, sys.stdout), (self.err, sys.stderr)):
            if not src.closed:
                src.flush()
                src.seek(0)
                shutil.copyfileobj(src, dst)
                dst.flush()
                src.close()

    def stop(self) -> None:
        """End the child if it still runs (SIGTERM, then SIGKILL), copy out
        what it printed, and remove its files."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(LATER_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._echo()
        shutil.rmtree(self.dir, ignore_errors=True)


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
    t3 = time.perf_counter()
    report = phase_kernels(gen)
    flash_reports = phase_flash(gen)
    log(f"kernels: phase 3 took {time.perf_counter() - t3:.1f} s")
    later = LaterPhases(smi)  # phases 9-12, in a child process, beside phases 4-8
    try:
        t4 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-")
        try:
            launches = phase_store(tmp, SEED)
            launches["hamming"] = phase_bitdistance(tmp, SEED)
            lifecycle = phase_lifecycle(tmp, SEED, smi)
            shutil.rmtree(os.path.join(tmp, "hub"))
            shutil.rmtree(os.path.join(tmp, "store"))
            phase_identity(tmp, SEED)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        launches["hamming"] += phase_calibration()
        log(f"store: phases 4-6 took {time.perf_counter() - t4:.1f} s")
        later.check()
        tmp = tempfile.mkdtemp(prefix="zllm-chip-smoke-serve-")
        try:
            t7 = time.perf_counter()
            launches["flash_attention"], path_err, serve32 = phase_serve(tmp, SEED)
            log(f"serve: phase 7 took {time.perf_counter() - t7:.1f} s")
            later.check()
            t8 = time.perf_counter()
            hub = phase_hub(tmp, SEED, smi)
            log(f"hub: phase 8 took {time.perf_counter() - t8:.1f} s")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        t9 = time.perf_counter()
        families, train, mesh, mesh_families = later.wait()
        log(f"smoke: phases 4-8 took {t9 - t4:.1f} s; phases 9-12, in the child process "
            f"beside them, ended {time.perf_counter() - t9:.1f} s after phase 8")
    finally:
        later.stop()
    # no path of the JAX package calls xor_2d: its count is phase 3's
    launches["xor"] = report["xor"]["launches"]
    log(f"smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    launched_by = {"hamming": "phases 4b and 6 (bit distance, calibration)",
                   "xor": "phase 3 (kernel checks): no path of the JAX package calls xor_2d"}
    by_phase = {}
    for name in TorchBackend.KERNELS:  # the store kernels: phases 4, 4c and 10's checkpoints
        by_phase[name] = {"4": launches[name], "4c": lifecycle["launches"][name],
                          "10": train["launches"][name]}
        launches[name] += lifecycle["launches"][name] + train["launches"][name]
        launched_by[name] = ("phases 4 (store; its four retrieves run at once, so its decode "
                             "counts vary with the decodes they share), 4c (the store's "
                             "lifecycle) and 10a (training checkpoints and their restore)")
    kernels = []
    for name, (replaces, _, _) in KERNELS.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "launched_by": launched_by[name],
            **({"launches_by_phase": by_phase[name]} if name in by_phase else {}),
            "matched": True, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "library": KERNELS[name][2],
            "card": smi,
        })
    # each flash route's row: the numbers at the largest shape of its path
    # (sm90: phase 7's S 2032 bf16 prefill, D 128; sm90_tf32 and tf32: the
    # same shape in float32, phase 7's float32 prefill), and per instance its
    # path's shape, launches and build report (sm90: D 128 phase 7, D 80 9b,
    # D 64 9a, each timed in phase 3, D 256, 16 and 32 timed only there, and
    # D 128 at a 32k-token prompt; sm90_tf32: float32 D 128 phase 7, D 80 9b,
    # D 64 9a, D 256 timed only in phase 3; tf32, which no path of the smoke
    # takes: the same float32 shapes, each timed in phase 3 beside sm90_tf32,
    # bf16 D 80 at 9b's shape, bf16 D 256, 16 and 32 beside sm90, and float32
    # D 16 and 32 alone)
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_us")
    timed = families["timed"]
    mf = mesh_families["launches"]
    f32 = flash_reports["f32"]
    sm90_paths = {128: (flash_reports["sm90"], launches["flash_attention"], "phase 7 (serve)"),
                  80: (flash_reports["sm90_80"], families["zamba2"]["flash_launches"]["sm90"]
                       + mf["zamba2"]["sm90"],
                       "phases 9b and 12a (zamba2-2.7b's shared attention, unsharded and on a "
                       "(1, 1) mesh)"),
                  64: (flash_reports["sm90_64"], families["whisper"]["flash_launches"]["sm90"]
                       + mf["whisper"]["sm90"],
                       "phases 9a and 12a (whisper-medium, unsharded and on a (1, 1) mesh)")}
    long = flash_reports["sm90_long"]
    bf16_pairs, tf32_only = flash_reports["bf16"], flash_reports["tf32_only"]
    f32_256 = flash_reports["f32_256"]  # float32 D 256: sm90_tf32 and tf32 in turns
    w32, z32 = (families[n]["float32_flash"] for n in ("whisper", "zamba2"))
    # the float32 prefills, each on sm90_tf32 (checked below): (phase 3's
    # timing at the path's shape, the path's run)
    f32_paths = {128: (f32["phase 7"], serve32, "phase 7 (the float32 model's prefills)"),
                 80: (f32["zamba2"], z32, "phase 9b (zamba2-2.7b's float32 prefill)"),
                 64: (f32["whisper encoder"], w32, "phase 9a (whisper-medium's float32 prefill)")}
    if any(run["route"] != "sm90_tf32" for _, run, _ in f32_paths.values()):
        raise AssertionError(f"a float32 prefill left sm90_tf32: {f32_paths}")
    rerouted = families["zamba2"]["prefill_by_route"]["rerouted_tf32_launches"]

    def f32_numbers(r: dict, route: str) -> dict:  # one kernel's numbers at a paired shape
        return {**{k: r[k] for k in keys if k in r}, **r[route],
                **{k: r[k] for k in ("passes_bound_ms", "library_backend") if k in r}}

    worst = flash_reports["worst"]
    rows = {
        "sm90": {"main": flash_reports["sm90"],
                 "launches": sum(n for _, n, _ in sm90_paths.values())
                 + mesh["prefill"]["launches"]["sm90"],
                 "launched_by": "phases 7 (serve), 9a (whisper-medium), 9b (zamba2-2.7b), "
                                "11a (the prefill on a (1, 1) mesh, D 128) and 12a (whisper-medium "
                                "and zamba2-2.7b on a (1, 1) mesh)",
                 "instance": "flash_fwd_sm90_kernel<128>",
                 "instances": {
                     **{f"flash_fwd_sm90_kernel<{D}>": {
                         **{k: r[k] for k in keys}, "launches": n, "launched_by": by,
                         **build_info.get(f"flash_fwd_sm90_kernel<{D}>", {})}
                        for D, (r, n, by) in sm90_paths.items()},
                     **{f"flash_fwd_sm90_kernel<{D}>": {
                         **f32_numbers(r, "sm90"), "launches": 0,
                         "launched_by": f"phase 3 only: no path of the smoke gives bf16 at D {D}",
                         **build_info.get(f"flash_fwd_sm90_kernel<{D}>", {})}
                        for D, r in bf16_pairs.items()}},
                 "long_prompt": {**{k: long[k] for k in keys if k != "plain_ms"},
                                 "plain_ms": None, "launches": 0,
                                 "launched_by": "phase 3 only (the dry run's prefill_32k length)",
                                 **{k: long[k] for k in ("max_abs_err", "sdpa_abs_err",
                                                         "plain_rows")}},
                 "err": max(flash_reports["sm90"]["max_abs_err"], path_err,
                            flash_reports["sm90_80"]["max_abs_err"],
                            flash_reports["sm90_64"]["max_abs_err"], long["max_abs_err"],
                            *(r["sm90"]["max_abs_err"] for r in bf16_pairs.values()),
                            families["whisper"]["flash_err"], families["zamba2"]["flash_err"],
                            *(r["flash_err"] for r in mesh_families["serve"].values()))},
        "sm90_tf32": {"main": f32_numbers(f32["phase 7"], "sm90_tf32"),
                      "launches": sum(run["launches"] for _, run, _ in f32_paths.values()),
                      "launched_by": "the float32 models' prefills through attn=flash: "
                                     + ", ".join(by for _, _, by in f32_paths.values()),
                      "instance": "flash_fwd_sm90_tf32_kernel<128>",
                      "instances": {
                          **{f"flash_fwd_sm90_tf32_kernel<{D}>": {
                              **f32_numbers(r, "sm90_tf32"), "launches": run["launches"],
                              "launched_by": by,
                              **build_info.get(f"flash_fwd_sm90_tf32_kernel<{D}>", {})}
                             for D, (r, run, by) in f32_paths.items()},
                          "flash_fwd_sm90_tf32_kernel<256>": {
                              **f32_numbers(f32_256, "sm90_tf32"), "launches": 0,
                              "launched_by": "phase 3 only: no config has head dim 256",
                              **build_info.get("flash_fwd_sm90_tf32_kernel<256>", {})}},
                      "err": max(worst.get("float32 sm90_tf32", 0.0),
                                 *(r["sm90_tf32"]["max_abs_err"] for r in f32.values()),
                                 f32_256["sm90_tf32"]["max_abs_err"],
                                 *(run["flash_err"] for _, run, _ in f32_paths.values()))},
        "tf32": {"main": f32_numbers(f32["phase 7"], "tf32"),
                 "launches": 0,
                 "launched_by": "phase 3 only: no path of the smoke routes a call to it (it takes "
                                "float32 at D 16 and 32 and operands TMA cannot address)",
                 "rerouted_launches": rerouted,
                 "rerouted_by": "phase 9b's warm prefills with zamba2-2.7b's bf16 flash calls "
                                "sent to it, in turns with sm90, off the path",
                 "instance": tf32_instance(torch.float32, 128),
                 "instances": {
                     **{tf32_instance(torch.float32, D): {
                         **f32_numbers(r, "tf32"), "launches": 0,
                         "launched_by": f"phase 3 only: {by} takes sm90_tf32",
                         **build_info.get(tf32_instance(torch.float32, D), {})}
                        for D, (r, _, by) in f32_paths.items()},
                     tf32_instance(torch.bfloat16, 80): {
                         **{k: timed["tf32_zamba2"][k] for k in keys}, "launches": 0,
                         "launched_by": "phase 9's timing at zamba2-2.7b's shape only: "
                                        "zamba2-2.7b's bf16 prefill takes sm90",
                         "rerouted_launches": rerouted,
                         **build_info.get(tf32_instance(torch.bfloat16, 80), {})},
                     **{tf32_instance(torch.bfloat16, D): {
                         **f32_numbers(r, "tf32"), "launches": 0,
                         "launched_by": f"phase 3 only: bf16 at D {D} takes sm90",
                         **build_info.get(tf32_instance(torch.bfloat16, D), {})}
                        for D, r in bf16_pairs.items()},
                     tf32_instance(torch.float32, 256): {
                         **f32_numbers(f32_256, "tf32"), "launches": 0,
                         "launched_by": "phase 3 only: float32 at D 256 takes sm90_tf32",
                         **build_info.get(tf32_instance(torch.float32, 256), {})},
                     **{name: {**{k: r[k] for k in keys}, "max_abs_err": r["max_abs_err"],
                               "library_backend": r["library_backend"], "launches": 0,
                               "launched_by": "phase 3 only: no path gives this head dim",
                               **build_info.get(name, {})}
                        for name, r in tf32_only.items()}},
                 "err": max(worst.get("float32 tf32", 0.0), worst.get("bfloat16 tf32", 0.0),
                            timed["tf32_zamba2"]["max_abs_err"],
                            *(r["tf32"]["max_abs_err"] for r in f32.values()),
                            *(r["tf32"]["max_abs_err"] for r in bf16_pairs.values()),
                            f32_256["tf32"]["max_abs_err"],
                            *(r["max_abs_err"] for r in tf32_only.values()))},
    }
    for route, row in rows.items():
        extra = {k: row[k] for k in ("instances", "long_prompt", "rerouted_launches",
                                     "rerouted_by") if k in row}
        extra.update((k, row["main"][k]) for k in ("passes_bound_ms", "library_backend")
                     if k in row["main"])
        kernels.append({
            **{k: FLASH[route][k] for k in ("name", "source")}, "route": "cuda",
            "replaces": FLASH_REPLACES, "flash_route": route,
            "launches": row["launches"], "launched_by": row["launched_by"], "matched": True,
            "max_abs_err": row["err"], **{k: row["main"][k] for k in keys},
            # the contract's two names: products and exponentials are operations
            "bound_by": "bytes" if row["main"]["bound_by"] == "bytes" else "operations",
            "library": FLASH_LIBRARY, **extra,
            **build_info.get(row["instance"], {}), "card": smi,
        })
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"hub_server": hub}))
    print(json.dumps({"families": families}))
    print(json.dumps({"train": train}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"mesh_families": mesh_families}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [LATER_FLAG]:
        sys.exit(later_phases_main(*sys.argv[2:]))
    sys.exit(main())
