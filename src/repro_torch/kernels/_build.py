"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` into one shared library with a plain C
interface and loaded with :mod:`ctypes` (no PyTorch headers, so the build takes
seconds). Each source compiles in its own ``nvcc`` process, all started
together, and one more links them. The build runs at first use, when the first CUDA tensor reaches a
wrapper, never at import: this module imports on a machine without ``nvcc`` or
a card. The library lands in ``build/repro_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. A failed build raises; nothing falls back to the plain
PyTorch versions.

Launch counts live here too: each wrapper calls :func:`launch` (the storage
kernels' ``(*tensors, n, nb)`` convention) or :func:`launch_args` (any other
launcher, such as flash attention's), which count one launch per kernel call
that actually reached the card. The three routes of flash attention
(``zllm_flash_attention_sm90``, ``zllm_flash_attention_sm90_tf32``,
``zllm_flash_attention_tf32``) share one C signature and count under
``"flash_attention"``, which names no launcher of its own.

``nvcc`` runs with ``-Xptxas -v``; :func:`build_log` keeps what each source's
compile printed (registers, shared memory and spills of every kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["BUILD_DIR", "KERNELS", "SOURCES", "HEADERS", "NVCC_FLAGS", "library", "library_path",
           "build_seconds", "build_log", "check_bytes", "check_pair", "grid", "launch",
           "launch_args", "launch_counts", "reset_launch_counts"]

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "planes.cu", _PKG / "csrc" / "flash_attention_sm90.cu",
           _PKG / "csrc" / "flash_attention_sm90_tf32.cu", _PKG / "csrc" / "flash_attention_tf32.cu")
HEADERS = (_PKG / "csrc" / "sm90_common.cuh",)  # included by the sources: part of the library's hash
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the launchers in csrc/planes.cu: pointers (inputs, then
# outputs), then the word count n (int64), the word width nb (int) and the
# stream; each returns a cudaError_t as int
_P, _N, _NB = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "xor_split": (_P, _P, _P, _N, _NB, _P),
    "merge_xor": (_P, _P, _P, _N, _NB, _P),
    "split": (_P, _P, _N, _NB, _P),
    "merge": (_P, _P, _N, _NB, _P),
    "xor": (_P, _P, _P, _N, _NB, _P),
    "hamming": (_P, _P, _P, _N, _NB, _P),  # out: grid(n) 64-bit partials
    # flash attention's routes: q, k, v, o; B, Sq, Sk, H, D; the B/S/H element
    # strides of q, k, v and o; causal, window, dtype code; the stream
    "flash_attention": (_P,) * 4 + (_N,) * 5 + (_N,) * 12 + (_NB,) * 3 + (_P,),
}
# launchers that are a route of a kernel above: its signature, counted under
# its name (csrc/flash_attention_sm90.cu, flash_attention_sm90_tf32.cu,
# flash_attention_tf32.cu); a kernel they count under has no launcher of its own
_COUNTED_AS = {"flash_attention_sm90": "flash_attention", "flash_attention_sm90_tf32": "flash_attention",
               "flash_attention_tf32": "flash_attention"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None
_build_log: Dict[str, str] = {}
KERNELS = tuple(_SIGNATURES)
_launches: Dict[str, int] = {k: 0 for k in KERNELS}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels of repro_torch cannot be built")
    return path


def library_path() -> Path:
    """Where the library built from the present sources and flags lives."""
    h = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libzllm_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list:
    """Run the commands as concurrent processes; raise on the first failure.
    Returns what each printed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed, outs = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{src.stem}.{out.stem}.{tag}.o") for src in SOURCES]
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    try:
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(SOURCES, objs)])
        _build_log.update((src.name, out) for src, out in zip(SOURCES, outs))
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            launchers = {k: sig for k, sig in _SIGNATURES.items() if k not in _COUNTED_AS.values()}
            launchers.update((k, _SIGNATURES[kernel]) for k, kernel in _COUNTED_AS.items())
            for kernel, argtypes in launchers.items():
                fn = getattr(lib, f"zllm_{kernel}")
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.zllm_error_string.argtypes = [ctypes.c_int]
            lib.zllm_error_string.restype = ctypes.c_char_p
            lib.zllm_grid.argtypes = [ctypes.c_int64]
            lib.zllm_grid.restype = ctypes.c_int64
            _build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`library` call took (compile + load), or None."""
    return _build_seconds


def build_log() -> Dict[str, str]:
    """What ``nvcc -Xptxas -v`` printed per source file name, if this process
    compiled the library (empty when it loaded a built one)."""
    return dict(_build_log)


def check_bytes(t: torch.Tensor, nb: int, what: str) -> int:
    """Validate a kernel operand: a contiguous uint8 tensor on the CPU or a
    CUDA device holding whole ``nb``-byte words (on CUDA, aligned to ``nb``).
    Returns the word count."""
    if nb not in (1, 2, 4, 8):
        raise ValueError(f"word width must be 1, 2, 4 or 8 bytes, got {nb}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{what} must be a uint8 byte buffer, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} lies on {t.device}; expected cpu or cuda")
    if t.numel() % nb:
        raise ValueError(f"{what} holds {t.numel()} bytes, not whole {nb}-byte words")
    if t.device.type == "cuda" and t.data_ptr() % nb:
        raise ValueError(f"{what} is not aligned to its {nb}-byte words")
    return t.numel() // nb


def check_pair(a: torch.Tensor, b: torch.Tensor, nb: int, names=("a", "b")) -> int:
    """:func:`check_bytes` for two operands that must hold the same number of
    words on one device. Returns the word count."""
    n = check_bytes(a, nb, names[0])
    if check_bytes(b, nb, names[1]) != n or b.device != a.device:
        raise ValueError(f"{names[0]} and {names[1]} must hold the same words on one device")
    return n


def grid(n: int) -> int:
    """Blocks every launcher uses for ``n`` words (0 for ``n == 0``): the
    length of the hamming kernel's partials."""
    return library().zllm_grid(n)


def launch(kernel: str, *tensors: torch.Tensor, n: int, nb: int) -> None:
    """Launch a storage kernel (C function ``zllm_<kernel>``) on ``tensors``'
    device pointers (inputs first, then outputs), the word count and width and
    the current stream. ``n == 0`` must not reach here."""
    launch_args(kernel, tensors[0].device, *[t.data_ptr() for t in tensors], n, nb)


def launch_args(kernel: str, device: torch.device, *args) -> None:
    """Call the launcher ``zllm_<kernel>`` with ``args`` and then the current
    stream of ``device``; raise on a non-zero ``cudaError_t``. Counts one
    launch (a second route under its kernel's name)."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"zllm_{kernel}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err} "
                           f"({lib.zllm_error_string(err).decode()})")
    with _lock:
        _launches[_COUNTED_AS.get(kernel, kernel)] += 1


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel name since the last reset."""
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for name in _launches:
            _launches[name] = 0
