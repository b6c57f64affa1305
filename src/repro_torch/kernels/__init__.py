"""Hand-written Hopper kernels of the storage path (counterpart of
``src/repro/kernels/``).

Storage-path kernels, CUDA C++ for ``sm_90a`` in ``csrc/planes.cu``:
  bitx_xor.py     — fused XOR + byte-plane split / merge (BitX encode/decode)
  byte_planes.py  — ZipNN byte-plane shuffle (the no-family fallback)

Each pairs with a plain PyTorch version in ``ref.py``, which runs for CPU
tensors; ``ops.py`` is the typed public API; ``_build.py`` compiles the CUDA
source with ``nvcc`` at first use, loads it with ``ctypes`` and counts launches.
The store reaches the kernels through :class:`repro_torch.core.bitx.TorchBackend`.
"""
