"""Hand-written Hopper kernels of the storage path (counterpart of
``src/repro/kernels/``).

Storage-path kernels, CUDA C++ for ``sm_90a`` in ``csrc/planes.cu``:
  bitx_xor.py     — fused XOR + byte-plane split / merge (BitX encode/decode)
                    and the plain word XOR (``xor``)
  byte_planes.py  — ZipNN byte-plane shuffle (the no-family fallback)
  hamming.py      — XOR + popcount + per-block sum: the bit distance (paper Eq. 1)

Each pairs with a plain PyTorch version in ``ref.py``, which runs for CPU
tensors; ``ops.py`` is the typed public API (the four plane ops,
``hamming_total`` and ``bit_distance``); ``_build.py`` compiles the CUDA source
with ``nvcc`` at first use, loads it with ``ctypes`` and counts launches.
The store reaches the plane kernels through
:class:`repro_torch.core.bitx.TorchBackend`; the Monte-Carlo calibration in
:mod:`repro_torch.core.bitdistance` reaches the hamming kernel through
``ops.bit_distance``.
"""
