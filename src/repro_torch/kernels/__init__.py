"""Hand-written Hopper kernels of the port (counterpart of
``src/repro/kernels/``).

Storage-path kernels, CUDA C++ for ``sm_90a`` in ``csrc/planes.cu``:
  bitx_xor.py     — fused XOR + byte-plane split / merge (BitX encode/decode)
                    and the plain word XOR (``xor``)
  byte_planes.py  — ZipNN byte-plane shuffle (the no-family fallback)
  hamming.py      — XOR + popcount + per-block sum: the bit distance (paper Eq. 1)

Model-path kernel, CUDA C++ for ``sm_90a`` in three routes,
``csrc/flash_attention_sm90.cu`` (wgmma, bf16 at head dims 64, 80, 128 and
256), ``csrc/flash_attention_sm90_tf32.cu`` (wgmma on TF32, float32 at 64, 80
and 128) and ``csrc/flash_attention_tf32.cu`` (mma.sync, every other call):
  flash_attention.py — causal / sliding-window / bidirectional attention
                       forward with an online softmax (every family's prefill)

Each pairs with a plain PyTorch version in ``ref.py``, which runs for CPU
tensors; ``ops.py`` is the typed public API of the storage ops (the four plane
ops, ``hamming_total`` and ``bit_distance``); ``_build.py`` compiles the CUDA
sources with ``nvcc`` at first use, loads them with ``ctypes`` and counts
launches. The store reaches the plane kernels through
:class:`repro_torch.core.bitx.TorchBackend`; the Monte-Carlo calibration in
:mod:`repro_torch.core.bitdistance` reaches the hamming kernel through
``ops.bit_distance``; :class:`repro_torch.models.transformer.TransformerLM`
reaches the flash kernel in ``loss`` and ``prefill``.
"""
