"""PyTorch/CUDA port of the zLLM storage system (``repro``'s counterpart).

The port keeps the reference package's module paths and names
(``repro_torch.core.pipeline.ZLLMStore`` mirrors ``repro.core.pipeline``), imports
``torch``, numpy and the standard library only, and runs its array math on the
hand-written Hopper kernels in :mod:`repro_torch.kernels`.
"""
