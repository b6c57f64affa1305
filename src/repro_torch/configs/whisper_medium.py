# Port copy of src/repro/configs/whisper_medium.py: data only, logic unchanged.
"""whisper-medium — encoder-decoder audio backbone: 24+24L d_model=1024
16H (MHA kv=16) d_ff=4096 vocab=51865, conv frontend STUBBED (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    norm="layernorm", tie_embeddings=True,
    supports_long=False, long_skip_reason="full attention, quadratic in seq",
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ArchConfig(
    name="whisper-medium-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, norm="layernorm", tie_embeddings=True,
    supports_long=False,
)
