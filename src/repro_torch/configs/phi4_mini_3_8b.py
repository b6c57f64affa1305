# Port copy of src/repro/configs/phi4_mini_3_8b.py: data only, logic unchanged.
"""phi4-mini-3.8b — dense: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE (partial rotary) SwiGLU GQA. [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    rope_theta=1e4, rope_pct=0.75, tie_embeddings=True,
    supports_long=False, long_skip_reason="full attention, quadratic in seq",
    source="[arXiv:2412.08905; hf]",
)

SMOKE = ArchConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, rope_theta=1e4, rope_pct=0.75, tie_embeddings=True,
    supports_long=False,
)
