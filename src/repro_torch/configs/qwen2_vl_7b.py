# Port copy of src/repro/configs/qwen2_vl_7b.py: data only, logic unchanged.
"""qwen2-vl-7b — VLM backbone: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE, dynamic resolution (patch frontend stubbed).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1e6, mrope=True,
    supports_long=False,
    long_skip_reason="full attention (M-RoPE), quadratic in seq",
    source="[arXiv:2409.12191; hf]",
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    qkv_bias=True, rope_theta=1e6, mrope=True,
    supports_long=False,
)
