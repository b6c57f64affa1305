# Port copy of src/repro/configs/zamba2_2_7b.py: data only, logic unchanged.
"""zamba2-2.7b — hybrid: 54 Mamba-2 layers d_model=2560 + ONE shared
transformer block (32H GQA kv=32 d_ff=10240) invoked every 6 layers,
ssm_state=64, vocab=32000. [arXiv:2411.15242; hf]

Sub-quadratic (SSM backbone): runs the long_500k cell; the shared-attention
caches are sequence-sharded."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    rope_theta=1e4,
    ssm=SSMConfig(version=2, d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    attn_every=6,
    supports_long=True,
    source="[arXiv:2411.15242; hf]",
)

SMOKE = ArchConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, rope_theta=1e4,
    ssm=SSMConfig(version=2, d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8),
    attn_every=2,
    supports_long=True,
)
