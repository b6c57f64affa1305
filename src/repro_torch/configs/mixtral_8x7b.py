# Port copy of src/repro/configs/mixtral_8x7b.py: data only, logic unchanged.
"""mixtral-8x7b — MoE: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
8 experts top-2, sliding-window attention (W=4096). [arXiv:2401.04088; hf]

SWA makes decode memory O(W): the long_500k cell runs with a rolling
window cache."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    swa_window=4096,
    supports_long=True,
    source="[arXiv:2401.04088; hf]",
)

SMOKE = ArchConfig(
    name="mixtral-8x7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, rope_theta=1e6,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0),
    swa_window=16,
    supports_long=True,
)
