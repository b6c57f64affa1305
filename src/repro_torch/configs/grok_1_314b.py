# Port copy of src/repro/configs/grok_1_314b.py: data only, logic unchanged.
"""grok-1-314b — MoE: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
8 experts top-2. [hf:xai-org/grok-1; unverified]

Uses Adafactor (factored second moment): 314B params x Adam fp32 moments do
not fit the per-device HBM budget at 256 chips."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    rope_theta=1e4,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    optimizer="adafactor", fsdp_over_pod=True,
    supports_long=False, long_skip_reason="full attention, quadratic in seq",
    source="[hf:xai-org/grok-1; unverified]",
)

SMOKE = ArchConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, rope_theta=1e4,
    moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0),
    optimizer="adafactor",
    supports_long=False,
)
