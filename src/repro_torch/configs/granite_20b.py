# Port copy of src/repro/configs/granite_20b.py: data only, logic unchanged.
"""granite-20b — dense code model, llama-arch with MQA: 52L d_model=6144
48H (GQA kv=1) d_ff=24576 vocab=49152. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    rope_theta=1e4,
    supports_long=False, long_skip_reason="full attention, quadratic in seq",
    source="[arXiv:2405.04324; hf]",
)

SMOKE = ArchConfig(
    name="granite-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab=256, rope_theta=1e4,
    supports_long=False,
)
