# Port copy of src/repro/configs/deepseek_coder_33b.py: data only, logic unchanged.
"""deepseek-coder-33b — dense llama-arch: 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256. [arXiv:2401.14196; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256,
    rope_theta=1e5,
    supports_long=False, long_skip_reason="full attention, quadratic in seq",
    source="[arXiv:2401.14196; hf]",
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, rope_theta=1e5,
    supports_long=False,
)
