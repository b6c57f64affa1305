# Port copy of src/repro/configs/falcon_mamba_7b.py: data only, logic unchanged.
"""falcon-mamba-7b — attention-free Mamba-1: 64L d_model=4096 vocab=65024,
ssm_state=16, d_inner=2*d_model, parameter-free RMS norm on dt/B/C streams.
[arXiv:2410.05355; unverified]

O(1) recurrent decode state: runs the long_500k cell."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm=SSMConfig(version=1, d_state=16, d_conv=4, expand=2, chunk=128),
    supports_long=True,
    source="[arXiv:2410.05355; unverified]",
)

SMOKE = ArchConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=256,
    ssm=SSMConfig(version=1, d_state=4, d_conv=4, expand=2, chunk=8),
    supports_long=True,
)
