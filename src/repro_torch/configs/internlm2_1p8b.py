"""internlm2-1.8b — dense GQA transformer.

[arXiv:2403.17297; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    source="[arXiv:2403.17297; hf]",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    remat="block",
)
