"""qwen3-8b — dense GQA transformer with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B; hf]  36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm, head_dim=128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B; hf]",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_head=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    remat="block",
)
