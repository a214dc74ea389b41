"""rwkv6-1.6b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
Head dim 64 -> 32 heads; decay is data-dependent through a rank-64 LoRA.
O(1) decode state makes long_500k natural for this arch.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="[arXiv:2404.05892; unverified]",
    num_layers=24,
    d_model=2048,
    num_heads=32,           # wkv heads (d_model / head_dim)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora=64),
    remat="block",
)
