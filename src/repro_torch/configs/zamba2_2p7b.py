"""zamba2-2.7b — Mamba2 backbone with shared attention blocks.

[arXiv:2411.15242; hf]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64. Wiring: five Mamba2 blocks then one
*shared-weight* attention block, repeated (the zamba2 shared-block scheme).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  conv_width=4),
    remat="block",
)
