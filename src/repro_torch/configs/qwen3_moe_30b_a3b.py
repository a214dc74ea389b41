"""qwen3-moe-30b-a3b — 128-expert top-8 MoE, every layer.

[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, qk_norm, head_dim=128. ~30B total / ~3B active.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_head=128,
    d_ff=6144,                       # unused: every layer is MoE
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                  capacity_factor=1.25),
    remat="block",
    accum_steps=1,
)
