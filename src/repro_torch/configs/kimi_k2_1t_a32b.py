"""kimi-k2-1t-a32b — trillion-parameter 384-expert top-8 MoE (paper-table).

[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8) expert
d_ff=2048 vocab=163840, MoE 384e top-8 + 1 shared expert, first layer dense.
The widths match hf:moonshotai/Kimi-K2-Instruct (config.json); its attention
is MLA, for which GQA at d_head 112 (7168 / 64) stands in here.
~1.03T total / ~32B active. Trained with Adafactor + bf16 state and
sequence-sharded activations so the 512-chip dry-run fits HBM (see
EXPERIMENTS.md §Dry-run).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="[arXiv:2501.kimi2; unverified]",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_head=112,
    d_ff=18432,                      # the single leading dense layer
    vocab_size=163840,
    rope_theta=5e4,
    block_pattern=("moe",),
    first_k_dense=1,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25, num_shared_experts=1),
    optimizer="adafactor",
    remat="full",
    accum_steps=1,        # batch shards 32-way; accum would cost an f32
                          # grad buffer (4TB/256 ~= 16 GiB/chip) for nothing
    seq_shard=True,
)
