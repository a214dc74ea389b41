"""starcoder2-7b — dense GQA code model.

[arXiv:2402.19173; hf]  32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    source="[arXiv:2402.19173; hf]",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    gated_mlp=False,       # GPT-style 2-matrix MLP (gelu), per the paper
    rope_theta=1e5,
    remat="block",
)
