"""musicgen-medium — decoder-only LM over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (GQA kv=24 == MHA) d_ff=6144
vocab=2048. The EnCodec/conditioning frontend is a stub: ``input_specs()``
supplies 256 precomputed conditioning-frame embeddings as a prefix.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="[arXiv:2306.05284; hf]",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=("attn",),
    frontend_prefix=256,
    rope_theta=1e4,
    remat="block",
    accum_steps=1,
)
