"""qwen2-vl-2b — VLM backbone with M-RoPE (3-axis rotary over t/h/w).

[arXiv:2409.12191; hf]  28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936. The ViT frontend is a stub: ``input_specs()`` supplies 1024
precomputed patch embeddings as a prefix plus 3-axis M-RoPE position ids.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="[arXiv:2409.12191; hf]",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend_prefix=1024,
    rope_theta=1e6,
    remat="block",
)
