"""h2o-danube-3-4b — llama/mistral-mix dense transformer with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, SWA window 4096. The SWA ring buffer makes 500k-token decode
sub-quadratic (O(window) KV state), so this arch runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    source="[arXiv:2401.16818; unverified]",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_head=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
    remat="block",
)
