"""The LM substrate on torch: dense blocks, the Mamba2 and RWKV6 layers on
the chunked scan (``gla``), the model in its uniform and hybrid wirings,
and weight conversion from the JAX package."""
