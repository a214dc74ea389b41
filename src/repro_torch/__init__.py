"""PyTorch/CUDA port of the ALMA decide plane (``repro``'s counterpart).

``repro_torch`` mirrors ``repro`` module for module. It imports torch,
numpy and the standard library only, never JAX and never ``repro``.
"""
