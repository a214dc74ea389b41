"""Dense LM blocks and the model (uniform attention wiring), plus weight
conversion from the JAX package."""
