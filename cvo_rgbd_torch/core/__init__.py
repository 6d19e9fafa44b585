"""Port of the JAX package's core: clouds, numerics, epilogues and the align loop."""
